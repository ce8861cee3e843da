"""Special functions: polynomial roots, Carlson RF, the complete elliptic
integral and the Jacobi elliptic functions.

Port of `sim5_tpu/special` (the part the analytic seed needs).  Every
function broadcasts and keeps its inputs' dtype and device; the fixed
iteration depths are chosen by dtype (f64 or f32), not by a global switch.
"""

from .polyroots import (quadratic_roots, cubic_roots, quartic_roots,
                        sort_quartic_roots, polish_quartic_real_roots_df)
from .carlson import rf
from .legendre import elliptic_k_mc
from .jacobi import jacobi_sncndn
