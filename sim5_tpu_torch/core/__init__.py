"""Spacetime core: metric, connection, tetrads, orbits, photon kinematics.

Port of `sim5_tpu/core` (the part the stepwise march, the analytic seed and
the disk image need).
"""

from .metric import (
    Metric,
    flat_metric, kerr_metric,
    kerr_transport_accel, flat_transport_accel,
    vector_covariant, dotprod,
)
from .tetrads import Tetrad, tetrad_zamo, bl2on, on2bl
from .orbits import (r_bh, r_ms, r_mb, r_ph, OmegaK, ellK, omega_r, omega_z,
                     Omega_from_ell, ell_from_Omega, gfactorK, keplerian_EL)
from .photon import (photon_carter_const, photon_momentum,
                     photon_motion_constants)
