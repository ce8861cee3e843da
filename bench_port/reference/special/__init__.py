"""Special functions: polynomial roots, the Carlson symmetric elliptic
integrals, the Legendre forms, the Jacobi elliptic functions and their
inverses, and the Byrd & Friedman tabulated integrals.

Port of `sim5_tpu/special`, with its quadrature rules (the copy leaves
out the interpolation tables, tabulated distributions and root finder,
which no reference chain calls).  Every function broadcasts and keeps
its inputs' dtype and device; the fixed iteration depths are chosen by
dtype (f64 or f32), not by a global switch.  The JAX package's
`set_duplication_mode` has no counterpart: precision follows the dtype.
"""

from .polyroots import (quadratic_roots, cubic_roots, quartic_roots,
                        quartic_roots_c, sort_quartic_roots,
                        polish_quartic_real_roots,
                        polish_quartic_real_roots_df)
from .carlson import rf, rd, rc, rj
from .legendre import (
    elliptic_k, elliptic_k_mc, elliptic_f, elliptic_f_cos, elliptic_f_sin,
    elliptic_e, elliptic_e_cos, elliptic_e_sin,
    elliptic_pi_complete, elliptic_pi_cos, elliptic_pi_sin,
)
from .jacobi import (
    jacobi_sncndn, jacobi_sn, jacobi_cn, jacobi_dn,
    jacobi_isn, jacobi_icn, jacobi_itn, icn_signed,
)
from .integrals import (
    integral_C0, integral_C1, integral_C2, integral_C2_cos,
    integral_Z1, integral_Z2,
    integral_Rm1, integral_Rm2, integral_R0, integral_R1, integral_R2,
    integral_R_r0_re, integral_R_r0_re_inf, integral_R_r0_cc,
    integral_R_r0_cc_inf, integral_R_r1_re, integral_R_r1_cc,
    integral_R_r2_re, integral_R_r2_cc,
    integral_R_rp_re, integral_R_rp_re_inf, integral_R_rp_cc2,
    integral_R_rp_cc2_inf,
    integral_R_r0_bh, integral_R_r1_bh, integral_R_r2_bh, integral_R_rp_bh,
    integral_T_m0, integral_T_m2, integral_T_mp,
    integral_T_m0_dn, integral_T_m2_dn, integral_T_mp_dn,
)
from .quadrature import integrate_trapezoid, integrate_simpson, gauleg, qgaus
