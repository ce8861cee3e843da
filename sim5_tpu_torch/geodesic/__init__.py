"""Analytic geodesic engine: the part that seeds the volume march.

Port of `sim5_tpu/geodesic` (initialisation at infinity, the position
integral and its radial and poloidal inversions, the momentum at P).
"""

from .types import (
    Geodesic,
    GEOD_TYPE_RR, GEOD_TYPE_RR_DBL, GEOD_TYPE_RR_BH, GEOD_TYPE_RC, GEOD_TYPE_CC,
    GD_OK, GD_ERROR_Q_ZERO, GD_ERROR_BOUND_GEODESIC, GD_ERROR_UNKNOWN_SOLUTION,
    GD_ERROR_TYPE_RR_DOUBLE, GD_ERROR_TYPE_CC, GD_ERROR_Q_RANGE,
    GD_ERROR_MUPLUS_RANGE, GD_ERROR_MU0_RANGE, GD_ERROR_MM_RANGE,
    GD_ERROR_INCL_RANGE, GD_ERROR_SPIN_RANGE,
)
from .analytic import (
    geodesic_init_inf, geodesic_P_int, geodesic_position_rad,
    geodesic_position_pol, geodesic_dm_sign, geodesic_momentum,
)
