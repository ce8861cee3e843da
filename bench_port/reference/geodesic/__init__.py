"""Analytic geodesic engine.

Port of `sim5_tpu/geodesic`: initialisation at infinity and from a
point, the position integral and its radial and poloidal inversions, the
momentum at P, the equatorial-plane crossing, the capture predicate, the
azimuth, the travel time and the affine-step follower.
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
    geodesic_init_inf, geodesic_init_src, geodesic_P_int, geodesic_position_rad,
    geodesic_position_pol, geodesic_dm_sign,
    geodesic_position_pol_sign_k_theta, geodesic_momentum,
    geodesic_find_midplane_crossing, geodesic_is_captured,
    geodesic_position_azm,
    geodesic_timedelay, geodesic_timedelay_full,
    geodesic_follow, FOLLOW_STOPPED, FOLLOW_OK, FOLLOW_NOT_CONVERGED,
)
