"""Spacetime core: metric, connection, orbits, photon kinematics.

Port of `sim5_tpu/core`: batched equivalents of sim5kerr.c on tensors
(the copy leaves out the tetrads, which no reference chain calls).
"""

from .metric import (
    Metric,
    flat_metric, flat_metric_contravariant,
    kerr_metric, kerr_metric_contravariant,
    kerr_newman_metric, kerr_newman_metric_contravariant,
    flat_connection, kerr_connection, kerr_newman_connection,
    Gamma, geodesic_accel, kerr_transport_accel, flat_transport_accel,
    vector, vector_covariant, dotprod, vector_norm, vector_3norm,
    vector_norm_to, vector_norm_to_null,
)
from .orbits import (r_bh, r_ms, r_mb, r_ph, OmegaK, ellK, omega_r, omega_z,
                     Omega_from_ell, ell_from_Omega, gfactorK, keplerian_EL)
from .photon import (
    photon_momentum, photon_momentum_checked,
    photon_motion_constants, photon_carter_const,
    fourvelocity_zamo, fourvelocity_azimuthal, fourvelocity_radial,
    fourvelocity,
)
