"""Spacetime core: metric, connection, tetrads, orbits, photon kinematics.

Port of `sim5_tpu/core` (the part the stepwise march needs).
"""

from .metric import (
    Metric,
    flat_metric, kerr_metric,
    kerr_transport_accel, flat_transport_accel,
    vector_covariant, dotprod,
)
from .tetrads import Tetrad, tetrad_zamo, bl2on, on2bl
from .orbits import r_bh
from .photon import photon_carter_const
