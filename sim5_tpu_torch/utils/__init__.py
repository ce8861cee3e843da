"""Numerical utilities: error-free transforms, accurate transcendentals,
the small math helpers of sim5math.c, option parsing, structured run
logging, the FITS subset (`utils.fitsio`) and the host boundary of the
tables and checkpoints (`utils.host`)."""

from .fastmath import (two_sum, two_prod, sqrt_df, vlog, log_accurate,
                       exp_accurate, expm1_accurate)
from .math import (
    sqr, sqr3, sqr4, sign, deg2rad, rad2deg,
    reduce_angle_pi, reduce_angle_2pi, ensure_range,
    cartesian_to_spherical, spherical_to_cartesian, sim5round,
    cartesian_vector_to_spherical, cartesian_vector_to_spherical_at,
)
from .options import key_value_get
from .log import get_logger, log_run
