"""Numerical utilities: error-free transforms and accurate logs."""

from .fastmath import two_sum, two_prod, sqrt_df, vlog, log_accurate
