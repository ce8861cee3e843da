"""Legendre elliptic integrals.

Port of `sim5_tpu/special/legendre.py` (the complete integral from its
complement, which the analytic seed uses; the incomplete F, E, Pi wait
for the slices that need them).  (reference: sim5elliptic.c:217-474;
conventions m = k^2 as in Byrd & Friedman)
"""

import math

import torch

from ..core.metric import _as_tensors


def elliptic_k_mc(mc):
    """Complete elliptic integral K(m) from the COMPLEMENT mc = 1 - m, by
    the arithmetic-geometric mean:  K = pi / (2 AGM(1, sqrt(mc))).

    The fixed depths (9 in f64, 7 in f32) reach the working precision's
    noise floor for any mc >= 1e-12; dtype and device follow the input.
    """
    mc, = _as_tensors(mc)
    depth = 9 if mc.dtype == torch.float64 else 7
    a = torch.ones_like(mc)
    b = torch.sqrt(torch.clamp(mc, min=1e-30))
    for _ in range(depth):
        a, b = 0.5 * (a + b), torch.sqrt(a * b)
    return math.pi / (a + b)   # = pi / (2 * agm)
