"""Scalar root finding by fixed-depth bisection.

Port of `sim5_tpu/special/roots.py` (`rtbis`; the implicitly
differentiated solve waits for the derivative layer).  A static number of
halvings replaces the reference's tolerance loop (sim5roots.c:21-64):
60 halvings of [lo, hi] reach ~1e-18 relative width.
"""

import torch


def rtbis(f, lo, hi, n_iter=60):
    """Root of f on [lo, hi] (f(lo), f(hi) must bracket).  Batched over
    the broadcast shape of (lo, hi) and f's output; f64, on lo's device
    (the CPU for a Python number)."""
    lo = torch.as_tensor(lo, dtype=torch.float64)
    hi = torch.as_tensor(hi, dtype=torch.float64, device=lo.device)
    lo, hi = torch.broadcast_tensors(lo, hi)
    # orient so that f(lo_oriented) < 0
    swap = f(lo) > 0.0
    lo_, hi_ = torch.where(swap, hi, lo), torch.where(swap, lo, hi)
    for _ in range(n_iter):
        mid = 0.5 * (lo_ + hi_)
        below = f(mid) < 0.0
        lo_, hi_ = torch.where(below, mid, lo_), torch.where(below, hi_, mid)
    return 0.5 * (lo_ + hi_)
