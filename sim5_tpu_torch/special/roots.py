"""Scalar root finding by fixed-depth bisection, with an implicitly
differentiated solve.

Port of `sim5_tpu/special/roots.py`.  A static number of halvings
replaces the reference's tolerance loop (sim5roots.c:21-64): 60 halvings
of [lo, hi] reach ~1e-18 relative width.  `rtbis_implicit` differentiates
the root by the implicit-function rule, as `lax.custom_root` does there,
instead of through the bisection.
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


def rtbis_implicit(f_param, param, lo, hi, n_iter=60):
    """Differentiable root solve: x(param) with f_param(param, x) = 0.

    The value is the bisection's (`rtbis` on the detached objective); its
    derivative follows the implicit-function theorem, dx/dparam =
    -f_p / f_x at the root, in reverse and forward mode, instead of
    differentiating the bisection.  `param` is a tensor or a tuple of
    tensors, as `f_param` takes it; f is elementwise in x.
    """
    params = param if isinstance(param, (tuple, list)) else (param,)
    fixed = tuple(p.detach() if isinstance(p, torch.Tensor) else p
                  for p in params)
    fixed = fixed if isinstance(param, (tuple, list)) else fixed[0]
    with torch.no_grad():
        x = rtbis(lambda v: f_param(fixed, v), lo, hi, n_iter)
    # f_x at the root, a constant of the rule
    with torch.enable_grad():
        xr = x.detach().requires_grad_(True)
        fx, = torch.autograd.grad(f_param(fixed, xr).sum(), xr)
    # x + (c - c.detach()) is x's value exactly, with c's derivative
    # -f_p / f_x
    c = -f_param(param, x) / fx
    return x + (c - c.detach())
