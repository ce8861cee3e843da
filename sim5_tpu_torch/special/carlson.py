"""Carlson's symmetric elliptic integral RF.

Port of `sim5_tpu/special/carlson.py` (`rf` and its series tail; RD, RC
and RJ wait for the slices that need them).  The duplication runs to a
fixed depth chosen by dtype, so a batch evaluates in lockstep: 16 levels
bring any f64 argument triple to spread < 3e-4, where the 5th-order tail
is exact to f64 epsilon; 7 levels reach the f32 noise floor.
(reference: sim5elliptic.c:19-52)

Forward only: the analytic derivative rules wait for the derivative layer.
"""

import torch

from ..core.metric import _as_tensors

_NDUP = 16        # f64 duplication depth
_NDUP_F32 = 7     # f32 duplication depth
_TINY = 1e-300    # zero floor in f64
_TINY_F32 = 1e-37


def _ndup(dtype):
    """Duplication depth for the working precision."""
    return _NDUP if dtype == torch.float64 else _NDUP_F32


def _tiny_for(dtype):
    """Zero floor of the arguments: 1e-300 in f64, 1e-37 in f32."""
    return _TINY if dtype == torch.float64 else _TINY_F32


def _rf_tail(xt, yt, zt):
    """5th-order RF series tail at the converged triple."""
    ave = (xt + yt + zt) / 3.0
    dx = (ave - xt) / ave
    dy = (ave - yt) / ave
    dz = (ave - zt) / ave
    e2 = dx * dy - dz * dz
    e3 = dx * dy * dz
    C1, C2, C3, C4 = 1.0 / 24.0, 0.1, 3.0 / 44.0, 1.0 / 14.0
    return (1.0 + (C1 * e2 - C2 - C3 * e3) * e2 + C4 * e3) / torch.sqrt(ave)


def rf(x, y, z):
    """Carlson RF(x,y,z) = 1/2 int_0^inf dt/sqrt((t+x)(t+y)(t+z)).

    x,y,z >= 0, at most one zero.  Broadcasts; dtype and device follow the
    inputs.  (reference: sim5elliptic.c:19-52)
    """
    xt, yt, zt = _as_tensors(x, y, z)
    # floor exactly-zero arguments at the zero floor (e.g. every complete
    # integral RF(0, y, 1))
    tiny = _tiny_for(xt.dtype)
    xt = torch.clamp(xt, min=tiny)
    yt = torch.clamp(yt, min=tiny)
    for _ in range(_ndup(xt.dtype)):
        sx, sy, sz = torch.sqrt(xt), torch.sqrt(yt), torch.sqrt(zt)
        lam = sx * (sy + sz) + sy * sz
        xt, yt, zt = 0.25 * (xt + lam), 0.25 * (yt + lam), 0.25 * (zt + lam)
    return _rf_tail(xt, yt, zt)
