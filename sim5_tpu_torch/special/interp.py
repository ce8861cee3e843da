"""Tabulated-function interpolation (linear, log-linear, cubic spline).

Port of `sim5_tpu/special/interp.py`, the batched equivalent of the
reference's sim5interp object (sim5interpolation.c).  A table is built
once on the host (the spline's tridiagonal sweep runs there in f64) and
put on a device chosen by the caller, the card by default; evaluation is
one `torch.searchsorted` and a polynomial blend over the whole query
batch, in f64 on the table's device.
"""

from typing import NamedTuple

import numpy as np
import torch

from ..core.metric import default_device

# data/type options mirroring the reference flags (sim5interpolation.h:23-37)
INTERP_TYPE_LINLIN = 0   # linear in x, linear in y
INTERP_TYPE_LOGLOG = 1   # log in x, log in y
INTERP_TYPE_LOGLIN = 2   # log in x, linear in y
INTERP_TYPE_SPLINE = 3   # natural cubic spline
INTERP_OPT_ALLOW_EXTRAPOLATION = 1


class Interp(NamedTuple):
    """Immutable interpolation table: f64 tensors on one device."""
    x: torch.Tensor
    y: torch.Tensor
    y2: torch.Tensor         # spline second derivatives (zeros otherwise)
    itype: int
    options: int

    def __call__(self, xq):
        return interp_eval(self, xq)


def _spline_second_derivs(x, y):
    """Natural cubic-spline second derivatives (NR `spline`,
    sim5interpolation.c:75-119), solved on the host with the standard
    tridiagonal sweep."""
    x = np.asarray(x, np.float64)
    y = np.asarray(y, np.float64)
    n = len(x)
    y2 = np.zeros(n)
    u = np.zeros(n)
    for i in range(1, n - 1):
        sig = (x[i] - x[i - 1]) / (x[i + 1] - x[i - 1])
        p = sig * y2[i - 1] + 2.0
        y2[i] = (sig - 1.0) / p
        u[i] = ((y[i + 1] - y[i]) / (x[i + 1] - x[i])
                - (y[i] - y[i - 1]) / (x[i] - x[i - 1]))
        u[i] = (6.0 * u[i] / (x[i + 1] - x[i - 1]) - sig * u[i - 1]) / p
    for k in range(n - 2, -1, -1):
        y2[k] = y2[k] * y2[k + 1] + u[k]
    return y2


def interp_init(x, y, itype=INTERP_TYPE_LINLIN, options=0, device=None):
    """Build an interpolation table from host samples (numpy or lists) on
    `device` (the card unless the caller asks for the CPU).  (reference:
    sim5_interp_init, sim5interpolation.c:184-291)"""
    x = np.asarray(x, np.float64)
    y = np.asarray(y, np.float64)
    if itype in (INTERP_TYPE_LOGLOG, INTERP_TYPE_LOGLIN):
        xs = np.log(x)
    else:
        xs = x
    ys = np.log(y) if itype == INTERP_TYPE_LOGLOG else y
    y2 = (_spline_second_derivs(xs, ys) if itype == INTERP_TYPE_SPLINE
          else np.zeros_like(xs))
    dev = default_device(device)
    return Interp(*(torch.as_tensor(v, dtype=torch.float64, device=dev)
                    for v in (xs, ys, y2)), itype, options)


class InterpBuilder:
    """Incremental-build data model (reference: INTERP_DATA_BUILD,
    sim5interpolation.h:26 + sim5_interp_data_push,
    sim5interpolation.c:296-322): (x, y) samples are pushed one at a time
    on the host, in strictly increasing x as the reference enforces
    (sim5interpolation.c:315-319), and `finalize()` freezes them into an
    `Interp` on `device`.
    """

    def __init__(self, itype=INTERP_TYPE_LINLIN, options=0, device=None):
        self.itype = itype
        self.options = options
        self.device = device
        self._x = []
        self._y = []

    def push(self, x, y):
        """Append one (x, y) sample (reference: sim5_interp_data_push)."""
        x = float(x)
        if self._x and x <= self._x[-1]:
            raise ValueError(
                f"unordered X grid (x[{len(self._x)-1}]={self._x[-1]:.4e}, "
                f"x[{len(self._x)}]={x:.4e})")
        self._x.append(x)
        self._y.append(float(y))
        return self

    def __len__(self):
        return len(self._x)

    def finalize(self):
        """Freeze pushed data into an `Interp` table."""
        if len(self._x) < 2:
            raise ValueError("need at least 2 pushed points")
        return interp_init(self._x, self._y, self.itype, self.options,
                           self.device)


def interp_init_build(itype=INTERP_TYPE_LINLIN, options=0, device=None):
    """Create an empty incremental-build table (INTERP_DATA_BUILD mode)."""
    return InterpBuilder(itype, options, device)


def interp_eval(tab: Interp, xq):
    """Evaluate the table at query points (batched), in f64 on the table's
    device; NaN outside the grid unless the table was built with
    INTERP_OPT_ALLOW_EXTRAPOLATION.

    (reference: sim5_interp_eval, sim5interpolation.c:299-345)
    """
    xq = torch.as_tensor(xq, dtype=torch.float64, device=tab.x.device)
    if tab.itype in (INTERP_TYPE_LOGLOG, INTERP_TYPE_LOGLIN):
        xe = torch.log(xq)
    else:
        xe = xq
    # searchsorted's default (right=False) is jnp.searchsorted's "left"
    i = torch.clamp(torch.searchsorted(tab.x, xe.contiguous()) - 1, 0,
                    tab.x.shape[0] - 2)
    x0 = tab.x[i]
    x1 = tab.x[i + 1]
    y0 = tab.y[i]
    y1 = tab.y[i + 1]
    h = x1 - x0
    t = (xe - x0) / h
    if tab.itype == INTERP_TYPE_SPLINE:
        a = 1.0 - t
        val = (a * y0 + t * y1
               + ((a ** 3 - a) * tab.y2[i] + (t ** 3 - t) * tab.y2[i + 1])
               * (h * h) / 6.0)
    else:
        val = y0 + t * (y1 - y0)
    if tab.itype == INTERP_TYPE_LOGLOG:
        val = torch.exp(val)
    if not (tab.options & INTERP_OPT_ALLOW_EXTRAPOLATION):
        val = torch.where((xe < tab.x[0]) | (xe > tab.x[-1]), torch.nan, val)
    return val
