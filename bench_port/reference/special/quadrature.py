"""Fixed-grid quadrature: trapezoid and composite Simpson rules, and
Gauss-Legendre.

Port of `sim5_tpu/special/quadrature.py`.  Fixed node counts replace the
reference's adaptive refinement (sim5integration.c), so a rule evaluates
in lockstep.  Weights are float64 tensors on `device`; cast them to the
integrand's dtype where it differs.  The Gauss-Legendre nodes are numpy's
`leggauss` on the host, sent to the device.
"""

import numpy as np
import torch

from ..core.metric import default_device


def trapezoid_weights(n, device=None):
    """Trapezoid weights [0.5, 1, ..., 1, 0.5] of n panels."""
    i = torch.arange(n + 1, device=default_device(device))
    return torch.where((i == 0) | (i == n), 0.5, 1.0).to(torch.float64)


def simpson_weights(n, device=None):
    """Composite-Simpson weights [1, 4, 2, 4, ..., 2, 4, 1] (n even)."""
    i = torch.arange(n + 1, device=default_device(device))
    inner = torch.where(i % 2 == 1, 4.0, 2.0)
    return torch.where((i == 0) | (i == n), 1.0, inner).to(torch.float64)


def _nodes(a, b, n):
    a = torch.as_tensor(a, dtype=torch.float64)
    dev = a.device
    b = torch.as_tensor(b, dtype=a.dtype, device=dev)
    return a, b, a + (b - a) * torch.arange(n + 1, device=dev) / n


def integrate_trapezoid(f, a, b, n=4096):
    """Trapezoid rule with n panels.  (reference: integrate_trapezoid,
    sim5integration.c:34-77)"""
    a, b, xs = _nodes(a, b, n)
    ys = f(xs)
    w = trapezoid_weights(n, xs.device).to(ys.dtype)
    return (b - a) / n * torch.sum(w * ys)


def integrate_simpson(f, a, b, n=4096):
    """Composite Simpson rule with n panels (n rounded up to even).
    (reference: integrate_simpson, sim5integration.c:96-133)"""
    n = n + (n % 2)
    a, b, xs = _nodes(a, b, n)
    ys = f(xs)
    w = simpson_weights(n, xs.device).to(ys.dtype)
    return (b - a) / n / 3.0 * torch.sum(w * ys)


def gauleg(a, b, n, dtype=torch.float64, device=None):
    """Gauss-Legendre nodes and weights on [a, b] (Python numbers), as
    `dtype` tensors on `device` (the card unless the caller asks for the
    CPU).  (reference: gauleg, sim5integration.c:163-213)"""
    x, w = np.polynomial.legendre.leggauss(n)
    x = 0.5 * (b - a) * x + 0.5 * (b + a)
    w = 0.5 * (b - a) * w
    dev = default_device(device)
    return (torch.as_tensor(x, dtype=dtype, device=dev),
            torch.as_tensor(w, dtype=dtype, device=dev))


def qgaus(f, a, b, n=10, device=None):
    """Fixed-order Gauss-Legendre quadrature of f on [a, b], on `device`
    (the card unless the caller asks for the CPU).  (reference: qgaus,
    sim5integration.c:138-155)"""
    x, w = gauleg(float(a), float(b), n, device=device)
    return torch.sum(w * f(x))
