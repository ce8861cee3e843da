"""Random sampling from tabulated PDFs by inverse-CDF lookup.

Port of `sim5_tpu/special/distributions.py`, the batched replacement of
the reference's sim5distrib (sim5distributions.c:22-104): the PDF is
integrated on a dense grid into a CDF, whose inverse is evaluated by one
`torch.searchsorted` and a linear blend.  Sampling draws its uniforms from
an explicit `torch.Generator` where the JAX package takes a PRNG key.
"""

from typing import NamedTuple

import torch

from ..core.metric import default_device


class Distrib(NamedTuple):
    """Tabulated distribution: grid x and the CDF on x (monotone 0..1),
    f64 tensors on one device."""
    x: torch.Tensor
    cdf: torch.Tensor

    def icdf(self, u):
        return distrib_icdf(self, u)

    def sample(self, generator, shape=()):
        return distrib_hit(self, generator, shape)


def distrib_init(pdf_fn, x_min, x_max, n=2048, device=None):
    """Build a Distrib from a PDF callable (on f64 tensors) on [x_min,
    x_max], on `device` (the card unless the caller asks for the CPU).

    (reference: distrib_init, sim5distributions.c:22-75; the reference's
    Gauss-Legendre + spline machinery reduces to a dense trapezoid CDF)
    """
    dev = default_device(device)
    x = x_min + (x_max - x_min) * torch.arange(
        n + 1, dtype=torch.float64, device=dev) / n
    p = torch.clamp(pdf_fn(x), min=0.0)
    seg = 0.5 * (p[1:] + p[:-1]) * (x[1:] - x[:-1])
    cdf = torch.cat([torch.zeros(1, dtype=torch.float64, device=dev),
                     torch.cumsum(seg, 0)])
    return Distrib(x, cdf / cdf[-1])


def distrib_icdf(d: Distrib, u):
    """Inverse CDF by linear interpolation (batched), in f64 on the
    distribution's device."""
    u = torch.clamp(torch.as_tensor(u, dtype=torch.float64,
                                    device=d.x.device), 0.0, 1.0)
    i = torch.clamp(torch.searchsorted(d.cdf, u.contiguous()) - 1, 0,
                    d.cdf.shape[0] - 2)
    c0, c1 = d.cdf[i], d.cdf[i + 1]
    t = (u - c0) / torch.clamp(c1 - c0, min=1e-300)
    return d.x[i] + t * (d.x[i + 1] - d.x[i])


def distrib_hit(d: Distrib, generator, shape=()):
    """Draw samples of `shape` from the distribution, with uniforms from
    `generator` (a `torch.Generator` on the distribution's device).  A
    seeded generator repeats its draws; the bits cannot match the JAX
    package's `jax.random` draws, but `distrib_icdf` of the same uniforms
    does.  (reference: distrib_hit, sim5distributions.c:92-104)"""
    u = torch.rand(shape, generator=generator, dtype=torch.float64,
                   device=d.x.device)
    return distrib_icdf(d, u)
