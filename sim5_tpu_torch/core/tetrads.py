"""Orthonormal tetrads and frame transforms.  Port of
`sim5_tpu/core/tetrads.py` (the part the stepwise march needs).

A tetrad is a `Tetrad` dataclass holding the basis e[(a)]^mu as a (..., 4, 4)
tensor (first index = tetrad vector, second = coordinate component) plus
the metric at the point.  (reference: sim5kerr.c:629-970)
"""

import dataclasses

import torch

from .metric import Metric, dotprod


@dataclasses.dataclass(frozen=True)
class Tetrad:
    e: torch.Tensor      # (..., 4, 4) basis vectors e[(a)]^mu
    metric: Metric


def tetrad_zamo(metric: Metric):
    """Tetrad of a zero-angular-momentum observer.  (sim5kerr.c:678-710)"""
    g = metric
    z = torch.zeros_like(g.g00)
    e00 = torch.sqrt(g.g33 / (g.g03 ** 2 - g.g33 * g.g00))
    e0 = torch.stack([e00, z, z, -e00 * g.g03 / g.g33], -1)
    e1 = torch.stack([z, 1.0 / torch.sqrt(g.g11), z, z], -1)
    e2 = torch.stack([z, z, -1.0 / torch.sqrt(g.g22), z], -1)
    e3 = torch.stack([z, z, z, 1.0 / torch.sqrt(g.g33)], -1)
    return Tetrad(torch.stack([e0, e1, e2, e3], -2), metric)


def _like(V, tetrad: Tetrad):
    return torch.as_tensor(V, dtype=tetrad.e.dtype, device=tetrad.e.device)


def bl2on(Vin, tetrad: Tetrad):
    """Coordinate (BL) -> local orthonormal frame: V^(a) = eta^ab e_(b).V.

    (sim5kerr.c:925-944)
    """
    Vin = _like(Vin, tetrad)
    d = [dotprod(tetrad.e[..., i, :], Vin, tetrad.metric) for i in range(4)]
    return torch.stack([-d[0], d[1], d[2], d[3]], -1)


def on2bl(Vin, tetrad: Tetrad):
    """Local orthonormal -> coordinate (BL) frame: V^mu = V^(a) e_(a)^mu.

    (sim5kerr.c:948-970)
    """
    return torch.einsum('...a,...am->...m', _like(Vin, tetrad), tetrad.e)
