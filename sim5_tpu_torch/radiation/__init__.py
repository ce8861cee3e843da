"""Radiative processes: blackbody emission with hardening and limb darkening.

Port of `sim5_tpu/radiation`.  Dtype and device follow the inputs; inputs
that hold no tensor become f64 on the card.  (reference: sim5radiation.c)
"""

import math

import torch

from .. import consts
from ..core.metric import _as_tensors
from ..utils.fastmath import expm1_accurate


# Planck prefactor 2 h (kev2freq)^3 / c^2 / freq2kev, folded on the host in
# the JAX package's order, so that values match it at f64 rounding
_BB_PREF = float(2.0 * consts.planck_h * consts.kev2freq ** 3
                 / consts.speed_of_light ** 2 / consts.freq2kev)

# the modes of the Planck sampler: P(m) ~ 1/m^3 for m = 1 .. _MMAX
_MMAX = 64


def blackbody_Iv(T, hardf, cos_mu, E):
    """Specific intensity of blackbody radiation at energy E [keV] from a
    surface of temperature T [K], hardening factor `hardf` and limb
    darkening for cos_mu >= 0 (isotropic for cos_mu < 0); 0 where T <= 0.

    Returns [erg cm-2 s-1 keV-1 srad-1].  (sim5radiation.c:25-48)
    """
    T, hardf, cos_mu, E = _as_tensors(T, hardf, cos_mu, E)
    limbf = torch.where(cos_mu >= 0.0, 0.5 + 0.75 * cos_mu, 1.0)
    Tsafe = torch.where(T > 0.0, T, 1.0)
    # the Planck exponent clamped at 350: beyond it the intensity underflows
    # to 0 anyway, and expm1's gradient would overflow to NaN
    u = torch.clamp((consts.planck_h * consts.kev2freq * E)
                    / (consts.boltzmann_k * hardf * Tsafe), max=350.0)
    val = (limbf * _BB_PREF * E ** 3 / hardf ** 4 / expm1_accurate(u))
    return torch.where(T > 0.0, val, 0.0)


def blackbody(T, hardf, cos_mu, E):
    """Vectorized blackbody spectrum over an energy array.  (sim5radiation.c:53-78)"""
    return blackbody_Iv(T, hardf, cos_mu, E)


def blackbody_photons(T, hardf, cos_mu, E):
    """Specific photon intensity [photons cm-2 s-1 keV-1 srad-1].

    (sim5radiation.c:83-93)
    """
    Iv = blackbody_Iv(T, hardf, cos_mu, E)
    return Iv / (_as_tensors(E, Iv)[0] * consts.kev2erg)


def blackbody_photons_total(T, hardf):
    """Total photon rate from a blackbody surface [photons cm-2 s-1 srad-1].

    (sim5radiation.c:96-113)
    """
    T, hardf = _as_tensors(T, hardf)
    pref = float(consts.boltzmann_k ** 3 / consts.planck_h ** 3
                 / consts.speed_of_light2)
    return math.pi * 4.808227612 * T ** 3 * pref / hardf


def planck_energy_from_uniforms(T, u1, u234):
    """The sampling transform of `blackbody_photon_energy_random`: photon
    energies [keV] at temperature T [K] from uniforms u1 (shape) and u234
    (shape + (3,)) in [0, 1), by the Barlow/Carter rejection-free scheme
    (arXiv:1307.3635 sec 3.3.1): the mode m with P(m) ~ 1/m^3 by the
    inverse CDF against 1.202 u1, then -kT log(u2 u3 u4) / m."""
    u1, = _as_tensors(u1)
    u234 = torch.as_tensor(u234, dtype=u1.dtype, device=u1.device)
    j = torch.arange(1, _MMAX + 1, dtype=u1.dtype, device=u1.device)
    cum = torch.cumsum(1.0 / j ** 3, 0)
    m = 1.0 + (1.202 * u1[..., None] >= cum).sum(-1).to(u1.dtype)
    return (consts.boltzmann_k * T * (-torch.log(torch.prod(u234, -1))) / m
            * consts.erg2kev)


def blackbody_photon_energy_random(generator, T, shape=()):
    """Sample photon energies [keV] from a Planck distribution at
    temperature T [K], f64 on the generator's device.

    The reference uses thread-local MT19937 (sim5radiation.c:118-140) and
    the JAX package a PRNG key; here the draws come from the explicit
    `torch.Generator`, and `planck_energy_from_uniforms` is the transform.
    """
    shape = tuple(shape)
    kw = dict(generator=generator, dtype=torch.float64,
              device=generator.device)
    u1 = torch.rand(shape, **kw)
    u234 = torch.rand(shape + (3,), **kw)
    return planck_energy_from_uniforms(T, u1, u234)
