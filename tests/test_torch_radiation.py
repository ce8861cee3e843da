"""The port's blackbody emission (`sim5_tpu_torch.radiation`) against
`sim5_tpu.radiation` on numpy-seeded inputs, and its Planck photon
sampler.

Tolerances, and why:
* the blackbody functions: relative 1e-13 -- the same f64 algebra with
  the Planck prefactor folded on the host in the same order (E^3 and
  hardf^4 may round apart by an ulp or two);
* the sampler's transform given the JAX package's own uniforms: relative
  1e-14 (a product of three uniforms, a log and a division);
* the sampled mean photon energy: 2.701 kT within 1% at 200000 draws (the
  standard error is 0.15%).
"""

import numpy as np
import torch

import jax
import jax.numpy as jnp

from sim5_tpu import consts
from sim5_tpu import radiation as jrad
from sim5_tpu_torch import radiation as trad

torch.set_num_threads(2)

N = 96


def _rel(got, want):
    got, want = got.numpy(), np.asarray(want)
    assert got.shape == want.shape
    assert (np.isfinite(got) == np.isfinite(want)).all()
    assert ((got == 0) == (want == 0)).all()
    nz = want != 0
    return float(np.max(np.abs(got[nz] - want[nz]) / np.abs(want[nz])))


def _inputs(seed=0):
    """Temperatures over 1e4-1e8 K with some T <= 0, hardening 1-2.5,
    cos mu over (-1, 1) (limb darkening and the isotropic branch), and
    energies over 1e-3-300 keV, so that u = E/(k f T) passes 350."""
    rng = np.random.default_rng(seed)
    T = 10.0 ** rng.uniform(4.0, 8.0, N)
    T[:6] = (0.0, -1e6, 0.0, -1.0, 0.0, -5e7)
    f = rng.uniform(1.0, 2.5, N)
    mu = rng.uniform(-1.0, 1.0, N)
    E = 10.0 ** rng.uniform(-3.0, 2.5, N)
    return T, f, mu, E


class TestBlackbodyAgainstJax:
    def test_iv_and_spectrum(self):
        T, f, mu, E = _inputs()
        u = consts.planck_h * consts.kev2freq * E / (consts.boltzmann_k * f
                                                     * np.abs(T).clip(1.0))
        assert (u > 350.0).any() and (mu < 0).any() and (T <= 0).any()
        tT, tf, tmu, tE = (torch.from_numpy(v) for v in (T, f, mu, E))
        want = jrad.blackbody_Iv(T, f, mu, E)
        got = trad.blackbody_Iv(tT, tf, tmu, tE)
        assert got.dtype == torch.float64
        assert _rel(got, want) <= 1e-13
        assert (got[:6] == 0).all()
        # over an energy grid: (N, 1) against (n_E,)
        Eg = np.geomspace(0.1, 20.0, 7)
        want = jrad.blackbody(T[:, None], f[:, None], mu[:, None], Eg)
        got = trad.blackbody(tT[:, None], tf[:, None], tmu[:, None],
                             torch.from_numpy(Eg))
        assert _rel(got, want) <= 1e-13
        assert _rel(trad.blackbody_photons(tT, tf, tmu, tE),
                    jrad.blackbody_photons(T, f, mu, E)) <= 1e-13

    def test_photons_total(self):
        T, f, _, _ = _inputs(1)
        assert _rel(trad.blackbody_photons_total(torch.from_numpy(T),
                                                 torch.from_numpy(f)),
                    jrad.blackbody_photons_total(T, f)) <= 1e-13

    def test_sampler_transform_given_jax_uniforms(self):
        key = jax.random.PRNGKey(7)
        T, shape = 3e7, (4096,)
        want = jrad.blackbody_photon_energy_random(key, T, shape)
        # the JAX function's own draws (sim5_tpu/radiation/__init__.py:80-82)
        k1, k2 = jax.random.split(key)
        u1 = np.array(jax.random.uniform(k1, shape, jnp.float64))
        u234 = np.array(jax.random.uniform(k2, shape + (3,), jnp.float64))
        got = trad.planck_energy_from_uniforms(T, torch.from_numpy(u1),
                                               torch.from_numpy(u234))
        assert _rel(got, want) <= 1e-14


class TestSampler:
    def test_mean_energy(self):
        T = 1e7
        gen = torch.Generator(device="cpu").manual_seed(11)
        E = trad.blackbody_photon_energy_random(gen, T, (200000,))
        assert E.shape == (200000,) and E.dtype == torch.float64
        assert E.device.type == "cpu" and bool((E > 0).all())
        kT = consts.boltzmann_k * T * consts.erg2kev
        assert abs(float(E.mean()) / kT - 2.701) <= 0.01 * 2.701
        # the same generator state draws the same energies
        gen2 = torch.Generator(device="cpu").manual_seed(11)
        assert torch.equal(E, trad.blackbody_photon_energy_random(
            gen2, T, (200000,)))
