"""Emission and absorption models for the tests of the traced march
kernel (`sim5_tpu_torch.march.model_trace`), each in torch and as its jnp
twin: the JAX tests' blob and alpha_blob (test_pallas_march.py:103,127),
example 11's torus_j and make_alpha (examples/11_thick_volume_transfer.py),
a power-law corona and its absorption, a two-armed spiral that depends on
time and azimuth, and the flare of test_march.py:235.
"""

import jax.numpy as jnp
import numpy as np
import torch


def blob(xp):
    def blob(t, r, m, phi):
        return xp.exp(-0.5 * ((r - 8.0) ** 2 + (m * r) ** 2))
    return blob


def alpha_blob(xp):
    def alpha_blob(t, r, m, phi):
        return 0.15 * xp.exp(-0.5 * ((r - 8.0) / 3.0) ** 2)
    return alpha_blob


def _clamp0(xp, x):
    return torch.clamp(x, min=0.0) if xp is torch else jnp.maximum(x, 0.0)


def torus_j(xp):
    def torus_j(t, r, m, phi):
        R = r * xp.sqrt(_clamp0(xp, 1.0 - m * m))
        z = r * m
        return xp.exp(-0.5 * (((R - 8.0) / 1.5) ** 2 + (z / 1.5) ** 2))
    return torus_j


def make_alpha(xp, alpha0):
    j = torus_j(xp)

    def torus_alpha(t, r, m, phi):
        return alpha0 * j(t, r, m, phi)
    return torus_alpha


def corona(xp):
    def corona(t, r, m, phi):
        return (xp.where(r > 2.0, r ** -2.5, 0.0)
                * xp.exp(-0.5 * (m / 0.3) ** 2))
    return corona


def corona_alpha(xp):
    def corona_alpha(t, r, m, phi):
        return 0.05 * r ** -1.5 * xp.exp(-0.5 * (m / 0.3) ** 2)
    return corona_alpha


def spiral(xp):
    def spiral(t, r, m, phi):
        R = r * xp.sqrt(_clamp0(xp, 1.0 - m * m))
        return (xp.exp(-0.5 * ((R - 8.0) / 2.0) ** 2 - 0.5 * (r * m) ** 2)
                * (1.0 + 0.5 * xp.cos(2.0 * (phi - 0.05 * t)
                                      - 4.0 * xp.log(R))))
    return spiral


def spiral_alpha(xp, alpha0=0.2):
    j = spiral(xp)

    def spiral_alpha(t, r, m, phi):
        return alpha0 * j(t, r, m, phi)
    return spiral_alpha


def flare(xp, r_spot=8.0, t_flare=-30.0):
    def flare(t, r, m, phi):
        rho2 = (r - r_spot) ** 2 + (r * m) ** 2
        return (xp.exp(-0.5 * rho2 / 1.5 ** 2)
                * xp.exp(-0.5 * ((t - t_flare) / 10.0) ** 2))
    return flare


# name -> maker(xp) of every model above
MODELS = {
    "blob": blob, "alpha_blob": alpha_blob, "torus_j": torus_j,
    "torus_alpha": lambda xp: make_alpha(xp, 0.2), "corona": corona,
    "corona_alpha": corona_alpha, "spiral": spiral,
    "spiral_alpha": spiral_alpha, "flare": flare,
}


def inputs(n, seed):
    """Seeded (t, r, m, phi) f32 numpy arrays over the march's range: t in
    [-60, 10], r in [1.2, 40] with some at exactly 2 (the corona's edge),
    m in [-1, 1], phi in [-20, 20] (negative remainders)."""
    rng = np.random.default_rng(seed)
    t = rng.uniform(-60.0, 10.0, n)
    r = rng.uniform(1.2, 40.0, n)
    r[::97] = 2.0
    m = rng.uniform(-1.0, 1.0, n)
    phi = rng.uniform(-20.0, 20.0, n)
    return [v.astype(np.float32) for v in (t, r, m, phi)]
