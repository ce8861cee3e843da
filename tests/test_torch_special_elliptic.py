"""The port's Carlson RD/RC/RJ, Legendre integrals and Jacobi functions
and inverses (`sim5_tpu_torch.special`) against `sim5_tpu.special` on the
same numpy-seeded inputs, and against the C-reference goldens
(tests/golden/special.txt).

Tolerances:
* goldens: `test_special.py`'s thresholds (relative 1e-9; rj 1e-8);
* f64 against the JAX package: relative 1e-12 (the same IEEE f64
  operations; the differences are a few roundings, amplified at most by
  the principal-value transforms of rc and rj for negative arguments);
* f32 (the JAX package under `enable_x64(False)`, the port on f32
  tensors): relative 8 f32 ulps (8 * 2**-23), absolute 8 ulps of the
  scale of the result for the functions whose value crosses zero or ends
  in a difference of two integrals (E and Pi over the second quadrant,
  where X - base cancels), which the same roundings move by ulps of the
  terms, not of the result; for the principal values (rj at p < 0,
  Pi(n, m) at n > 1) relative 8 ulps times the condition number of the
  final sum, sum |terms| / |result| (computed in f64 by the port).
"""

import jax
import numpy as np
import pytest
import torch

from sim5_tpu import special as jsp
from sim5_tpu_torch import special as tsp

torch.set_num_threads(2)

N = 128
F32_RTOL = 8 * 2.0 ** -23


def _t(*arrays, dtype=torch.float64):
    """numpy arrays as CPU tensors of `dtype`."""
    return [torch.tensor(np.asarray(v), dtype=dtype) for v in arrays]


def _close(got, want, rtol, atol=0.0):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    finite = np.isfinite(want)
    assert (np.isfinite(got) == finite).all()
    np.testing.assert_allclose(got[finite], want[finite], rtol=rtol,
                               atol=atol)


def _args(name, seed):
    """numpy-seeded arguments of `name`, across its domain (negative y of
    rc and p of rj for the principal values, both quadrants of the
    amplitude, both signs of z)."""
    rng = np.random.default_rng(seed)

    def u(lo, hi):
        return rng.uniform(lo, hi, N)

    def logu(lo, hi):
        return 10.0 ** rng.uniform(lo, hi, N)

    m = u(0.0, 0.98)
    n = np.where(rng.uniform(size=N) < 0.5, u(-4.0, 0.9), u(1.2, 4.0))
    return {
        "rd": (logu(-6, 2), logu(-6, 2), logu(-4, 2)),
        "rc": (logu(-6, 2), np.where(rng.uniform(size=N) < 0.5, -1.0, 1.0)
               * logu(-4, 2)),
        "rj": (logu(-4, 2), logu(-4, 2), logu(-4, 2),
               np.where(rng.uniform(size=N) < 0.3, -1.0, 1.0)
               * logu(-3, 2)),
        "elliptic_k": (m,),
        "elliptic_f": (u(-6.0, 6.0), m),
        "elliptic_f_cos": (u(-1.0, 1.0), m),
        "elliptic_f_sin": (u(0.0, 0.999), m),
        "elliptic_e": (u(0.0, np.pi), m),
        "elliptic_e_cos": (u(-1.0, 1.0), m),
        "elliptic_e_sin": (u(0.0, 0.999), m),
        "elliptic_pi_complete": (n, m),
        "elliptic_pi_cos": (u(-1.0, 1.0), n, m),
        "elliptic_pi_sin": (u(0.0, 0.999), n, m),
        "jacobi_sn": (u(-8.0, 8.0), m),
        "jacobi_cn": (u(-8.0, 8.0), m),
        "jacobi_dn": (u(-8.0, 8.0), m),
        "jacobi_isn": (u(-0.999, 0.999), m),
        "jacobi_icn": (u(-1.0, 1.0), m),
        "icn_signed": (u(-0.999, 0.999), u(0.01, 0.98)),
        "jacobi_itn": (u(-20.0, 20.0), m),
    }[name]


FUNCS = ("rd", "rc", "rj", "elliptic_k", "elliptic_f", "elliptic_f_cos",
         "elliptic_f_sin", "elliptic_e", "elliptic_e_cos", "elliptic_e_sin",
         "elliptic_pi_complete", "elliptic_pi_cos", "elliptic_pi_sin",
         "jacobi_sn", "jacobi_cn", "jacobi_dn", "jacobi_isn", "jacobi_icn",
         "icn_signed", "jacobi_itn")
# f32 results that end in a difference of two terms (module docstring)
F32_ABS = ("elliptic_e", "elliptic_e_cos", "elliptic_pi_cos", "jacobi_icn",
           "jacobi_sn", "jacobi_cn", "elliptic_f", "elliptic_f_cos")


@pytest.mark.parametrize("tag,fn,nargs,rtol", [
    ("rd", "rd", 3, 1e-9), ("rc", "rc", 2, 1e-9), ("rj", "rj", 4, 1e-8),
    ("ek", "elliptic_k", 1, 1e-9), ("ef", "elliptic_f", 2, 1e-9),
    ("ee", "elliptic_e", 2, 1e-9), ("isn", "jacobi_isn", 2, 1e-9),
    ("icn", "jacobi_icn", 2, 1e-9), ("itn", "jacobi_itn", 2, 1e-9)])
def test_golden(golden_special, tag, fn, nargs, rtol):
    """The port against the C reference, where the reference is finite
    (`test_special.py`'s `_check`)."""
    d = golden_special[tag]
    got = getattr(tsp, fn)(*_t(*(d[:, i] for i in range(nargs)))).numpy()
    want = d[:, nargs]
    finite = np.isfinite(want)
    ok = np.isclose(got[finite], want[finite], rtol=rtol, atol=1e-14)
    assert ok.all(), f"{(~ok).sum()}/{ok.size} mismatches against C"


class TestAgainstJaxF64:
    """The port against sim5_tpu.special in f64."""

    @pytest.mark.parametrize("name", FUNCS)
    def test_function(self, name):
        args = _args(name, FUNCS.index(name))
        got = getattr(tsp, name)(*_t(*args))
        assert got.dtype == torch.float64
        _close(got, getattr(jsp, name)(*args), 1e-12, atol=1e-15)


def _condition(name, args):
    """sum |terms| / |result| of the final sum of the principal values of
    rj (p < 0) and Pi(n, m) (n > 1), 1 elsewhere, in f64."""
    if name == "rj":
        x, y, z, p = _t(*args)
        xs = torch.minimum(torch.minimum(x, y), z)
        zs = torch.maximum(torch.maximum(x, y), z)
        ys = x + y + z - xs - zs
        a_ = 1.0 / (ys - p)
        b_ = a_ * (zs - ys) * (ys - xs)
        pt = ys + b_
        terms = a_.abs() * ((b_ * tsp.rj(xs, ys, zs, pt.abs())).abs()
                            + 3.0 * tsp.rc(xs * zs / ys, p * pt / ys).abs()
                            + 3.0 * tsp.rf(xs, ys, zs).abs())
        kappa = terms / tsp.rj(x, y, z, p).abs()
        return torch.where(p < 0.0, kappa, 1.0).numpy()
    if name == "elliptic_pi_complete":
        n, m = _t(*args)
        z, o = torch.zeros_like(m), torch.ones_like(m)
        terms = (tsp.rf(z, 1.0 - m, o).abs()
                 + (n * tsp.rj(z, 1.0 - m, o, 1.0 - n) / 3.0).abs())
        kappa = terms / tsp.elliptic_pi_complete(n, m).abs()
        return torch.where(n > 1.0, kappa, 1.0).numpy()
    return 1.0


class TestAgainstJaxF32:
    """The port on f32 tensors against sim5_tpu.special under
    `jax.enable_x64(False)`: the f32 depths (RF, RD, RC, RJ 7, the AGM 8)
    are selected by the tensors' dtype."""

    @pytest.mark.parametrize("name", FUNCS)
    def test_function(self, name):
        args = [v.astype(np.float32) for v in _args(name, FUNCS.index(name))]
        with jax.enable_x64(False):
            want = np.asarray(getattr(jsp, name)(*args))
        got = getattr(tsp, name)(*_t(*args, dtype=torch.float32))
        assert got.dtype == torch.float32
        atol = (F32_RTOL * float(np.abs(want[np.isfinite(want)]).max())
                if name in F32_ABS else 0.0)
        rtol = F32_RTOL * _condition(name, args)
        got = got.numpy()
        assert (np.isfinite(got) == np.isfinite(want)).all()
        assert (np.abs(got - want) <= atol + rtol * np.abs(want))[
            np.isfinite(want)].all()
