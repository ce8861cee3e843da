"""The port's stepwise march engine (`sim5_tpu_torch.march.raytrace`)
against `sim5_tpu.march` and the C-reference rays, in f64.

Both packages get the same numpy-seeded rays; the prepared JAX state is
carried into the port with `RaytraceState.from_numpy`, so both march the
same state.
"""

import dataclasses

import numpy as np
import pytest
import torch

from sim5_tpu.core import kerr_metric, flat_metric, tetrad_zamo, on2bl
from sim5_tpu import march as jm
from sim5_tpu_torch import march as tm

torch.set_num_threads(2)

FIELDS = ("x", "k", "f", "a", "E", "Q", "kt", "error", "steps",
          "step_epsilon", "step_epsilon0")
OPTIONS = {"gr": jm.RTOPT_NONE, "gr+pol": jm.RTOPT_POLARIZATION,
           "flat": jm.RTOPT_FLAT}


def _as_dict(st):
    """A JAX RaytraceState as a dict of numpy arrays."""
    return {f.name: np.asarray(getattr(st, f.name))
            for f in dataclasses.fields(st)}


def _rays(n, a, seed, flat=False, outward=0.0):
    """ZAMO rays at r in [6, 15], |m| < 0.5 (as test_pallas_march), made
    with numpy; returns numpy (x, k, f0) with f0 the tetrad's e2 leg."""
    rng = np.random.default_rng(seed)
    r = rng.uniform(6.0, 15.0, n)
    m = rng.uniform(-0.5, 0.5, n)
    th = rng.uniform(0.3, np.pi - 0.3, n)
    ph = rng.uniform(0.0, 2 * np.pi, n)
    T = tetrad_zamo(flat_metric(r, m) if flat else kerr_metric(a, r, m))
    d = np.stack([np.sin(th) * np.cos(ph) + outward,
                  np.sin(th) * np.sin(ph), np.cos(th)], -1)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    kloc = np.concatenate([np.ones((n, 1)), d], -1)
    x = np.stack([np.zeros(n), r, m, np.zeros(n)], -1)
    f0 = np.asarray(on2bl(np.broadcast_to([0.0, 0.0, 1.0, 0.0], (n, 4)), T))
    return x, np.asarray(on2bl(kloc, T)), f0


def _prepared(variant, n=32, a=0.5, seed=0):
    """(JAX state, port state) of the same prepared f64 rays."""
    x, k, f0 = _rays(n, a, seed, flat=variant == "flat")
    stj = jm.raytrace_prepare(a, x, k, f=f0 if variant == "gr+pol" else None,
                              precision=0.01, options=OPTIONS[variant])
    return stj, tm.RaytraceState.from_numpy(_as_dict(stj))


def _close(got, want, rtol=1e-12, atol=0.0):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), rtol=rtol, atol=atol)


class TestAgainstJax:
    """The torch engine against sim5_tpu.march on the same state."""

    def test_state_round_trip(self):
        stj, st = _prepared("gr+pol")
        d = st.numpy()
        for name, v in _as_dict(stj).items():
            np.testing.assert_array_equal(d[name], v)
            if name in FIELDS:
                assert getattr(st, name).dtype == torch.from_numpy(
                    np.asarray(v)).dtype

    @pytest.mark.parametrize("variant", list(OPTIONS))
    def test_prepare_matches_jax(self, variant):
        x, k, f0 = _rays(24, 0.7, seed=1, flat=variant == "flat")
        f = f0 if variant == "gr+pol" else None
        stj = jm.raytrace_prepare(0.7, x, k, f=f, precision=0.01,
                                  options=OPTIONS[variant])
        st = tm.raytrace_prepare(0.7, torch.from_numpy(x), torch.from_numpy(k),
                                 f=f, precision=0.01, options=OPTIONS[variant])
        assert (st.opt_gr, st.opt_pol) == (stj.opt_gr, stj.opt_pol)
        for name in FIELDS:
            _close(getattr(st, name), getattr(stj, name))
        assert st.x.dtype == torch.float64 and st.steps.dtype == torch.int32

    @pytest.mark.parametrize("variant", list(OPTIONS))
    def test_one_step_matches_jax(self, variant):
        stj, st = _prepared(variant, seed=2)
        sj, dlj = jm.raytrace_step(stj)
        sj, dlj = jm.raytrace_step(sj)
        s1, dl = tm.raytrace_step(st)
        s1, dl = tm.raytrace_step(s1)
        _close(dl, dlj)
        for name in ("x", "k", "f", "kt", "step_epsilon", "steps"):
            _close(getattr(s1, name), getattr(sj, name))
        # the error monitor is round-off sized (~1e-16): compare absolutely
        _close(s1.error, sj.error, rtol=0.0, atol=1e-12)

    @pytest.mark.parametrize("a", [0.3, 0.9])
    def test_raytrace_matches_jax(self, a):
        stj, st = _prepared("gr", n=32, a=a, seed=4)
        kw = dict(r_max=50.0, max_steps=300)
        sj, actj = jm.raytrace(stj, **kw)
        s, act = tm.raytrace(st, **kw)
        steps_j, steps = np.asarray(sj.steps), s.steps.numpy()
        eq = steps == steps_j
        assert eq.mean() >= 0.98
        rj, r = np.asarray(sj.x[:, 1]), s.x[:, 1].numpy()
        assert (np.abs(r - rj) / np.abs(rj))[eq].max() <= 1e-8
        assert (act.numpy() == np.asarray(actj))[eq].all()
        _close(tm.raytrace_error(s)[eq], np.asarray(jm.raytrace_error(sj))[eq],
               rtol=1e-6, atol=1e-12)

    def test_dtype_follows_inputs(self):
        x, k, _ = _rays(8, 0.5, seed=5)
        st = tm.raytrace_prepare(0.5, torch.tensor(x, dtype=torch.float32),
                                 torch.tensor(k, dtype=torch.float32))
        st, dl = tm.raytrace_step(st)
        assert st.x.dtype == st.kt.dtype == dl.dtype == torch.float32
        assert st.steps.dtype == torch.int32


class TestGolden:
    """The torch engine against the C reference rays."""

    def test_golden_raytrace(self, golden_raytrace):
        """The 40 C-reference rays (tools/golden_dump.c:dump_raytrace): the
        port gives each ray C's fate, with a Carter drift at most the JAX
        engine's on the same ray plus 1e-9."""
        r0, rN = golden_raytrace["ray0"], golden_raytrace["rayN"]
        a, x, k = r0[:, 0], r0[:, 1:5], r0[:, 5:9]
        kw = dict(r_max=1e4, max_steps=50000)
        stj, actj = jm.raytrace(jm.raytrace_prepare(a, x, k, precision=0.01), **kw)
        with torch.inference_mode():
            st = tm.raytrace_prepare(torch.from_numpy(a), torch.from_numpy(x),
                                     torch.from_numpy(k), precision=0.01)
            st, act = tm.raytrace(st, **kw)
            drift = tm.raytrace_error(st).numpy()
        assert not act.any()
        escaped_c = rN[:, 2] >= 1e4
        escaped = st.x[:, 1].numpy() >= 1e4
        np.testing.assert_array_equal(escaped, escaped_c)
        drift_j = np.asarray(jm.raytrace_error(stj))
        assert np.isfinite(drift).all()
        assert (drift <= drift_j + 1e-9).all()
