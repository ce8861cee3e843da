"""The port's spacetime core (`sim5_tpu_torch.core`) against `sim5_tpu.core`
on the same numpy-seeded inputs, and against the C-reference goldens.

f64 throughout; the port agrees with JAX to a relative 1e-12, and with the
goldens at `test_core.py`'s tolerances.
"""

import numpy as np
import pytest
import torch

from sim5_tpu import core as jcore
from sim5_tpu.core import metric as jmetric
from sim5_tpu_torch import core as tcore
from sim5_tpu_torch.core import metric as tmetric

torch.set_num_threads(2)

N = 64
FIELDS = ("g00", "g11", "g22", "g33", "g03")


def _close(got, want, rtol=1e-12, atol=1e-13):
    """Relative agreement, with `atol` for entries near zero."""
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    finite = np.isfinite(want)  # the reference is NaN outside its domain
    assert (np.isfinite(got) == finite).all()
    got, want = got[finite], want[finite]
    assert np.allclose(got, want, rtol=rtol, atol=atol), (
        f"max abs diff {np.max(np.abs(got - want)):.3e}, max rel diff "
        f"{np.max(np.abs(got - want) / (np.abs(want) + 1e-300)):.3e}")


def _cpu(*arrays):
    """numpy arrays as CPU tensors (the port's default device is the card)."""
    return [torch.from_numpy(np.ascontiguousarray(v)) for v in arrays]


def _points(seed=0, n=N):
    rng = np.random.default_rng(seed)
    a = rng.uniform(0.05, 0.999, n)
    r = rng.uniform(2.5, 40.0, n)
    m = rng.uniform(-0.95, 0.95, n)
    return a, r, m


def _metrics(kind, a, r, m):
    if kind == "kerr":
        return (jcore.kerr_metric(a, r, m),
                tcore.kerr_metric(torch.from_numpy(a), torch.from_numpy(r),
                                  torch.from_numpy(m)))
    return (jcore.flat_metric(r, m),
            tcore.flat_metric(torch.from_numpy(r), torch.from_numpy(m)))


class TestAgainstJax:
    """The port against sim5_tpu.core on the same inputs."""

    @pytest.mark.parametrize("kind", ["kerr", "flat"])
    def test_metric_matches_jax(self, kind):
        gj, gt = _metrics(kind, *_points())
        for name in ("a", "r", "m") + FIELDS:
            _close(getattr(gt, name), getattr(gj, name))
            assert getattr(gt, name).dtype == torch.float64

    @pytest.mark.parametrize("kind", ["kerr", "flat"])
    def test_conn_entries_match_jax(self, kind):
        a, r, m = _points(1)
        if kind == "kerr":
            ej, _ = jmetric._kerr_conn_entries(a, r, m)
            et, shape = tmetric._kerr_conn_entries(*_cpu(a, r, m))
        else:
            ej, _ = jmetric._flat_conn_entries(r, m)
            et, shape = tmetric._flat_conn_entries(*_cpu(r, m))
        assert tuple(shape) == (N,)
        assert list(et) == list(ej)          # same entries, same order
        for key in ej:
            _close(et[key], ej[key])

    @pytest.mark.parametrize("kind", ["kerr", "flat"])
    def test_transport_accel_matches_jax(self, kind):
        a, r, m = _points(2)
        rng = np.random.default_rng(3)
        U, V = rng.normal(size=(N, 4)), rng.normal(size=(N, 4))
        tU, tV = torch.from_numpy(U), torch.from_numpy(V)
        for u, v, tu, tv in ((U, U, tU, tU), (U, V, tU, tV)):
            if kind == "kerr":
                want = jcore.kerr_transport_accel(a, r, m, u, v)
                got = tcore.kerr_transport_accel(torch.from_numpy(a), r, m, tu, tv)
            else:
                want = jcore.flat_transport_accel(r, m, u, v)
                got = tcore.flat_transport_accel(torch.from_numpy(r), m, tu, tv)
            _close(got, want)

    def test_vector_algebra_matches_jax(self):
        a, r, m = _points(4)
        gj, gt = _metrics("kerr", a, r, m)
        rng = np.random.default_rng(5)
        U, V = rng.normal(size=(N, 4)), rng.normal(size=(N, 4))
        tU, tV = torch.from_numpy(U), torch.from_numpy(V)
        _close(tcore.vector_covariant(tU, gt), jcore.vector_covariant(U, gj))
        _close(tcore.dotprod(tU, tV, gt), jcore.dotprod(U, V, gj))
        _close(tcore.dotprod(tU, tV), jcore.dotprod(U, V))

    def test_tetrad_frames_match_jax(self):
        a, r, m = _points(6)
        gj, gt = _metrics("kerr", a, r, m)
        Tj, Tt = jcore.tetrad_zamo(gj), tcore.tetrad_zamo(gt)
        _close(Tt.e, Tj.e)
        rng = np.random.default_rng(7)
        v = rng.normal(size=(N, 4))
        _close(tcore.on2bl(v, Tt), jcore.on2bl(v, Tj))
        _close(tcore.bl2on(v, Tt), jcore.bl2on(v, Tj))
        # round trip, as test_core checks for the JAX package
        _close(tcore.bl2on(tcore.on2bl(v, Tt), Tt), v, rtol=1e-10, atol=1e-10)

    def test_photon_carter_and_r_bh_match_jax(self):
        a, r, m = _points(8)
        gj, gt = _metrics("kerr", a, r, m)
        k = np.random.default_rng(9).normal(size=(N, 4))
        _close(tcore.photon_carter_const(torch.from_numpy(k), gt),
               jcore.photon_carter_const(k, gj))
        _close(tcore.r_bh(torch.from_numpy(a)), jcore.r_bh(a))

    def test_dtype_and_device_follow_inputs(self):
        a, r, m = (torch.tensor(v, dtype=torch.float32) for v in (0.5, 7.0, 0.2))
        g = tcore.kerr_metric(a, r, m)
        assert g.g00.dtype == torch.float32 and g.g00.device == r.device
        assert tcore.r_bh(a).dtype == torch.float32
        e, _ = tmetric._kerr_conn_entries(0.5, r, m)
        assert all(v.dtype == torch.float32 for v in e.values())
        assert torch.get_default_dtype() == torch.float32
        # with no tensor among the inputs, new data goes to the card
        assert tmetric.default_device() == torch.device("cuda")
        assert tmetric.default_device("cpu") == torch.device("cpu")
        assert tmetric._as_tensors(0.5, device="cpu")[0].device.type == "cpu"


class TestGolden:
    """The port against the C reference (tests/golden/kerr.txt)."""

    def test_golden_metric(self, golden_kerr):
        d = golden_kerr["metric"]
        g = tcore.kerr_metric(*_cpu(d[:, 0], d[:, 1], d[:, 2]))
        _close(torch.stack([getattr(g, f) for f in FIELDS], -1), d[:, 3:8])

    def test_golden_connection(self, golden_kerr):
        d = golden_kerr["conn"]
        e, _ = tmetric._kerr_conn_entries(*_cpu(d[:, 0], d[:, 1], d[:, 2]))
        # the golden holds the 40 upper-triangle Gamma^i_{jk} (j<=k)
        idx = [(i, j, k) for i in range(4) for j in range(4) for k in range(j, 4)]
        zero = torch.zeros(len(d), dtype=torch.float64)
        got = torch.stack([e.get(key, zero) for key in idx], -1)
        _close(got, d[:, 3:43], rtol=1e-10, atol=1e-11)

    def test_golden_zamo(self, golden_kerr):
        d = golden_kerr["tzamo"]
        t = tcore.tetrad_zamo(tcore.kerr_metric(*_cpu(d[:, 0], d[:, 1], d[:, 2])))
        _close(t.e.reshape(len(d), 16), d[:, 3:19])

    def test_golden_carter(self, golden_kerr):
        d = golden_kerr["carter"]
        dm = golden_kerr["pmom"]
        g = tcore.kerr_metric(*_cpu(d[:, 0], d[:, 1], d[:, 2]))
        _close(tcore.photon_carter_const(torch.from_numpy(dm[:, 5:9]), g),
               d[:, 3], rtol=1e-9)

    def test_golden_photon_momentum(self, golden_kerr):
        d = golden_kerr["pmom"]
        k = tcore.photon_momentum(*_cpu(*(d[:, i] for i in range(5))),
                                  1.0, -1.0)
        _close(k, d[:, 5:9], rtol=1e-10)

    def test_golden_photon_motion_constants(self, golden_kerr):
        d = golden_kerr["pmc"]
        dm = golden_kerr["pmom"]
        l, q = tcore.photon_motion_constants(*_cpu(dm[:, 0], dm[:, 1],
                                                   dm[:, 2], dm[:, 5:9]))
        _close(l, d[:, 3], rtol=1e-8)
        _close(q, d[:, 4], rtol=1e-8)

    def test_golden_r_bh(self, golden_kerr):
        d = golden_kerr["orbit"]
        _close(tcore.r_bh(torch.from_numpy(d[:, 0])), d[:, 1])
