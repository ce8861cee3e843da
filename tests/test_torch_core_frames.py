"""The rest of the port's spacetime core -- the contravariant and
Kerr-Newman metrics, the dense connection, the vector helpers, the
observer tetrads, the checked photon momentum and the 4-velocities -- and
`utils.math`, against the C-reference goldens (tests/golden/kerr.txt) and
against `sim5_tpu` on the same numpy-seeded inputs.

Tolerances, and why:
* against JAX: relative 1e-12 (atol 1e-13 for entries near zero) -- the
  same f64 algebra, differing by a few roundings;
* the goldens imetric, conn, tazm and tsurf: relative 1e-12 (atol
  1e-13), as for the covariant metric in test_torch_core.py;
* utils.math: relative 1e-15 (one or two roundings).
"""

import numpy as np
import torch

from sim5_tpu import core as jcore
from sim5_tpu.utils import math as jmath
from sim5_tpu_torch import core as tcore
from sim5_tpu_torch.utils import math as tmath

torch.set_num_threads(2)

N = 64
FIELDS = ("g00", "g11", "g22", "g33", "g03")


def _close(got, want, rtol=1e-12, atol=1e-13, same_nan=True):
    """Relative agreement, with `atol` for entries near zero, where the
    reference is finite; with `same_nan`, NaN exactly where it is NaN."""
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    finite = np.isfinite(want)
    assert not same_nan or (np.isfinite(got) == finite).all()
    got, want = got[finite], want[finite]
    assert np.allclose(got, want, rtol=rtol, atol=atol), (
        f"max abs diff {np.max(np.abs(got - want)):.3e}, max rel diff "
        f"{np.max(np.abs(got - want) / (np.abs(want) + 1e-300)):.3e}")


def _t(*arrays):
    """numpy arrays as CPU tensors (the port's default device is the card)."""
    out = [torch.from_numpy(np.array(v, dtype=np.float64))
           for v in arrays]
    return out[0] if len(out) == 1 else out


def _points(seed, n=N):
    rng = np.random.default_rng(seed)
    return (rng.uniform(0.05, 0.999, n), rng.uniform(2.5, 40.0, n),
            rng.uniform(-0.95, 0.95, n))


def _fields(g):
    return np.stack([np.asarray(getattr(g, f)) for f in FIELDS], -1)


def _tfields(g):
    return torch.stack([getattr(g, f) for f in FIELDS], -1)


class TestGolden:
    """The port against the C reference (tests/golden/kerr.txt)."""

    def test_golden_contravariant_metric(self, golden_kerr):
        d = golden_kerr["imetric"]
        g = tcore.kerr_metric_contravariant(*_t(d[:, 0], d[:, 1], d[:, 2]))
        _close(_tfields(g), d[:, 3:8])

    def test_golden_dense_connection(self, golden_kerr):
        d = golden_kerr["conn"]
        G = tcore.kerr_connection(*_t(d[:, 0], d[:, 1], d[:, 2]))
        assert G.shape == (len(d), 4, 4, 4)
        idx = [(i, j, k) for i in range(4) for j in range(4)
               for k in range(j, 4)]
        got = torch.stack([G[:, i, j, k] for (i, j, k) in idx], -1)
        _close(got, d[:, 3:43])
        # symmetric in the lower pair
        assert torch.equal(G, G.transpose(-1, -2))

    def test_golden_azimuthal_tetrad(self, golden_kerr):
        d = golden_kerr["tazm"]
        g = tcore.kerr_metric(*_t(d[:, 0], d[:, 1], d[:, 2]))
        t = tcore.tetrad_azimuthal(g, _t(d[:, 3]))
        _close(t.e.reshape(len(d), 16), d[:, 4:20])

    def test_golden_surface_tetrad(self, golden_kerr):
        d = golden_kerr["tsurf"]
        g = tcore.kerr_metric(*_t(d[:, 0], d[:, 1], d[:, 2]))
        t = tcore.tetrad_surface(g, _t(d[:, 3]), 0.1, 0.05)
        # where the C reference's observer cannot be normalized it is NaN;
        # the port, as the JAX package, leaves the vector unscaled there
        # (vector_norm_to), and tetrad_valid flags the lane
        _close(t.e.reshape(len(d), 16), d[:, 4:20], same_nan=False)
        nan_rows = np.isnan(d[:, 4:20]).any(-1)
        assert nan_rows.any()
        assert not bool(tcore.tetrad_valid(t)[torch.from_numpy(nan_rows)]
                        .any())


class TestMetricsAgainstJax:
    """Metrics, connections and the vector helpers against sim5_tpu."""

    def test_contravariant_metrics(self):
        a, r, m = _points(10)
        _close(_tfields(tcore.kerr_metric_contravariant(*_t(a, r, m))),
               _fields(jcore.kerr_metric_contravariant(a, r, m)))
        _close(_tfields(tcore.flat_metric_contravariant(*_t(r, m))),
               _fields(jcore.flat_metric_contravariant(r, m)))

    def test_kerr_newman(self):
        a, r, m = _points(11)
        Q = np.random.default_rng(12).uniform(0.0, 0.4, N)
        for fj, ft in ((jcore.kerr_newman_metric, tcore.kerr_newman_metric),
                       (jcore.kerr_newman_metric_contravariant,
                        tcore.kerr_newman_metric_contravariant)):
            _close(_tfields(ft(*_t(a, Q, r, m))), _fields(fj(a, Q, r, m)))
        _close(tcore.kerr_newman_connection(*_t(a, Q, r, m)),
               jcore.kerr_newman_connection(a, Q, r, m))
        # Q = 0 is Kerr, but for Gamma^t_{r phi}: the JAX package's
        # Kerr-Newman form of it (sim5kerr.c:321-400) does not reduce to
        # its Kerr form (0.6% apart at a = 0.7, r = 5), and the port keeps
        # the reference's algebra
        kn = tcore.kerr_newman_connection(*_t(a, 0 * Q, r, m))
        kerr = tcore.kerr_connection(*_t(a, r, m))
        keep = torch.ones(4, 4, 4, dtype=torch.bool)
        keep[0, 1, 3] = keep[0, 3, 1] = False
        _close(kn[:, keep], kerr[:, keep].numpy())

    def test_dense_connections(self):
        a, r, m = _points(13)
        _close(tcore.kerr_connection(*_t(a, r, m)),
               jcore.kerr_connection(a, r, m))
        _close(tcore.flat_connection(*_t(r, m)), jcore.flat_connection(r, m))

    def test_gamma_and_geodesic_accel(self):
        a, r, m = _points(14)
        rng = np.random.default_rng(15)
        U, V = rng.normal(size=(N, 4)), rng.normal(size=(N, 4))
        Gj = jcore.kerr_connection(a, r, m)
        Gt = tcore.kerr_connection(*_t(a, r, m))
        _close(tcore.Gamma(Gt, *_t(U, V)), jcore.Gamma(Gj, U, V))
        _close(tcore.geodesic_accel(Gt, _t(U)), jcore.geodesic_accel(Gj, U))
        # the dense contraction equals the sparse one the march uses
        _close(tcore.geodesic_accel(Gt, _t(U)),
               tcore.kerr_transport_accel(*_t(a, r, m, U, U)))

    def test_vector_helpers(self):
        a, r, m = _points(16)
        gj = jcore.kerr_metric(a, r, m)
        gt = tcore.kerr_metric(*_t(a, r, m))
        rng = np.random.default_rng(17)
        V = rng.normal(size=(N, 4))
        V[:, 0] *= 0.1             # mostly space-like
        tV = _t(V)
        _close(tcore.vector(*_t(V[:, 0], V[:, 1], V[:, 2], V[:, 3])),
               jcore.vector(V[:, 0], V[:, 1], V[:, 2], V[:, 3]))
        for metric_j, metric_t in ((gj, gt), (None, None)):
            _close(tcore.vector_norm(tV, metric_t),
                   jcore.vector_norm(V, metric_j))
            for norm in (1.0, -1.0):   # each sign leaves some lanes unscaled
                _close(tcore.vector_norm_to(tV, norm, metric_t),
                       jcore.vector_norm_to(V, norm, metric_j))
            V0 = rng.uniform(0.5, 2.0, N)
            _close(tcore.vector_norm_to_null(tV, _t(V0), metric_t),
                   jcore.vector_norm_to_null(V, V0, metric_j))
        _close(tcore.vector_3norm(tV), jcore.vector_3norm(V))
        null = tcore.vector_norm_to_null(tV, 1.0, gt)
        assert float(tcore.dotprod(null, null, gt).abs().max()) < 1e-10
        assert torch.equal(null[:, 0], torch.ones(N, dtype=torch.float64))


def _observers(seed):
    """Kerr points with sub-luminal Keplerian-like rotation, a radial drift
    and a surface slope."""
    a, r, m = _points(seed)
    rng = np.random.default_rng(seed + 100)
    Om = 1.0 / (r ** 1.5 + a) * rng.uniform(0.2, 1.0, N)
    Om[::7] = 0.0                  # the ZAMO branch of tetrad_azimuthal
    vr = rng.uniform(-0.05, 0.05, N)
    vr[::5] = 0.0                  # the ZAMO branch of tetrad_radial
    return a, r, m, Om, vr, rng.uniform(-0.3, 0.3, N)


class TestFramesAgainstJax:
    """Tetrads, momenta and 4-velocities against sim5_tpu."""

    def test_tetrads(self):
        a, r, m, Om, vr, dhdr = _observers(20)
        gj = jcore.kerr_metric(a, r, m)
        gt = tcore.kerr_metric(*_t(a, r, m))
        _close(tcore.tetrad_azimuthal(gt, _t(Om)).e,
               jcore.tetrad_azimuthal(gj, Om).e)
        _close(tcore.tetrad_radial(gt, _t(vr)).e,
               jcore.tetrad_radial(gj, vr).e)
        V = np.where(np.arange(N) % 3 == 0, 0.0, 0.02)
        tj = jcore.tetrad_surface(gj, Om, V, dhdr)
        tt = tcore.tetrad_surface(gt, *_t(Om, V, dhdr))
        _close(tt.e, tj.e)
        assert bool(tcore.tetrad_valid(tt).all())

    def test_tetrad_general_and_valid(self):
        a, r, m, Om, vr, _ = _observers(21)
        gj = jcore.kerr_metric(a, r, m)
        gt = tcore.kerr_metric(*_t(a, r, m))
        Uj = jcore.fourvelocity_azimuthal(Om, gj)
        Ut = tcore.fourvelocity_azimuthal(_t(Om), gt)
        _close(Ut, Uj)
        tj, tt = jcore.tetrad_general(gj, Uj), tcore.tetrad_general(gt, Ut)
        _close(tt.e, tj.e)
        # orthonormal: eta_(ab) = e_(a).e_(b), e3 the corrected one
        eta = torch.stack([torch.stack([tcore.dotprod(tt.e[:, i], tt.e[:, j],
                                                      gt) for j in range(4)],
                                       -1) for i in range(4)], -2)
        _close(eta, np.broadcast_to(np.diag([-1.0, 1, 1, 1]), (N, 4, 4)),
               rtol=1e-10, atol=1e-10)
        ok_t = tcore.tetrad_valid(tt)
        ok_j = np.asarray(jcore.tetrad_valid(tj))
        assert (ok_t.numpy() == ok_j).all() and ok_j.all()
        # a superluminal Omega inside the ergosphere fails validity in both
        bad_a, bad_r = np.full(4, 0.99), np.full(4, 1.5)
        bad_m, bad_O = np.zeros(4), np.full(4, 2.0)
        tb = tcore.tetrad_azimuthal(tcore.kerr_metric(*_t(bad_a, bad_r,
                                                           bad_m)), _t(bad_O))
        jb = jcore.tetrad_azimuthal(jcore.kerr_metric(bad_a, bad_r, bad_m),
                                    bad_O)
        assert (tcore.tetrad_valid(tb).numpy()
                == np.asarray(jcore.tetrad_valid(jb))).all()
        assert not bool(tcore.tetrad_valid(tb).any())

    def test_photon_momentum_checked(self, golden_kerr):
        d = golden_kerr["pmom"]
        rng = np.random.default_rng(22)
        n = len(d)
        # the golden's rays, and the same with (l, q) pushed out of range
        l = np.concatenate([d[:, 3], d[:, 3] * rng.uniform(1.0, 3.0, n)])
        q = np.concatenate([d[:, 4], d[:, 4] * rng.uniform(0.0, 3.0, n)])
        a, r, m = (np.tile(d[:, i], 2) for i in range(3))
        rs, ms = rng.choice([-1.0, 1.0], 2 * n), rng.choice([-1.0, 1.0], 2 * n)
        kj, vj = jcore.photon_momentum_checked(a, r, m, l, q, rs, ms)
        kt, vt = tcore.photon_momentum_checked(*_t(a, r, m, l, q, rs, ms))
        _close(kt, kj)
        assert (vt.numpy() == np.asarray(vj)).all()
        assert 0 < int(vt.sum()) < 2 * n and bool(torch.isfinite(kt).all())
        # valid lanes are photon_momentum's
        k = tcore.photon_momentum(*_t(a, r, m, l, q, rs, ms))
        assert torch.equal(k[vt], kt[vt])

    def test_fourvelocities(self):
        a, r, m, Om, vr, _ = _observers(23)
        gj = jcore.kerr_metric(a, r, m)
        gt = tcore.kerr_metric(*_t(a, r, m))
        _close(tcore.fourvelocity_zamo(gt), jcore.fourvelocity_zamo(gj))
        _close(tcore.fourvelocity_azimuthal(_t(Om), gt),
               jcore.fourvelocity_azimuthal(Om, gj))
        _close(tcore.fourvelocity_radial(_t(vr), gt),
               jcore.fourvelocity_radial(vr, gj))
        rng = np.random.default_rng(24)
        U1, U2, U3 = (rng.uniform(-0.05, 0.05, N) for _ in range(3))
        Ut = tcore.fourvelocity(*_t(U1, U2, U3), gt)
        _close(Ut, jcore.fourvelocity(U1, U2, U3, gj))
        _close(tcore.dotprod(Ut, Ut, gt), -np.ones(N), rtol=1e-10)


class TestMathAgainstJax:
    """utils.math against sim5_tpu.utils.math."""

    def test_helpers(self):
        rng = np.random.default_rng(30)
        x = rng.normal(scale=10.0, size=N)
        x[:4] = (0.0, -0.0, -0.5, -1.5)
        tx = _t(x)
        for name in ("sqr", "sqr3", "sqr4", "sign", "deg2rad", "rad2deg",
                     "reduce_angle_pi", "reduce_angle_2pi"):
            got = getattr(tmath, name)(tx)
            assert got.dtype == torch.float64, name
            _close(got, getattr(jmath, name)(x), rtol=1e-15, atol=0.0)
        assert (tmath.sim5round(tx).numpy()
                == np.asarray(jmath.sim5round(x))).all()
        assert tmath.sim5round(tx).dtype == torch.int64
        xc, ok = tmath.ensure_range(tx, -5.0, 5.0, 1.0)
        xj, okj = jmath.ensure_range(x, -5.0, 5.0, 1.0)
        _close(xc, xj, rtol=0.0, atol=0.0)
        assert (ok.numpy() == np.asarray(okj)).all()

    def test_coordinates(self):
        rng = np.random.default_rng(31)
        x, y, z, Vx, Vy, Vz = rng.normal(size=(6, N))
        x[0] = y[0] = 0.0          # on the z-axis: the phi = 0 convention
        for got, want in zip(
                tmath.cartesian_to_spherical(*_t(x, y, z)),
                jmath.cartesian_to_spherical(x, y, z)):
            _close(got, want, rtol=1e-15, atol=1e-15)
        rr, th, ph = jmath.cartesian_to_spherical(x, y, z)
        for got, want in zip(
                tmath.spherical_to_cartesian(*_t(rr, th, ph)),
                jmath.spherical_to_cartesian(rr, th, ph)):
            _close(got, want, rtol=1e-15, atol=1e-15)
        for got, want in zip(
                tmath.cartesian_vector_to_spherical(*_t(x, y, z, Vx, Vy, Vz)),
                jmath.cartesian_vector_to_spherical(x, y, z, Vx, Vy, Vz)):
            _close(got, want, rtol=1e-15, atol=1e-15)
        ch, sf, cf = np.cos(th), np.sin(ph), np.cos(ph)
        for got, want in zip(
                tmath.cartesian_vector_to_spherical_at(*_t(ch, sf, cf, Vx, Vy,
                                                           Vz)),
                jmath.cartesian_vector_to_spherical_at(ch, sf, cf, Vx, Vy,
                                                       Vz)):
            _close(got, want, rtol=1e-15, atol=1e-15)
