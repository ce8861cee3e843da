"""The port's geodesic setup from a point (`geodesic_init_src`), the sign of
k^theta (`geodesic_position_pol_sign_k_theta`) and the affine-step
follower (`geodesic_follow`) of `sim5_tpu_torch.geodesic`, against
`sim5_tpu` on the same inputs, on the CPU in f64.

Tolerances, and why:
* the round trip init_inf -> crossing -> momentum -> init_src:
  tests/test_geodesic.py's own (motion constants and theta roots rtol
  1e-6, atol 1e-8; cos_i within 1e-5 on > 95% of the rays);
* init_src against JAX: l, q, m2p, m2m, mK and Tpp relative 1e-12 (the
  same f64 algebra); cos_i, alpha, beta and Tip within 1e-10 (an inverse
  of an elliptic integral near a turning point amplifies an ulp);
  status equal;
* geodesic_follow against JAX: P, r and m relative 1e-12, status equal
  (the same substeps; the port leaves the loop when no lane is active);
* the sign of k^theta: equal.
"""

import math

import numpy as np
import torch

from sim5_tpu import geodesic as jgd
from sim5_tpu import core as jcore
from sim5_tpu_torch import geodesic as tgd

torch.set_num_threads(2)


def _t(v):
    return torch.from_numpy(np.array(v, dtype=np.float64))


def _rel(got, want, rtol, atol=0.0, name=""):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    assert (np.isfinite(got) == np.isfinite(want)).all(), name
    f = np.isfinite(want)
    err = np.abs(got[f] - want[f])
    assert (err <= atol + rtol * np.abs(want[f])).all(), (
        f"{name}: max abs {err.max():.3e}, max rel "
        f"{(err / (np.abs(want[f]) + 1e-300)).max():.3e}")


def _src_inputs():
    """(a, r, m, k, ppc): the crossings of 128 random rays (the round trip's
    rays, ppc from the turning point) and 32 vortical (q < 0) points off
    the equator with both signs of k^r and k^theta, as numpy f64."""
    n = 128
    rng = np.random.default_rng(17)
    a = rng.uniform(0.1, 0.95, n)
    inc = np.radians(rng.uniform(25, 80, n))
    alpha = rng.uniform(-12, 12, n)
    beta = rng.uniform(0.5, 10, n) * np.sign(rng.uniform(-1, 1, n))
    g = jgd.geodesic_init_inf(inc, a, alpha, beta)
    P = np.asarray(jgd.geodesic_find_midplane_crossing(g, 0))
    r = np.asarray(jgd.geodesic_position_rad(g, P))
    ok = (np.asarray(g.status) == 0) & np.isfinite(P) & np.isfinite(r)
    ppc = ((P > np.asarray(g.Rpc)) & ok).astype(int)
    r_s = np.where(ok, r, 10.0)
    m_s = np.zeros(n)
    k = np.asarray(jgd.geodesic_momentum(g, np.where(ok, P, 1.0), r_s, m_s))
    k = np.where((ok & np.isfinite(k).all(1))[:, None], k, 1.0)
    # vortical points: M(m) = q - l^2 m^2 / (1 - m^2) + a^2 m^2 > 0 with
    # q < 0 needs |l| small and |m| large
    nv = 32
    av = np.full(nv, 0.9)
    rv = rng.uniform(3.0, 20.0, nv)
    mv = rng.uniform(0.6, 0.85, nv) * np.where(np.arange(nv) % 2, 1.0, -1.0)
    lv = rng.uniform(-0.2, 0.2, nv)
    qv = -rng.uniform(0.01, 0.1, nv)
    rsign = np.where(np.arange(nv) % 4 < 2, -1.0, 1.0)
    msign = np.where(np.arange(nv) % 3 == 0, -1.0, 1.0)
    kv = np.asarray(jcore.photon_momentum(av, rv, mv, lv, qv, rsign, msign))
    assert np.isfinite(kv).all()
    return (np.concatenate([a, av]), np.concatenate([r_s, rv]),
            np.concatenate([m_s, mv]), np.concatenate([k, kv]),
            np.concatenate([ppc, (rsign > 0).astype(int)]), ok)


class TestInitSrc:
    def test_roundtrip_reproduces_observer(self):
        """tests/test_geodesic.py's round trip on the port (n = 128, seed
        17, its tolerances)."""
        n = 128
        rng = np.random.default_rng(17)
        a = rng.uniform(0.1, 0.95, n)
        inc = np.radians(rng.uniform(25, 80, n))
        alpha = rng.uniform(-12, 12, n)
        beta = rng.uniform(0.5, 10, n) * np.sign(rng.uniform(-1, 1, n))
        g = tgd.geodesic_init_inf(_t(inc), _t(a), _t(alpha), _t(beta))
        P = tgd.geodesic_find_midplane_crossing(g, 0)
        r = tgd.geodesic_position_rad(g, P)
        ok = (g.status == 0) & torch.isfinite(P) & torch.isfinite(r)
        ppc = (P > g.Rpc) & ok
        r_s = torch.where(ok, r, 10.0)
        m_s = torch.zeros(n, dtype=torch.float64)
        k = tgd.geodesic_momentum(g, torch.where(ok, P, 1.0), r_s, m_s)
        ok = ok & torch.isfinite(k).all(1)
        g2 = tgd.geodesic_init_src(_t(a), r_s, m_s,
                                   torch.where(ok[:, None], k, 1.0),
                                   ppc.to(torch.int64))
        ok = (ok & (g2.status == 0)).numpy()
        assert ok.mean() > 0.5
        for field in ("l", "q", "m2p", "m2m", "mK"):
            v1 = getattr(g, field).numpy()[ok]
            v2 = getattr(g2, field).numpy()[ok]
            np.testing.assert_allclose(v2, v1, rtol=1e-6, atol=1e-8,
                                       err_msg=field)
        match = np.isclose(g2.cos_i.numpy()[ok], g.cos_i.numpy()[ok],
                           atol=1e-5)
        assert match.mean() > 0.95, f"cos_i roundtrip {match.mean():.3f}"

    def test_against_jax(self):
        a, r, m, k, ppc, _ = _src_inputs()
        gj = jgd.geodesic_init_src(a, r, m, k, ppc)
        gt = tgd.geodesic_init_src(_t(a), _t(r), _t(m), _t(k),
                                   torch.from_numpy(ppc))
        st = np.asarray(gj.status)
        assert np.array_equal(gt.status.numpy(), st)
        qneg = (np.asarray(gj.q) < 0.0) & (st == 0)
        assert qneg.sum() >= 16, "the vortical lanes must set up"
        assert ((np.asarray(gj.q) > 0.0) & (st == 0)).sum() >= 64
        live = st == 0
        for field in ("l", "q", "m2p", "m2m", "mK", "Tpp"):
            _rel(getattr(gt, field).numpy()[live],
                 np.asarray(getattr(gj, field))[live], 1e-12, 1e-300,
                 field)
        for field in ("cos_i", "alpha", "beta", "Tip"):
            _rel(getattr(gt, field).numpy()[live],
                 np.asarray(getattr(gj, field))[live], 0.0, 1e-10, field)
        assert gt.a.dtype == torch.float64 and gt.status.dtype == torch.int32


def _follow_setup():
    """64 rays at a = 0.7, 50 deg from r = 5-50 on the way in, with
    forward and backward steps of 0.05-20 affine units; the first four
    are captured rays started at r = 1.8 that reach the horizon."""
    n = 64
    rng = np.random.default_rng(11)
    alpha = rng.uniform(-8, 8, n)
    beta = rng.uniform(-8, 8, n)
    alpha[:4], beta[:4] = [1.0, -1.0, 0.5, -0.5], [1.0, 0.5, -1.0, -0.5]
    incl = math.radians(50.0)
    r0 = rng.uniform(5.0, 50.0, n)
    r0[:4] = 1.8
    step = rng.uniform(0.05, 20.0, n) * np.where(np.arange(n) % 3 == 1,
                                                  -1.0, 1.0)
    step[:4] = 20.0
    return incl, 0.7, alpha, beta, r0, step


class TestFollow:
    def test_against_jax(self):
        incl, a, alpha, beta, r0, step = _follow_setup()
        gj = jgd.geodesic_init_inf(incl, a, alpha, beta)
        gt = tgd.geodesic_init_inf(incl, a, _t(alpha), _t(beta))
        P0 = np.asarray(jgd.geodesic_P_int(gj, r0, 0))
        P0 = np.where(np.isfinite(P0), P0, 1e-3)
        rr = np.asarray(jgd.geodesic_position_rad(gj, P0))
        mm = np.asarray(jgd.geodesic_position_pol(gj, P0))
        seen = set()
        for ns in (2, 12):
            Pj, rj, mj, sj = map(np.asarray, jgd.geodesic_follow(
                gj, step, P0, rr, mm, max_substeps=ns))
            Pt, rt, mt, s_t = tgd.geodesic_follow(
                gt, _t(step), _t(P0), _t(rr), _t(mm), max_substeps=ns)
            assert np.array_equal(s_t.numpy(), sj)
            _rel(Pt, Pj, 1e-12, 0.0, f"P ({ns} substeps)")
            _rel(rt, rj, 1e-12, 0.0, f"r ({ns} substeps)")
            _rel(mt, mj, 1e-12, 1e-15, f"m ({ns} substeps)")
            seen |= set(sj.tolist())
        assert seen == {tgd.FOLLOW_STOPPED, tgd.FOLLOW_OK,
                        tgd.FOLLOW_NOT_CONVERGED}

    def test_pol_sign_k_theta_against_jax(self):
        incl, a, alpha, beta, r0, _ = _follow_setup()
        gj = jgd.geodesic_init_inf(incl, a, alpha, beta)
        gt = tgd.geodesic_init_inf(incl, a, _t(alpha), _t(beta))
        P = (np.asarray(gj.Rpc)[:, None]
             * np.linspace(0.05, 1.95, 9)[None, :])
        P[0, 0] = np.nan
        sj = np.asarray(jgd.geodesic_position_pol_sign_k_theta(
            jgd.geodesic_init_inf(incl, a, alpha[:, None], beta[:, None]),
            P))
        ge = tgd.geodesic_init_inf(incl, a, _t(alpha)[:, None],
                                   _t(beta)[:, None])
        st = tgd.geodesic_position_pol_sign_k_theta(ge, _t(P)).numpy()
        assert np.array_equal(np.isnan(st), np.isnan(sj))
        assert np.array_equal(st[~np.isnan(sj)], sj[~np.isnan(sj)])
        assert {-1.0, 1.0} <= set(st[~np.isnan(st)].tolist())
        assert gt.a.shape == (64,)

    def test_small_step_ok(self):
        """tests/test_geodesic.py TestFollow on the port."""
        g = tgd.geodesic_init_inf(math.radians(60.0), 0.5, _t(4.0), _t(2.0))
        P0 = tgd.geodesic_P_int(g, 1000.0, 0)
        r0 = tgd.geodesic_position_rad(g, P0)
        m0 = tgd.geodesic_position_pol(g, P0)
        P, r, m, st = tgd.geodesic_follow(g, 1.0, P0, r0, m0)
        assert int(st) == tgd.FOLLOW_OK
        assert float(r) < float(r0)  # moving inward

    def test_huge_step_reports_not_converged(self):
        g = tgd.geodesic_init_inf(math.radians(60.0), 0.5, _t(4.0), _t(2.0))
        P0 = tgd.geodesic_P_int(g, 1000.0, 0)
        r0 = tgd.geodesic_position_rad(g, P0)
        m0 = tgd.geodesic_position_pol(g, P0)
        # the substep is at most 5e-2 sqrt(r) ~ 1.6 at r = 1000: 64
        # substeps cover ~100 affine units at most; ask for 1e4
        P, r, m, st = tgd.geodesic_follow(g, 1e4, P0, r0, m0)
        assert int(st) == tgd.FOLLOW_NOT_CONVERGED
        P2, r2, m2, st2 = tgd.geodesic_follow(g, 1e4, P0, r0, m0,
                                              max_substeps=256)
        assert float(P2) > float(P)
