"""The port's travel time (`geodesic_timedelay`, `geodesic_timedelay_full`
and their parts `_theta_time_cum` and `_cc_time_radial`) against the C
golden (tests/golden/timedelay.txt), the JAX package, and the port's own
f64 stepwise march, which also holds the azimuth along the same rays; the
azimuth against its C golden (the `gpos` samples of geod.txt), and the
T-integral `_theta_int` against the JAX package.  (The azimuth against
the JAX package is test_torch_azimuth.py.)

Tolerances, and why:
* the goldens: `test_geodesic.py`'s rules: for the time, at least 95% of
  the rays within rtol 1e-5, atol 1e-7, and finiteness agreeing on at
  least 95%; for phi, at least 97% within rtol 1e-4, atol 1e-6 (the
  reference truncates its theta fold after one oscillation; the port
  folds fully);
* `_theta_int`: relative 1e-12 (one icn, the same f64 operations);
* `_theta_time_cum` against the jitted JAX function: per lane
  8 sqrt(eps) a m2p / sqrt(m2m + m2p) + 1e-12 (1 + |t|).  The poloidal
  time a integral_T_m2 at x = b cn(dT/mK), b = sqrt(m2p), has the same
  square-root turning point as the azimuth's theta term (see
  test_torch_azimuth.py): its integrand goes as
  b^2 / (sqrt(a^2 + b^2) sqrt(2b (b - x))) there, so a one-ulp
  difference in cn (XLA's fused sin/cos) moves it by about sqrt(eps)
  a m2p / sqrt(m2m + m2p);
* `_cc_time_radial` against the jitted JAX function: relative 1e-12 (a
  96-node Gauss sum of smooth terms, summed in another order);
* the march oracle (`test_geodesic.py` TestTimedelayFull and
  TestFullTypeSurface at the port's own engine): |dt - t_march| and
  |dphi - phi_march| below 2e-3 * max(1, |t_march|) and
  2e-3 * max(1, |phi_march|), the march's step error at precision 0.003.
"""

import dataclasses

import jax
import numpy as np
import torch

from sim5_tpu import geodesic as jgd
from sim5_tpu.geodesic import analytic as jan
from sim5_tpu_torch import geodesic as tgd
from sim5_tpu_torch.geodesic import analytic as tan
from sim5_tpu_torch.march import raytrace_prepare, raytrace_step

torch.set_num_threads(2)


def _t(v):
    return torch.tensor(np.asarray(v), dtype=torch.float64)


def test_timedelay_golden():
    import pathlib
    rows = [[float(v) for v in line.split()[1:]] for line in
            (pathlib.Path(__file__).parent / "golden" / "timedelay.txt")
            .read_text().splitlines() if line.startswith("td ")]
    d = np.asarray(rows)
    # columns: a inc alpha beta P1 r1 m1 P2 r2 dt
    g = tgd.geodesic_init_inf(*(_t(d[:, i]) for i in (1, 0, 2, 3)))
    dt = tgd.geodesic_timedelay(g, _t(d[:, 4]), _t(d[:, 5]), _t(d[:, 6]),
                                _t(d[:, 7]), _t(d[:, 8]),
                                torch.zeros(len(d), dtype=torch.float64))
    dt, ref = dt.numpy(), d[:, 9]
    both = np.isfinite(ref) & np.isfinite(dt)
    assert (np.isfinite(ref) == np.isfinite(dt)).mean() > 0.95
    ok = np.isclose(dt[both], ref[both], rtol=1e-5, atol=1e-7)
    assert ok.mean() > 0.95, f"{(~ok).sum()}/{ok.size} mismatches"


def _records():
    """The `gpos` samples of the geodesics the reference initialized:
    (a, incl, alpha, beta, P, phi) rows."""
    import pathlib
    rows, cur = [], None
    path = pathlib.Path(__file__).parent / "golden" / "geod.txt"
    for line in path.read_text().splitlines():
        parts = line.split()
        if not parts:
            continue
        vals = [float(v) for v in parts[1:]]
        if parts[0] == "ginit":
            cur = vals if vals[4] == 1 else None
        elif parts[0] == "gpos" and cur is not None:
            rows.append(cur[:4] + [vals[0], vals[3]])
    return np.asarray(rows)


def test_phi_against_c_golden():
    d = _records()
    g = tgd.geodesic_init_inf(*(torch.tensor(d[:, i]) for i in (1, 0, 2, 3)))
    P = torch.tensor(d[:, 4])
    r = tgd.geodesic_position_rad(g, P)
    m = tgd.geodesic_position_pol(g, P)
    phi = tgd.geodesic_position_azm(g, r, m, P).numpy()
    ok = (np.isfinite(d[:, 5]) & np.isfinite(phi) & np.isfinite(r.numpy())
          & np.isfinite(m.numpy()))
    assert ok.sum() > 100
    frac = np.isclose(phi[ok], d[ok, 5], rtol=1e-4, atol=1e-6).mean()
    assert frac > 0.97, f"azm agreement only {frac:.3f}"


def _geodesics():
    """An image grid (a = 0.9, i = 70 deg) and the vortical rays near the
    image centre at a = 0.5, i = 60 deg (CC and RC), 1-D."""
    al, be = np.meshgrid(np.linspace(-7.0, 7.0, 8), np.linspace(-6.0, 6.0, 4))
    ca = np.array([-0.45, -0.4, -0.35, -0.3, -0.3, -0.25, 0.2, 0.1])
    cb = np.array([0.05, 0.1, 0.0, 0.124375, -0.124375, 0.05, 0.1, -0.05])
    n1, n2 = al.size, ca.size
    return tgd.geodesic_init_inf(
        _t(np.r_[np.full(n1, np.radians(70.0)), np.full(n2, np.radians(60.0))]),
        _t(np.r_[np.full(n1, 0.9), np.full(n2, 0.5)]),
        _t(np.r_[al.ravel(), ca]), _t(np.r_[be.ravel(), cb]))


class TestThetaTime:
    def test_theta_int_matches_jax(self):
        """`_theta_int` (the T-integral from m to mu_plus) at the m of
        random positions of the q > 0 rays."""
        g = _geodesics()
        ok = (g.q > 0.0) & (g.status == 0)
        sub = {f: v[ok.numpy()] for f, v in g.numpy().items()}
        gs = tgd.Geodesic.from_numpy(sub, device="cpu")
        P = _t(np.random.default_rng(8).uniform(0.05, 1.9, len(sub["q"]))
               * sub["Rpc"])
        m = tgd.geodesic_position_pol(gs, P)
        want = np.asarray(jan._theta_int(jgd.Geodesic(**sub), m.numpy()))
        got = tan._theta_int(gs, m).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-14)

    def test_theta_time_cum_matches_jax(self):
        g = _geodesics()
        n = g.Rpc.shape[0]
        frac = np.random.default_rng(7).uniform(0.05, 1.9, (4, n))
        P = frac * g.Rpc.numpy()
        gs = {f: np.broadcast_to(v, (4,) + v.shape)
              for f, v in g.numpy().items()}
        want = np.asarray(jax.jit(jan._theta_time_cum)(
            jgd.Geodesic(**gs), P))
        got = tan._theta_time_cum(tgd.Geodesic.from_numpy(gs, device="cpu"),
                                  _t(P)).numpy()
        assert np.isfinite(want).all() and (g.q < 0).any()
        bound = (8.0 * np.sqrt(np.finfo(np.float64).eps) * gs["a"]
                 * gs["m2p"] / np.sqrt(np.abs(gs["m2m"] + gs["m2p"]))
                 + 1e-12 * (1.0 + np.abs(want)))
        assert (np.abs(got - want) <= bound).all()


class TestCCTime:
    def test_cc_time_radial_matches_jax(self):
        g = _geodesics()
        cc = (g.gtype == tgd.GEOD_TYPE_CC).numpy()
        sub = {f: v[cc] for f, v in g.numpy().items()}
        assert cc.sum() >= 4
        Rpc = sub["Rpc"]
        P1, P2 = 0.1 * Rpc, 0.9 * Rpc

        def jfn(g, P1, P2):
            return jan._cc_time_radial(g, jan._cc_setup(g), P1, P2)

        want = np.asarray(jax.jit(jfn)(jgd.Geodesic(**sub), P1, P2))
        gt = tgd.Geodesic.from_numpy(sub, device="cpu")
        got = tan._cc_time_radial(gt, tan._cc_setup(gt), _t(P1),
                                  _t(P2)).numpy()
        assert np.isfinite(want).all()
        np.testing.assert_allclose(got, want, rtol=1e-12)


def march_samples(g, r0_, n_chunks, per, precision=0.003, r_stop=1.95):
    """March each ray of `g` (1-D) from r0_ (n,) inward with the port's
    f64 stepwise engine from t = phi = 0: returns (P0, m0, samples),
    samples a list of (t, r, m, phi, live) after each chunk of `per`
    steps."""
    n = g.Rpc.shape[0]
    P0 = tgd.geodesic_P_int(g, r0_, 0)
    m0 = tgd.geodesic_position_pol(g, P0)
    k = tgd.geodesic_momentum(g, P0)
    # k[2] of the analytic engine is dm/dP-signed; the march's is dtheta
    k = torch.cat([k[:, :2], -k[:, 2:3], k[:, 3:]], -1)
    zero = torch.zeros(n, dtype=torch.float64)
    st = raytrace_prepare(g.a, torch.stack([zero, r0_, m0, zero], -1), k,
                          precision=precision)
    active = torch.ones(n, dtype=torch.bool)
    out = []
    for _ in range(n_chunks):
        for _ in range(per):
            st, _ = raytrace_step(st, active=active)
            r = st.x[:, 1]
            active = (active & (r > r_stop) & (r < 400.0)
                      & (st.error < 1e-2) & torch.isfinite(r))
        out.append(tuple(st.x[:, i].clone() for i in range(4))
                   + (active.clone(),))
        if not bool(active.any()):
            break
    return P0, m0, out


def test_time_and_phi_against_port_march():
    """t and phi from r0 along 12 rays (RR through the periastron and back
    out, from just above it; RC and CC plunges and vortical rays from
    r0 = 8) against the port's f64 march, wherever the ray is live and
    off its turning point."""
    al = np.array([-6.0, -4.0, 3.0, 5.0, -2.3, 2.0, 0.5, -0.3, -0.3, 0.2,
                   -1.0, 1.5])
    be = np.array([3.0, -2.0, 4.0, 1.0, 3.0, -1.5, 0.5, 0.124375,
                   -0.124375, 0.2, 0.5, -2.5])
    a = np.where(np.arange(12) < 7, 0.9, 0.5)
    inc = np.radians(np.where(np.arange(12) < 7, 70.0, 60.0))
    g = tgd.geodesic_init_inf(_t(inc), _t(a), _t(al), _t(be))
    assert bool((g.status == 0).all())
    r0_ = torch.where(g.gtype == tgd.GEOD_TYPE_RR, g.rp + 0.5, 8.0)
    P0, m0, samples = march_samples(g, r0_, n_chunks=40, per=25)
    phi0 = tgd.geodesic_position_azm(g, r0_, m0, P0)
    tv, r, m, pv, live = (torch.stack(c, 0) for c in zip(*samples))
    # the branch (before or after the periastron) from the march's radius
    ppc = (r > torch.cummin(r, 0).values + 1e-6).to(torch.float64)
    gs = g._replace(**{f.name: getattr(g, f.name).expand(
        (r.shape[0],) + getattr(g, f.name).shape)
        for f in dataclasses.fields(g)})
    P = tgd.geodesic_P_int(gs, r, ppc)
    sel = live & torch.isfinite(P) & ((r - gs.rp).abs() > 1e-4)
    assert int(sel.sum()) > 150
    assert {tgd.GEOD_TYPE_RR, tgd.GEOD_TYPE_RC,
            tgd.GEOD_TYPE_CC} <= set(gs.gtype[sel].tolist())
    assert bool((ppc[sel] > 0).any()) and bool((gs.q[sel] < 0).any())
    dphi = tgd.geodesic_position_azm(gs, r, m, P) - phi0
    dt = tgd.geodesic_timedelay_full(gs, P0.expand_as(P), r0_.expand_as(P),
                                     m0.expand_as(P), P, r, m)
    for got, want in ((dphi, pv), (dt, tv.abs())):
        err = (got - want).abs()[sel]
        bound = 2e-3 * torch.clamp(want.abs()[sel], min=1.0)
        assert bool((err < bound).all()), float((err / bound).max())
