"""The port's analytic azimuth (`geodesic_position_azm`) against the JAX
package, the C golden and the port's own f64 stepwise march, and the
volume seed's azimuth stage (`_volume_seed(axisymmetric=False)`) against
the JAX package's.

The batch: 64 geodesics at 4 positions P each, shaped (16, 16) like a
16^2 volume seed so that the JAX package compiles its azimuth program
(`render.lightcurve._volume_seed_azm`) once for the batch and the seed:
RR and RC rays of an image grid (a = 0.9, i = 70 deg), CC and vortical
(q < 0) RC rays near the centre of the image (a = 0.5, i = 60 deg), set up
by the port (its `geodesic_init_inf` is held against the JAX package's in
test_torch_geodesic.py), and RR_BH
bound-band rays set up from a source point by the JAX package's
`geodesic_init_src` (the port has none yet) and carried across with
`Geodesic.from_numpy`.

Tolerances, and why:
* phi against the JAX package: per lane 8 sqrt(eps) S + 1e-12 (1 + |phi|)
  with S = |l/a| / ((1 - m2p) sqrt(m2m + m2p)) (`phi_bound`).  The port
  agrees with the JAX functions run op by op to 3e-14 rad; the jitted
  JAX program differs from its own op-by-op result by up to 6.8e-7 rad
  on this batch.  The cause is the theta term: `_theta_phi_cum`
  evaluates integral_T_mp at x = sqrt(m2p) cn(dT/mK), whose integrand
  near the turning point x -> b = sqrt(m2p) goes as
  1 / ((1 - b^2) sqrt(a^2 + b^2) sqrt(2b (b - x))), so a one-ulp
  difference in cn (XLA fuses and vectorizes sin/cos) moves phi by about
  sqrt(eps) times |l/a| / ((1 - m2p) sqrt(m2m + m2p)): measured, exactly
  1 or 2 sqrt(eps) S on every lane that differs (the near-polar RR_BH
  rays, 1 - m2p small, reach 6.8e-7).
* the seeded state (f64): phi against the JAX package's azimuth stage on
  the port's seed geometry within `phi_bound`; `ok` and every other field
  bitwise the port's axisymmetric seed (test_torch_volume.py holds that
  against the JAX package's seed, relative 1e-10).

The C golden (`gpos`) and the oracle of the port's own f64 march are in
test_torch_timedelay.py, which holds phi and the travel time against
them (this file's JAX compile takes most of its minute).
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from sim5_tpu import geodesic as jgd
from sim5_tpu.render import lightcurve as jlc
from sim5_tpu_torch import geodesic as tgd
from sim5_tpu_torch.core import photon_momentum
from sim5_tpu_torch.render import lightcurve as tlc

torch.set_num_threads(2)



def phi_bound(g, phi):
    """The tolerance on phi against the jitted JAX program (module
    docstring), per lane, from the geodesic's fields (numpy)."""
    S = np.abs(g["l"] / g["a"]) / (np.abs(1.0 - g["m2p"])
                                   * np.sqrt(np.abs(g["m2m"] + g["m2p"])))
    return 8.0 * np.sqrt(np.finfo(np.float64).eps) * S \
        + 1e-12 * (1.0 + np.abs(phi))

SEED = dict(a=0.9, incl=float(np.radians(70.0)), npix=16, rmax=16.0,
            r_start=40.0, precision=0.02)
# P / Rpc of the four positions of each geodesic, by type
FRACTIONS = {tgd.GEOD_TYPE_RR: (0.2, 0.7, 1.3, 1.8),
             tgd.GEOD_TYPE_RR_BH: (0.2, 0.6, 1.2, 1.8)}
FRACTIONS_PLUNGE = (0.15, 0.4, 0.7, 0.95)     # RC and CC: P < Rpc


def _bh_geodesics():
    """8 RR_BH geodesics from source points inside the bound band: the
    spherical-photon-orbit constants at r = 2.5 (a = 0.9) with q raised to
    open the band (test_geodesic.py's `bh_band`), at 8 source points, set
    up by the JAX package's (jitted) `geodesic_init_src`."""
    a = 0.9
    l = (2.5 ** 2 * (3 - 2.5) - a ** 2 * (2.5 + 1)) / (a * (2.5 - 1))
    q0 = 2.5 ** 3 * (4 * a ** 2 - 2.5 * (2.5 - 3) ** 2) \
        / (a ** 2 * (2.5 - 1) ** 2)
    rs = np.repeat([1.7, 1.8, 1.9, 2.0], 2)
    m0 = np.tile([0.05, 0.1], 4)
    q = q0 + np.tile([0.3, 0.5], 4)
    k = photon_momentum(*(torch.tensor(v) for v in (
        np.full(8, a), rs, m0, np.full(8, l), q, np.ones(8), np.ones(8))))
    g = jax.jit(jgd.geodesic_init_src)(np.full(8, a), rs, m0, k.numpy(),
                                       np.zeros(8))
    return {f: np.asarray(v) for f, v in g._asdict().items()}


# CC rays (all vortical) and vortical RC rays near the image centre at
# a = 0.5, i = 60 deg
CENTRE = np.array([(-0.45, 0.05), (-0.4, 0.1), (-0.35, 0.0), (-0.35, 0.05),
                   (-0.3, 0.1), (-0.3, -0.124375), (-0.25, 0.05),
                   (-0.3, 0.124375), (0.2, 0.1), (0.1, -0.05), (0.0, 0.1),
                   (-0.1, -0.1), (0.3, 0.05), (0.15, 0.0), (-0.05, 0.05),
                   (0.25, -0.1)])


def _batch():
    """(geodesic fields, P, r, m) of the (16, 16) batch, as numpy."""
    al, be = np.meshgrid(np.linspace(-7.0, 7.0, 8), np.linspace(-6.0, 6.0, 5))
    parts = [tgd.geodesic_init_inf(*(torch.tensor(np.full(v.size, x))
                                     if np.isscalar(x) else torch.tensor(x)
                                     for x in (inc, a, v, w)))
             for inc, a, v, w in (
                 (SEED["incl"], 0.9, al.ravel(), be.ravel()),
                 (float(np.radians(60.0)), 0.5, CENTRE[:, 0], CENTRE[:, 1]))]
    parts = [g.numpy() for g in parts] + [_bh_geodesics()]
    geo = {f: np.concatenate([p[f] for p in parts]) for f in parts[0]}
    assert len(geo["Rpc"]) == 64
    frac = np.asarray([FRACTIONS.get(int(t), FRACTIONS_PLUNGE)
                       for t in geo["gtype"]])              # (64, 4)
    # each geodesic's 4 positions: the geodesic fields repeated 4 times
    geo = {f: np.ascontiguousarray(np.repeat(v, 4, axis=0).reshape(
        (16, 16) + v.shape[1:])) for f, v in geo.items()}
    P = (frac.reshape(16, 16) * geo["Rpc"])
    g = tgd.Geodesic.from_numpy(geo, device="cpu")
    Pt = torch.tensor(P)
    r = tgd.geodesic_position_rad(g, Pt).numpy()
    m = tgd.geodesic_position_pol(g, Pt).numpy()
    return geo, P, r, m


@pytest.fixture(scope="module")
def batch():
    return _batch()


class TestAgainstJax:
    """One jitted JAX azimuth program, for the batch and the seed."""

    @pytest.fixture(scope="class")
    def port_phi(self, batch):
        geo, P, r, m = batch
        g = tgd.Geodesic.from_numpy(geo, device="cpu")
        return tgd.geodesic_position_azm(g, torch.tensor(r), torch.tensor(m),
                                         torch.tensor(P)).numpy()

    @pytest.fixture(scope="class")
    def jax_phi(self, batch):
        geo, P, r, m = batch
        gj = jgd.Geodesic(**geo)
        return np.asarray(jlc._volume_seed_azm(
            gj, np.ones((16, 16), bool), P, r, m))

    def test_batch_covers_every_type(self, batch):
        geo = batch[0]
        types = set(np.unique(geo["gtype"][geo["status"] == 0]).tolist())
        assert types == {tgd.GEOD_TYPE_RR, tgd.GEOD_TYPE_RC,
                         tgd.GEOD_TYPE_CC, tgd.GEOD_TYPE_RR_BH}
        assert (geo["q"][geo["status"] == 0] < 0.0).sum() >= 8

    @pytest.mark.parametrize("lanes", ["RR", "RC", "CC", "RR_BH",
                                       "vortical"])
    def test_phi(self, batch, port_phi, jax_phi, lanes):
        geo = batch[0]
        got = port_phi
        sel = ((geo["q"] < 0.0) if lanes == "vortical" else
               (geo["gtype"] == getattr(tgd, f"GEOD_TYPE_{lanes}")))
        sel = sel & (geo["status"] == 0)
        assert sel.sum() >= 8
        want = jax_phi[sel]
        assert (np.isfinite(got[sel]) == np.isfinite(want)).all()
        assert np.isfinite(want).mean() > 0.5
        f = np.isfinite(want)
        bound = phi_bound({k: v[sel][f] for k, v in geo.items()}, want[f])
        assert (np.abs(got[sel][f] - want[f]) <= bound).all()

    def test_volume_seed_matches_jax(self, jax_phi):
        """The port's 16^2 seed with its azimuth stage: phi against the
        JAX package's azimuth stage (`_volume_seed_azm`, the program
        compiled for the batch) on the port's seed geometry, and every
        other field and `ok` bitwise the port's axisymmetric seed, which
        test_torch_volume.py holds against the JAX package's seed (the
        azimuth stage writes phi and nothing else)."""
        kw = {k: SEED[k] for k in ("npix", "rmax", "r_start", "precision")}
        st, ok = tlc._volume_seed(SEED["a"], SEED["incl"], 0.0,
                                  axisymmetric=False, device="cpu", **kw)
        st0, ok0 = tlc._volume_seed(SEED["a"], SEED["incl"], 0.0,
                                    axisymmetric=True, device="cpu", **kw)
        g, okg, P0s, r0, m0 = tlc._volume_seed_geom(
            SEED["a"], SEED["incl"], SEED["npix"], SEED["rmax"],
            SEED["r_start"], torch.float64, "cpu")
        geo = g.numpy()
        want = np.asarray(jlc._volume_seed_azm(
            jgd.Geodesic(**geo), okg.numpy(), P0s.numpy(), r0.numpy(),
            m0.numpy()))
        ok = ok.numpy()
        assert np.array_equal(ok, ok0.numpy()) and 0.3 < ok.mean() <= 1.0
        phi = st.x[..., 3].numpy()
        assert np.abs(want)[ok].max() > 0.1
        assert (np.abs(phi - want) <= phi_bound(geo, want))[ok].all()
        for f in dataclasses.fields(st):
            got, ref = getattr(st, f.name), getattr(st0, f.name)
            if not isinstance(ref, torch.Tensor):
                assert got == ref
                continue
            if f.name == "x":
                got, ref = got[..., :3], ref[..., :3]
            assert torch.equal(got, ref), f.name
