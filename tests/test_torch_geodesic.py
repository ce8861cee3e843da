"""The port's analytic geodesic engine (`sim5_tpu_torch.geodesic`) against
`sim5_tpu.geodesic` on the same inputs, and against the C reference
(tests/golden/geod.txt).

Inputs: the golden (a, incl, alpha, beta) grid, and the 32x32 image grid
of the volume slice's configuration (a = 0.9, incl = 70 deg, rmax = 16,
the seed sphere r = 40).

Tolerances:
* f64: `status` and `gtype` identical on every lane; values within
  relative 1e-10 on the lanes with status 0 (the same IEEE f64 operations
  in another order of fusion);
* goldens: test_geodesic.py's thresholds (1e-6; m(P) and k 1e-5);
* f32: identical status and gtype on >= 99% of the image lanes (a lane on
  a classification boundary may flip between two f32 evaluation orders).
"""

import dataclasses
import pathlib

import jax
import numpy as np
import pytest
import torch

from sim5_tpu import geodesic as jgd
from sim5_tpu.render.image import image_grid as jimage_grid
from sim5_tpu_torch import geodesic as tgd
from sim5_tpu_torch.render import image_grid

torch.set_num_threads(2)

A, INCL, RMAX, R_START, NPIX = 0.9, float(np.radians(70.0)), 16.0, 40.0, 32
FLOAT_FIELDS = ("a", "alpha", "beta", "incl", "cos_i", "l", "q", "rr", "ri",
                "m2p", "m2m", "mm", "mK", "rp", "Rpc", "Tpp", "Tip")


def _t(*arrays, dtype=torch.float64):
    out = [torch.tensor(np.asarray(v), dtype=dtype) for v in arrays]
    return out if len(out) > 1 else out[0]


def _rel_close(got, want, ok, rtol=1e-10, atol=1e-14):
    """Relative agreement on the lanes `ok` (broadcast over trailing dims)."""
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    sel = np.broadcast_to(ok.reshape(ok.shape + (1,) * (want.ndim - ok.ndim)),
                          want.shape)
    g, w = got[sel], want[sel]
    assert (np.isfinite(g) == np.isfinite(w)).all()
    f = np.isfinite(w)
    np.testing.assert_allclose(g[f], w[f], rtol=rtol, atol=atol)


def _take(g, idx):
    """The port's Geodesic at lanes `idx`."""
    return g._replace(**{f.name: getattr(g, f.name)[torch.as_tensor(idx)]
                         for f in dataclasses.fields(g)})


def _parse_geod():
    recs, cur = [], None
    path = pathlib.Path(__file__).parent / "golden" / "geod.txt"
    with open(path) as f:
        for line in f:
            parts = line.split()
            if not parts:
                continue
            tag, vals = parts[0], [float(v) for v in parts[1:]]
            if tag == "ginit":
                cur = {"init": vals, "pos": [], "pint": [], "tip": None}
                recs.append(cur)
            elif tag == "gtip":
                cur["tip"] = vals[0]
            elif tag in ("gpos", "gpint"):
                cur[tag[1:]].append(vals)
    return recs


@pytest.fixture(scope="module")
def golden():
    """(records the reference initialised, their init rows, the first six
    init columns of every record: a, incl, alpha, beta, ok, err)."""
    recs = _parse_geod()
    head = np.asarray([r["init"][:6] for r in recs])
    ok = [r for r in recs if r["init"][4] == 1]
    return ok, np.asarray([r["init"] for r in ok]), head


def _image_inputs(dtype=np.float64):
    alpha, beta = (np.asarray(v) for v in jimage_grid(NPIX, NPIX, RMAX))
    return alpha.astype(dtype), beta.astype(dtype)


def _compare_geodesics(gt, gj):
    """status and gtype identical everywhere; values 1e-10 where ok."""
    st = np.asarray(gj.status)
    np.testing.assert_array_equal(gt.status.numpy(), st)
    np.testing.assert_array_equal(gt.gtype.numpy(), np.asarray(gj.gtype))
    np.testing.assert_array_equal(gt.nrr.numpy(), np.asarray(gj.nrr))
    ok = st == 0
    for name in FLOAT_FIELDS:
        _rel_close(getattr(gt, name), getattr(gj, name), ok)
    # the low parts: ulp-sized, compared on the root scale
    scale = np.abs(np.asarray(gj.rr)).max()
    _rel_close(gt.rr_lo, gj.rr_lo, ok, rtol=0.0, atol=1e-15 * scale)
    return ok


class TestAgainstJax:
    """The port against sim5_tpu.geodesic in f64."""

    def test_init_on_golden_grid(self, golden):
        _, _, arr = golden
        gj = jgd.geodesic_init_inf(arr[:, 1], arr[:, 0], arr[:, 2], arr[:, 3])
        gt = tgd.geodesic_init_inf(*_t(arr[:, 1], arr[:, 0], arr[:, 2],
                                       arr[:, 3]))
        ok = _compare_geodesics(gt, gj)
        assert ok.mean() > 0.5

    def test_image_chain(self):
        """init -> P_int -> position_rad/pol -> dm_sign -> momentum on the
        slice's image grid at the seed sphere, as the volume seed runs it."""
        alpha, beta = _image_inputs()
        ta, tb = image_grid(NPIX, NPIX, RMAX, device="cpu")
        np.testing.assert_array_equal(ta.numpy(), alpha)
        np.testing.assert_array_equal(tb.numpy(), beta)
        gj = jgd.geodesic_init_inf(INCL, A, alpha, beta)
        gt = tgd.geodesic_init_inf(INCL, A, ta, tb)
        ok = _compare_geodesics(gt, gj)
        rs = np.full(alpha.shape, R_START)
        for ppc in (0, 1):
            Pj = np.asarray(jgd.geodesic_P_int(gj, rs, ppc))
            Pt = tgd.geodesic_P_int(gt, _t(rs), ppc)
            _rel_close(Pt, Pj, ok)
        P = np.where(ok & np.isfinite(Pj), Pj, 1e-3)
        tP = _t(P)
        for jf, tf in ((jgd.geodesic_position_rad, tgd.geodesic_position_rad),
                       (jgd.geodesic_position_pol, tgd.geodesic_position_pol),
                       (jgd.geodesic_dm_sign, tgd.geodesic_dm_sign),
                       (jgd.geodesic_momentum, tgd.geodesic_momentum)):
            _rel_close(tf(gt, tP), jf(gj, P), ok)
        # a share of the grid is captured or misses the sphere: both kinds
        # of lanes are exercised
        assert 0.2 < np.isfinite(Pj)[ok].mean() <= 1.0

    def test_from_numpy_round_trip(self):
        alpha, beta = _image_inputs()
        gj = jgd.geodesic_init_inf(INCL, A, alpha, beta)
        d = {k: np.asarray(v) for k, v in gj._asdict().items()}
        gt = tgd.Geodesic.from_numpy(d, device="cpu")
        back = gt.numpy()
        for name, v in d.items():
            np.testing.assert_array_equal(back[name], v)
            assert getattr(gt, name).dtype == torch.from_numpy(v).dtype
        assert gt.ok.dtype == torch.bool
        torch.testing.assert_close(gt.root_diff(0, 1),
                                   torch.from_numpy(np.asarray(
                                       gj.root_diff(0, 1))), rtol=0, atol=0)
        # the port's inversions on the carried JAX geodesic
        P = np.full(alpha.shape, 0.5) * np.asarray(gj.Rpc)
        _rel_close(tgd.geodesic_position_rad(gt, _t(P)),
                   jgd.geodesic_position_rad(gj, P), d["status"] == 0)


class TestAgainstJaxF32:
    def test_image_classification_f32(self):
        """The f32 seed chain (f32 depths and rescale by dtype) against the
        JAX package under enable_x64(False)."""
        alpha, beta = _image_inputs(np.float32)
        with jax.enable_x64(False):
            gj = jgd.geodesic_init_inf(np.float32(INCL), np.float32(A),
                                       alpha, beta)
            Pj = np.asarray(jgd.geodesic_P_int(
                gj, np.full(alpha.shape, R_START, np.float32), 0))
            st_j, ty_j = np.asarray(gj.status), np.asarray(gj.gtype)
        gt = tgd.geodesic_init_inf(*_t(INCL, A, alpha, beta,
                                       dtype=torch.float32))
        assert gt.rr.dtype == torch.float32 and gt.status.dtype == torch.int32
        Pt = tgd.geodesic_P_int(gt, R_START, 0).numpy()
        same = (gt.status.numpy() == st_j) & (gt.gtype.numpy() == ty_j)
        assert same.mean() >= 0.99
        both = same & (st_j == 0) & np.isfinite(Pj) & np.isfinite(Pt)
        assert both.mean() > 0.2
        # P at the seed sphere: f32 chains of ~10^3 roundings through
        # elliptic integrals, 1e-4 relative
        np.testing.assert_allclose(Pt[both], Pj[both], rtol=1e-4)


class TestGolden:
    """The port against the C reference at test_geodesic.py's thresholds."""

    def test_init(self, golden):
        recs, arr, head = golden
        # every ray the reference initialises, the port does too
        g = tgd.geodesic_init_inf(*_t(head[:, 1], head[:, 0], head[:, 2],
                                      head[:, 3]))
        assert not ((head[:, 4] == 1) & (g.status.numpy() != 0)).any()
        g = tgd.geodesic_init_inf(*_t(arr[:, 1], arr[:, 0], arr[:, 2],
                                      arr[:, 3]))
        np.testing.assert_allclose(g.l.numpy(), arr[:, 6], rtol=1e-12,
                                   atol=1e-14)
        np.testing.assert_allclose(g.q.numpy(), arr[:, 7], rtol=1e-12,
                                   atol=1e-14)
        same = g.gtype.numpy() == arr[:, 9]
        assert same.mean() > 0.995
        for name, col in (("m2p", 18), ("m2m", 19), ("mm", 20), ("mK", 21)):
            np.testing.assert_allclose(getattr(g, name).numpy(), arr[:, col],
                                       rtol=1e-10)
        qpos = same & (arr[:, 7] > 0)
        not_cc = qpos & (arr[:, 9] != tgd.GEOD_TYPE_CC)
        np.testing.assert_allclose(g.rp.numpy()[same], arr[same, 22],
                                   rtol=1e-6, atol=1e-9)
        np.testing.assert_allclose(g.Rpc.numpy()[not_cc], arr[not_cc, 23],
                                   rtol=1e-6, atol=1e-9)
        np.testing.assert_allclose(g.Tpp.numpy()[same], arr[same, 24],
                                   rtol=1e-6, atol=1e-9)
        tip = np.asarray([r["tip"] for r in recs])
        np.testing.assert_allclose(g.Tip.numpy()[qpos], tip[qpos],
                                   rtol=1e-6, atol=1e-9)

    def test_positions_and_P_int(self, golden):
        recs, arr, _ = golden
        keep = np.arange(len(recs))
        g = tgd.geodesic_init_inf(*_t(arr[keep, 1], arr[keep, 0],
                                      arr[keep, 2], arr[keep, 3]))
        idx = [i for i, k in enumerate(keep) for _ in recs[k]["pos"]]
        ref = np.asarray([row for k in keep for row in recs[k]["pos"]])
        gs = _take(g, idx)
        P = _t(ref[:, 0])
        r = tgd.geodesic_position_rad(gs, P).numpy()
        m = tgd.geodesic_position_pol(gs, P).numpy()
        qpos = gs.q.numpy() > 0
        assert (np.isfinite(ref[:, 1]) == np.isfinite(r)).mean() > 0.98
        ok_r = np.isfinite(ref[:, 1]) & np.isfinite(r)
        np.testing.assert_allclose(r[ok_r], ref[ok_r, 1], rtol=1e-6,
                                   atol=1e-8)
        ok_m = np.isfinite(ref[:, 2]) & np.isfinite(m) & qpos
        np.testing.assert_allclose(m[ok_m], ref[ok_m, 2], rtol=1e-5,
                                   atol=1e-7)
        k = tgd.geodesic_momentum(gs, P, _t(r), _t(m)).numpy()
        ok_k = np.isfinite(ref[:, 4]) & np.isfinite(k[:, 0]) & ok_r & ok_m
        np.testing.assert_allclose(k[ok_k], ref[ok_k, 4:8], rtol=1e-5,
                                   atol=1e-7)
        # P_int at the golden radii, both branches, and r(P(r)) == r
        idx = [i for i, k in enumerate(keep) for _ in recs[k]["pint"]]
        ref = np.asarray([row for k in keep for row in recs[k]["pint"]])
        gs = _take(g, idx)
        rs = _t(ref[:, 0])
        for ppc, col in ((0, 1), (1, 2)):
            Pp = tgd.geodesic_P_int(gs, rs, ppc).numpy()
            ok = np.isfinite(ref[:, col]) & np.isfinite(Pp)
            np.testing.assert_allclose(Pp[ok], ref[ok, col], rtol=1e-6,
                                       atol=1e-9)
            if ppc == 0:
                rb = tgd.geodesic_position_rad(gs, _t(Pp)).numpy()
                okr = ok & np.isfinite(rb)
                np.testing.assert_allclose(rb[okr], ref[okr, 0], rtol=1e-8,
                                           atol=1e-9)
