"""The port's `hotspot_lightcurve_checkpointed` against the JAX package's,
whole, at npix 24 with both image orders: the JAX package's crossing maps
compile for minutes on a CPU (about 130 s each, test_torch_slow_parity.py),
so this file is marked `slow` and tier-1 (`-m 'not slow'`) skips it.  Run
with

    python -m pytest tests/test_torch_checkpoint_slow.py -m slow

Tolerance: 1e-6 relative.  The two packages' crossing maps differ in phi
by up to 8 sqrt(eps) |l/a| / ((1 - m2p) sqrt(m2m + m2p)) (the theta term's
turning points, test_torch_azimuth.phi_bound; up to ~1e-6 rad), and the
spot's flux moves with phi by (r / spot_size)^2 = 64 per radian at the
spot; the curves differ by 2.7e-8 relative on a CPU.
"""

import numpy as np
import pytest
import torch

from sim5_tpu.render import FrameCheckpoint as JFrameCheckpoint
from sim5_tpu.render import (hotspot_lightcurve_checkpointed
                             as j_hotspot_checkpointed)
from sim5_tpu_torch.render import (FrameCheckpoint,
                                   hotspot_lightcurve_checkpointed)

pytestmark = pytest.mark.slow

torch.set_num_threads(2)


class TestHotspotCheckpointedJax:
    def test_against_jax(self, tmp_path):
        kw = dict(a=0.6, incl=np.radians(60.0), r_spot=8.0, spot_size=1.0,
                  t_obs=np.linspace(0.0, 500.0, 6), npix=24, n_orders=2,
                  chunk=4)
        jt, jcurve = j_hotspot_checkpointed(str(tmp_path / "j.npz"), **kw)
        tt, curve = hotspot_lightcurve_checkpointed(str(tmp_path / "t.npz"),
                                                    device="cpu", **kw)
        np.testing.assert_array_equal(tt, jt)
        assert (curve > 0.0).all()
        np.testing.assert_allclose(curve, np.asarray(jcurve), rtol=1e-6)
        ck = FrameCheckpoint.open(str(tmp_path / "t.npz"))
        jck = JFrameCheckpoint.open(str(tmp_path / "j.npz"))
        assert ck.meta == jck.meta and ck.progress == jck.progress == (2, 2)
