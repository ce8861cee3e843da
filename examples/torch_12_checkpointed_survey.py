"""Example 12 through the PyTorch port: fault-tolerant surveys, a
checkpointed hot-spot light curve plus a thick-disk image sharded over
the device mesh, on a CUDA device.

Part 1 computes a long hot-spot light curve in chunks with kill-and-resume
checkpointing (render/checkpoint.py): interrupt it at any point and re-run
it; it continues from the last flushed chunk, and the final curve is
bitwise identical to an uninterrupted run.

Part 2 renders a slim (cone) disk image through the batched
surface-intersection solve, its rows sharded across the ranks of the
device mesh with `DiskRaytrace.image(mesh=...)` (`parallel.make_mesh`:
one rank in a single process; every process of the group under a
launcher such as torchrun, one card each).

Usage: python examples/torch_12_checkpointed_survey.py [spin] [incl_deg]
       [device]   (device defaults to cuda; cpu runs on the host)
"""

import os
import pathlib
import sys
import tempfile

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import numpy as np
import torch

from sim5_tpu_torch.core import OmegaK, ellK
from sim5_tpu_torch.parallel import make_mesh
from sim5_tpu_torch.render import (DiskRaytrace, DiskSpectrum_BlackBody,
                                   FrameCheckpoint,
                                   hotspot_lightcurve_checkpointed)

a = float(sys.argv[1]) if len(sys.argv) > 1 else 0.7
inc = float(sys.argv[2]) if len(sys.argv) > 2 else 60.0
device = sys.argv[3] if len(sys.argv) > 3 else "cuda"

# --- part 1: checkpointed lightcurve sweep -----------------------------
FAST = bool(os.environ.get("SIM5_FAST"))  # tiny-shape CI mode
r_spot = 8.0
period = 2 * np.pi / float(OmegaK(torch.tensor(r_spot, dtype=torch.float64),
                                  a))
nt_ = 8 if FAST else 64
t = np.arange(nt_) / nt_ * 2 * period
ck_path = os.path.join(tempfile.gettempdir(),
                       "sim5_torch_example12_lc_fast.npz" if FAST
                       else "sim5_torch_example12_lc.npz")
if FAST and os.path.exists(ck_path):
    os.remove(ck_path)   # CI exercises a fresh compute every run

t, lc = hotspot_lightcurve_checkpointed(
    ck_path, a, np.radians(inc), r_spot, 0.7, t,
    npix=32 if FAST else 128, n_orders=1 if FAST else 2,
    chunk=4 if FAST else 8, device=device)
done, total = FrameCheckpoint.open(ck_path).progress
print(f"# lightcurve checkpoint: {done}/{total} chunks at {ck_path}",
      file=sys.stderr)
print(f"# modulation: {lc.max() / lc.min():.2f}x", file=sys.stderr)

# --- part 2: mesh-sharded thick-disk image -----------------------------


class ConeDisk:
    """Toy slim disk: photosphere at H = 0.05 R outside r=6."""
    slope = 0.05

    def mdot(self):
        return 0.1

    def lumi(self):
        return 0.1

    def flux(self, r):
        return torch.where(r > 6.0, 1.0 / torch.clamp(r, min=1.0) ** 3, 0.0)

    def t_eff(self, r):
        return torch.where(r > 6.0, 1e7 / torch.clamp(r, min=1.0) ** 0.75,
                           0.0)

    def sigma(self, r):
        return torch.ones_like(r)

    def ell(self, r):
        return ellK(torch.clamp(r, min=6.0), a)

    def vr(self, r):
        return torch.zeros_like(r)

    def h(self, r):
        return self.slope * r

    def dhdr(self, r):
        return torch.full_like(r, self.slope)


mesh = make_mesh(device=device)
rt = DiskRaytrace(10.0, a, 10.0, ConeDisk(), DiskSpectrum_BlackBody(),
                  device=device)
im = rt.image(inc, 25.0, 24 if FAST else 96, mesh=mesh)
F = im["flux"].cpu().numpy()
H = im["H"].cpu().numpy()
hit = np.isfinite(F)
print(f"# thick-disk image on {mesh.size()} device(s): "
      f"{hit.mean():.0%} hit, max surface height "
      f"{np.nanmax(np.abs(H)):.2f} rg", file=sys.stderr)

print("# t[GM/c^3]  flux[arb]")
for ti, fi in zip(t, lc):
    print(f"{ti:.4e}  {fi:.6e}")

if torch.distributed.is_initialized():
    torch.distributed.destroy_process_group()
