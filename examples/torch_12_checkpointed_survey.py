"""Example 12, part 1, through the PyTorch port: a long hot-spot light
curve computed in chunks with kill-and-resume checkpointing
(render/checkpoint.py), on a CUDA device.  Interrupt it at any point and
re-run it: it continues from the last flushed chunk, and the final curve
is bitwise identical to an uninterrupted run.  (Part 2, the thick-disk
image sharded over a device mesh, waits for the port's multi-GPU slice.)

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

from sim5_tpu_torch.core import OmegaK
from sim5_tpu_torch.render import (FrameCheckpoint,
                                   hotspot_lightcurve_checkpointed)

a = float(sys.argv[1]) if len(sys.argv) > 1 else 0.7
inc = float(sys.argv[2]) if len(sys.argv) > 2 else 60.0
device = sys.argv[3] if len(sys.argv) > 3 else "cuda"

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

print("# t[GM/c^3]  flux[arb]")
for ti, fi in zip(t, lc):
    print(f"{ti:.4e}  {fi:.6e}")
