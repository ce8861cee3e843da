"""Black-hole shadow + plunging-region image, through the PyTorch port.

Twin of examples/09_black_hole_shadow.py: the full equatorial plane down
to the horizon, the NT disk outside the ISCO, the Cunningham plunging
flow's redshift map inside it (with a power-law inner emissivity), and
the exact captured-ray silhouette, on a CUDA device.

Run: python examples/torch_09_black_hole_shadow.py <spin> <inclination_deg>
     [npix] [device]   (device defaults to cuda; cpu runs on the host)
Outputs shadow_<spin>_<incl>.npz with captured/r/g/flux maps.
"""

import pathlib as _pl
import sys as _sys
_sys.path.insert(0, str(_pl.Path(__file__).resolve().parent.parent))

import sys
import time

import numpy as np
import torch

from sim5_tpu_torch.disk import nt_setup
from sim5_tpu_torch.render import render_bh_image

a = float(sys.argv[1]) if len(sys.argv) > 1 else 0.998
inc_deg = float(sys.argv[2]) if len(sys.argv) > 2 else 80.0
N = int(sys.argv[3]) if len(sys.argv) > 3 else 512
device = torch.device(sys.argv[4] if len(sys.argv) > 4 else "cuda")

if not (0.0 <= a <= 0.999) or not (0.0 <= inc_deg <= 89.0):
    sys.exit("ERROR: parameters out of range (spin 0..0.999, incl 0..89)")


def sync():
    if device.type == "cuda":
        torch.cuda.synchronize(device)


disk = nt_setup(10.0, a, 0.1, 0.1, device=device)

print("Computing ...", file=sys.stderr)
sync()
t0 = time.perf_counter()
im = render_bh_image(a, np.radians(inc_deg), N, N, rmax=10.0, disk=disk,
                     inner_emissivity=lambda r: 1e22 * r ** -3)
sync()
dt = time.perf_counter() - t0

cap = im.captured.cpu().numpy()
g = im.g.cpu().numpy()
hit = im.hit.cpu().numpy()
print(f"time: {dt:.2f} s  rate: {N * N / dt:.3e} photons/s", file=sys.stderr)
print(f"shadow fraction: {cap.mean():.4f}; "
      f"g range on emission: [{g[hit].min():.3f}, "
      f"{g[hit].max():.3f}]", file=sys.stderr)

out = f"shadow_{a}_{inc_deg}.npz"
np.savez(out, captured=cap, r=im.r.cpu().numpy(), g=g,
         flux=im.flux.cpu().numpy())
print(f"wrote {out}", file=sys.stderr)
print(f"# shadow fraction {cap.mean():.6f}  g range [{g[hit].min():.6f}, "
      f"{g[hit].max():.6f}]")
