"""Equatorial NT-disk image (flux + g-factor maps), through the PyTorch
port.

Twin of examples/04_disk_image.py (the reference example 04,
examples/04-disk-image-eqplane/disk-image.c): on a CUDA device the whole
pixel grid renders in one launch of the disk image kernel
(sim5_tpu_torch/csrc/disk_image.cu); prints the photon rate like the
reference.

Run: python examples/torch_04_disk_image.py <spin> <inclination_deg>
     [npix] [device]   (device defaults to cuda; cpu runs on the host)
"""

import pathlib as _pl
import sys as _sys
_sys.path.insert(0, str(_pl.Path(__file__).resolve().parent.parent))

import sys
import time

import numpy as np
import torch

from sim5_tpu_torch.disk import nt_setup
from sim5_tpu_torch.render import render_disk_image

a = float(sys.argv[1]) if len(sys.argv) > 1 else 0.0
inc_deg = float(sys.argv[2]) if len(sys.argv) > 2 else 60.0
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
image_f, image_g = render_disk_image(disk, np.radians(inc_deg), N, N)
sync()
t1 = time.perf_counter()
print("done", file=sys.stderr)
print("Profiling:", file=sys.stderr)
print(f"    photons: {N * N}", file=sys.stderr)
print(f"    time: {t1 - t0:.2f} s (incl. kernel build)", file=sys.stderr)
print(f"    rate: {N * N / (t1 - t0):.1f} photons/s", file=sys.stderr)

image_f, image_g = image_f.cpu().numpy(), image_g.cpu().numpy()
np.save("disk_image_flux.npy", image_f)
np.save("disk_image_gfactor.npy", image_g)
print("saved disk_image_flux.npy / disk_image_gfactor.npy", file=sys.stderr)
print(f"# peak flux {image_f.max():.6e}  mean g {image_g[image_g > 0].mean():.6f}")
