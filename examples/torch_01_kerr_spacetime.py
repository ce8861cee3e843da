"""Characteristic Kerr orbit radii vs spin, through the PyTorch port.

Twin of examples/01_kerr_spacetime.py (the reference example 01,
examples/01-kerr-spacetime/kerr-orbits.c): one vectorized evaluation over
the whole spin grid on a CUDA device.

Run: python examples/torch_01_kerr_spacetime.py [device]
     (device defaults to cuda; cpu runs on the host)
"""

import pathlib as _pl
import sys as _sys
_sys.path.insert(0, str(_pl.Path(__file__).resolve().parent.parent))

import sys

import numpy as np
import torch

from sim5_tpu_torch.core import r_bh, r_ph, r_mb, r_ms

device = sys.argv[1] if len(sys.argv) > 1 else "cuda"

a = torch.tensor(np.arange(0.0, 1.0, 0.01), dtype=torch.float64,
                 device=device)

print("# Locations of black-hole horizon (r_bh), photon orbit radius (r_ph),")
print("# marginally bound orbit (r_mb) and marginally stable orbit (r_ms)")
print("# in Kerr spacetime as a function of black-hole spin.")
print("# Line format: spin  r_bh  r_ph  r_mb  r_ms")
print("# Units: gravitational radius [GM/c2]")
print("# ----")

for ai, bh, ph, mb, ms in zip(*(t.cpu().numpy() for t in (
        a, r_bh(a), r_ph(a), r_mb(a), r_ms(a)))):
    print(f"{ai:.4f}  {bh:e}  {ph:e}  {mb:e}  {ms:e}")
