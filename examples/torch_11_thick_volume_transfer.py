"""Example 11 through the PyTorch port: optically-thick volume radiative
transfer.

Twin of examples/11_thick_volume_transfer.py: a translucent emitting torus
around a Kerr black hole with both emissivity and absorption fused into
the march kernel (sim5_tpu_torch/csrc/march.cuh; I = int j e^{-tau} dl,
tau = int alpha dl toward the observer), and how the total flux
saturates as the medium turns optically thick.  The torus and its
absorption are the twin's own plain functions, in torch: the kernel
traces them (march/model_trace.py) into one build for the emissivity and
one for the pair, which every absorption coefficient of the sweep shares.
On the CPU the kernel's plain version runs.

Usage: python examples/torch_11_thick_volume_transfer.py [spin] [incl_deg]
       [device]   (device defaults to cuda; cpu runs on the host)
"""

import pathlib as _pl
import sys as _sys
_sys.path.insert(0, str(_pl.Path(__file__).resolve().parent.parent))

import os
import sys

import numpy as np
import torch

from sim5_tpu_torch.render.lightcurve import volume_image

spin = float(sys.argv[1]) if len(sys.argv) > 1 else 0.9
incl = float(sys.argv[2]) if len(sys.argv) > 2 else 70.0
device = sys.argv[3] if len(sys.argv) > 3 else "cuda"


def torus_j(t, r, m, phi):
    """Gaussian torus of emissivity at r=8, scale height 1.5."""
    R = r * torch.sqrt(torch.clamp(1.0 - m * m, min=0.0))
    z = r * m
    return torch.exp(-0.5 * (((R - 8.0) / 1.5) ** 2 + (z / 1.5) ** 2))


def make_alpha(alpha0):
    def torus_alpha(t, r, m, phi):
        return alpha0 * torus_j(t, r, m, phi)
    return torus_alpha


FAST = bool(os.environ.get("SIM5_FAST"))  # tiny-shape CI mode
kw = (dict(npix=24, rmax=16.0, r_start=30.0, max_steps=400,
           precision=0.03) if FAST else
      dict(npix=64, rmax=16.0, r_start=40.0, max_steps=2000,
           precision=0.02))
print(f"# optically-thick torus transfer: a={spin} incl={incl} deg")
print("# alpha0   total_flux   peak_I")
for alpha0 in ((0.0, 0.2) if FAST else (0.0, 0.05, 0.2, 1.0, 5.0)):
    I = volume_image(spin, np.radians(incl), torus_j,
                     absorption_fn=make_alpha(alpha0) if alpha0 > 0 else None,
                     engine="kernel", device=device, **kw).cpu().numpy()
    print(f"{alpha0:7.2f}  {I.sum():12.5e}  {I.max():12.5e}")
print("# flux saturates as alpha grows: the torus becomes a photosphere")
