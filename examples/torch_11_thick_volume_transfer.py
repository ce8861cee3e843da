"""Example 11 through the PyTorch port: optically-thick volume radiative
transfer.

Twin of examples/11_thick_volume_transfer.py: a translucent emitting torus
around a Kerr black hole with both emissivity and absorption fused into
the march kernel (sim5_tpu_torch/csrc/march.cu; I = int j e^{-tau} dl,
tau = int alpha dl toward the observer), and how the total flux
saturates as the medium turns optically thick.  The torus is a
`GaussianSource`, the family the kernel evaluates; on the CPU the
kernel's plain version runs.

Usage: python examples/torch_11_thick_volume_transfer.py [spin] [incl_deg]
       [device]   (device defaults to cuda; cpu runs on the host)
"""

import pathlib as _pl
import sys as _sys
_sys.path.insert(0, str(_pl.Path(__file__).resolve().parent.parent))

import os
import sys

import numpy as np

from sim5_tpu_torch.march.emission import GaussianSource
from sim5_tpu_torch.render.lightcurve import volume_image

spin = float(sys.argv[1]) if len(sys.argv) > 1 else 0.9
incl = float(sys.argv[2]) if len(sys.argv) > 2 else 70.0
device = sys.argv[3] if len(sys.argv) > 3 else "cuda"


def torus(amp):
    """Gaussian torus of emissivity at r=8, scale height 1.5 (times amp):
    exp(-0.5 (((R - 8) / 1.5)^2 + (z / 1.5)^2))."""
    return GaussianSource(amp=amp, center=8.0, inv_width=1.0 / 1.5,
                          inv_height=1.0 / 1.5, cylindrical=True)


FAST = bool(os.environ.get("SIM5_FAST"))  # tiny-shape CI mode
kw = (dict(npix=24, rmax=16.0, r_start=30.0, max_steps=400,
           precision=0.03) if FAST else
      dict(npix=64, rmax=16.0, r_start=40.0, max_steps=2000,
           precision=0.02))
print(f"# optically-thick torus transfer: a={spin} incl={incl} deg")
print("# alpha0   total_flux   peak_I")
for alpha0 in ((0.0, 0.2) if FAST else (0.0, 0.05, 0.2, 1.0, 5.0)):
    I = volume_image(spin, np.radians(incl), torus(1.0),
                     absorption_fn=torus(alpha0) if alpha0 > 0 else None,
                     engine="kernel", device=device, **kw).cpu().numpy()
    print(f"{alpha0:7.2f}  {I.sum():12.5e}  {I.max():12.5e}")
print("# flux saturates as alpha grows: the torus becomes a photosphere")
