"""Light curve of an orbiting hot spot (Doppler beaming + lensing +
delays), through the PyTorch port.

Twin of examples/07_hotspot_lightcurve.py.

Run: python examples/torch_07_hotspot_lightcurve.py [spin] [incl_deg]
     [r_spot] [device]   (device defaults to cuda; cpu runs on the host)
"""

import pathlib as _pl
import sys as _sys
_sys.path.insert(0, str(_pl.Path(__file__).resolve().parent.parent))

import os
import sys

import numpy as np
import torch

from sim5_tpu_torch.core import OmegaK
from sim5_tpu_torch.render import hotspot_lightcurve

a = float(sys.argv[1]) if len(sys.argv) > 1 else 0.5
inc = float(sys.argv[2]) if len(sys.argv) > 2 else 70.0
r_spot = float(sys.argv[3]) if len(sys.argv) > 3 else 7.0
device = sys.argv[4] if len(sys.argv) > 4 else "cuda"

FAST = bool(os.environ.get("SIM5_FAST"))  # tiny-shape CI mode
period = 2 * np.pi / float(OmegaK(torch.tensor(r_spot, dtype=torch.float64),
                                  a))
nt_ = 8 if FAST else 96
t = np.arange(nt_) / nt_ * 2 * period
lc = hotspot_lightcurve(a, np.radians(inc), r_spot, 0.7, t,
                        npix=48 if FAST else 192,
                        n_orders=1 if FAST else 2,
                        device=device).cpu().numpy()

print(f"# orbital period: {period:.2f} GM/c^3", file=sys.stderr)
print(f"# modulation: {lc.max()/lc.min():.2f}x", file=sys.stderr)
print("# t[GM/c^3]  flux[arb]")
for ti, fi in zip(t, lc):
    print(f"{ti:.4e}  {fi:.6e}")
