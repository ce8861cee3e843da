"""Example 10 through the PyTorch port: Stokes-resolved disk spectrum
(energy-dependent polarization).

Twin of examples/10_polarized_spectrum.py: the polarized NT-disk spectrum
with the energy-resolved polarization degree and angle, on a CUDA device.

Usage: python examples/torch_10_polarized_spectrum.py [spin] [incl_deg]
       [device]   (device defaults to cuda; cpu runs on the host)
"""

import pathlib as _pl
import sys as _sys
_sys.path.insert(0, str(_pl.Path(__file__).resolve().parent.parent))

import os
import sys

import numpy as np

from sim5_tpu_torch.disk import nt_setup
from sim5_tpu_torch.render import polarized_spectrum

spin = float(sys.argv[1]) if len(sys.argv) > 1 else 0.9
incl = float(sys.argv[2]) if len(sys.argv) > 2 else 70.0
device = sys.argv[3] if len(sys.argv) > 3 else "cuda"

disk = nt_setup(10.0, spin, 0.1, 0.1, device=device)
FAST = bool(os.environ.get("SIM5_FAST"))  # tiny-shape CI mode
E = np.geomspace(0.3, 10.0, 8 if FAST else 20)
I, Q, U = polarized_spectrum(disk, np.radians(incl), E,
                             npix=48 if FAST else 192)
I, Q, U = (t.cpu().numpy() for t in (I, Q, U))

deg = np.hypot(Q, U) / np.maximum(I, 1e-300)
ang = 0.5 * np.degrees(np.arctan2(U, Q))

print(f"# polarized disk spectrum: a={spin} incl={incl} deg")
print("# E[keV]  I[erg/s/cm2/keV]  degree  angle[deg]")
for i in range(len(E)):
    print(f"{E[i]:8.3f}  {I[i]:.6e}  {deg[i]:.5f}  {ang[i]:8.3f}")
