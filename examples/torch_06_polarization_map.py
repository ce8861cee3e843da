"""Polarized disk image: Stokes I/Q/U maps (Walker-Penrose transport),
through the PyTorch port.

Twin of examples/06_polarization_map.py.

Run: python examples/torch_06_polarization_map.py [spin] [incl_deg] [npix]
     [device]   (device defaults to cuda; cpu runs on the host)
"""

import pathlib as _pl
import sys as _sys
_sys.path.insert(0, str(_pl.Path(__file__).resolve().parent.parent))

import sys

import numpy as np

from sim5_tpu_torch.disk import nt_setup
from sim5_tpu_torch.render import render_polarized_image
from sim5_tpu_torch.polarization import stokes_poldeg, stokes_polang

a = float(sys.argv[1]) if len(sys.argv) > 1 else 0.9
inc = float(sys.argv[2]) if len(sys.argv) > 2 else 70.0
N = int(sys.argv[3]) if len(sys.argv) > 3 else 256
device = sys.argv[4] if len(sys.argv) > 4 else "cuda"

disk = nt_setup(10.0, a, 0.1, 0.1, device=device)
It, Qt, Ut = render_polarized_image(disk, np.radians(inc), N, N)
I, Q, U = (t.cpu().numpy() for t in (It, Qt, Ut))

np.save("stokes_I.npy", I)
np.save("stokes_Q.npy", Q)
np.save("stokes_U.npy", U)

hit = I > 0
on = It > 0
pd = stokes_poldeg(It[on], Qt[on], Ut[on]).cpu().numpy()
print(f"pixels on disk: {hit.sum()}", file=sys.stderr)
print(f"integrated poldeg: {np.hypot(Q.sum(), U.sum())/I.sum():.4f}",
      file=sys.stderr)
print(f"integrated polangle: "
      f"{np.degrees(float(stokes_polang(It.sum(), Qt.sum(), Ut.sum()))):.2f} deg",
      file=sys.stderr)
print("saved stokes_I.npy / stokes_Q.npy / stokes_U.npy", file=sys.stderr)
print(f"# pixels on disk {hit.sum()}  integrated poldeg "
      f"{np.hypot(Q.sum(), U.sum()) / I.sum():.6f}  mean local poldeg "
      f"{pd.mean():.6f}")
