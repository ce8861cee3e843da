"""Observed spectrum of a thin NT disk (blackbody + hardening + limb dk),
through the PyTorch port.

Twin of examples/05_disk_spectrum.py, which mirrors the reference
DiskRaytrace.spectrum driver (python/sim5diskraytrace.py:43-134) with
batched raytracing on a CUDA device.

Run: python examples/torch_05_disk_spectrum.py [spin] [incl_deg] [device]
     (device defaults to cuda; cpu runs on the host)
"""

import pathlib as _pl
import sys as _sys
_sys.path.insert(0, str(_pl.Path(__file__).resolve().parent.parent))

import os
import sys

import numpy as np

from sim5_tpu_torch.disk import ThinDisk
from sim5_tpu_torch.render import DiskRaytrace, DiskSpectrum_BlackBody

a = float(sys.argv[1]) if len(sys.argv) > 1 else 0.7
inc = float(sys.argv[2]) if len(sys.argv) > 2 else 60.0
device = sys.argv[3] if len(sys.argv) > 3 else "cuda"

disk = ThinDisk.create(bh_mass=10.0, bh_spin=a, mdot_or_L=0.1, device=device)
rt = DiskRaytrace(10.0, a, 10.0, disk, DiskSpectrum_BlackBody(),
                  device=device)

FAST = bool(os.environ.get("SIM5_FAST"))  # tiny-shape CI mode
E = np.geomspace(0.1, 50.0, 16 if FAST else 64)
spec_f, spec_0 = rt.spectrum(inc, E, radres=1.2 if FAST else 0.3,
                             angres=10 if FAST else 45)

print("# E[keV]  Fe_hardened[erg/s/cm2/keV]  Fe_bb[erg/s/cm2/keV]")
for e, s1, s2 in zip(E, spec_f.numpy(), spec_0.numpy()):
    print(f"{e:.5e}  {s1:.5e}  {s2:.5e}")
