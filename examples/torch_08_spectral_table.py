"""Resumable spectral-table generation over a (spin, mdot, incl) grid,
through the PyTorch port on a CUDA device (example 08's grid).

Run twice to see resume-from-checkpoint in action:
    python examples/torch_08_spectral_table.py table.npz [device]

`device` defaults to cuda; pass cpu to run on the host.
"""

import pathlib as _pl
import sys as _sys
_sys.path.insert(0, str(_pl.Path(__file__).resolve().parent.parent))

import os
import sys

import numpy as np

from sim5_tpu_torch.tables import generate_disk_table

path = sys.argv[1] if len(sys.argv) > 1 else "disk_table.npz"
device = sys.argv[2] if len(sys.argv) > 2 else "cuda"
FAST = bool(os.environ.get("SIM5_FAST"))  # tiny-shape CI mode
E = np.geomspace(0.1, 30.0, 8 if FAST else 64)
table = generate_disk_table(
    path,
    spins=[0.5] if FAST else [0.0, 0.5, 0.9],
    mdots=[0.1] if FAST else [0.05, 0.1, 0.3],
    incls=[60.0] if FAST else [30.0, 60.0, 75.0],
    energies=E,
    radres=1.2 if FAST else 0.5, angres=10.0 if FAST else 20.0,
    verbose=True, device=device,
)
done, total = table.progress
print(f"table {path}: {done}/{total} rows computed", file=sys.stderr)
