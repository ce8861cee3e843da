"""Characteristic orbit radii.  Port of `sim5_tpu/core/orbits.py` (the part
the stepwise march needs).

(reference: sim5kerr.c:980-1141)
"""

import torch

from .metric import _as_tensors


def r_bh(a):
    """Event horizon radius [rg].  (sim5kerr.c:981-989)"""
    a, = _as_tensors(a)
    return 1.0 + torch.sqrt(1.0 - a * a)
