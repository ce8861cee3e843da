"""sim5_tpu_torch -- the PyTorch / CUDA port of sim5_tpu.

The package mirrors `sim5_tpu`'s layout and names, so that each function's
counterpart sits at the same path.  It holds the stepwise Kerr ray march
and volume radiative transfer: the spacetime core (`core`), the special
functions (`special`) and the analytic geodesic engine (`geodesic`) that
seed the march, the march itself (`march`) with its kernel written in CUDA
C++ for Hopper (`csrc/march.cu`, built by `_build.py` on first use), and
the volume renderer (`render`).

Design notes
------------
* Plain functions on tensors; dataclasses of tensors where sim5_tpu has
  pytrees.  The device is taken from the input tensors; an entry point
  given no tensor puts its data on the card unless the caller asks for
  the CPU (`device="cpu"`).
* Importing the package changes no torch global: dtype follows the inputs
  (f64 in, f64 out; f32 in, f32 out).  This takes the place of sim5_tpu's
  `jax_enable_x64` switch and its `fast_precision()` context.
* The package imports neither `jax` nor `sim5_tpu`; only the tests do, to
  hold the port against the reference.
"""

from . import consts
from . import core
from . import special
from . import geodesic
from . import march
from . import render

__version__ = "0.1.0"
