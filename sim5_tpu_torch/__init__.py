"""sim5_tpu_torch -- the PyTorch / CUDA port of sim5_tpu.

The package mirrors `sim5_tpu`'s layout and names, so that each function's
counterpart sits at the same path.  It holds the Novikov-Thorne disk image,
the disk raytracing driver (thick-disk surface solves, `DiskRaytrace`
images and spectra, the differentiable spectrum fit), the equatorial
thin-disk products (the shadow, polarized images and spectra, line
profiles), the stepwise Kerr ray march and volume radiative transfer,
resumable spectral tables and frame checkpoints: the spacetime core
(`core`), the special functions with interpolation and tabulated
distributions (`special`, `utils`), the analytic geodesic engine
(`geodesic`), the thin disk, external compiled disks and the model
protocol (`disk`), blackbody emission (`radiation`), Walker-Penrose
transport (`polarization`), the march (`march`), the renderers and frame
checkpoints (`render`), the spectral tables (`tables`), the native
asynchronous writer (`native`) and the data parallelism over GPUs
(`parallel`: rows and rays sharded over a device mesh, the sharded fit
step), with three kernels written in CUDA C++
for Hopper and built by `_build.py` on first use: the march
(`csrc/march.cu`), the disk image (`csrc/disk_image.cu`) and its tangent
kernel (`csrc/disk_image_jvp.cu`).

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
from . import utils
from . import core
from . import special
from . import geodesic
from . import disk
from . import radiation
from . import polarization
from . import march
from . import render
from . import tables
from . import parallel

__version__ = "0.1.0"
