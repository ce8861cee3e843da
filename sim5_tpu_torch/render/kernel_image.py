"""The disk image kernel: n frames of the NT image in one launch.

`render_disk_image_cuda` runs `nt_image<double>` (the f64 parity path) or
`nt_image<float>` (the f32 fast path) of `csrc/disk_image.cu` on the
current stream, by the disk's dtype.  It has no Pallas twin: the JAX
package leaves this program to XLA (`sim5_tpu/render/image.py:35-75`).
Its plain torch version is `image.render_disk_image_reference`.

A disk whose M, a, mdot and rms are (n,) tensors (`nt_setup` over a vector
of spins), with the inclination and rmax scalars or one value a frame, is
n frames: the port's form of `jax.vmap` / `jax.lax.map` over the JAX
package's `render_disk_image`, in one launch.  The frames' scalars (a,
incl, M, mdot, rms, rmax) go to the kernel as an (n, 6) tensor on the
card, built by torch ops from the disk's tensors, so a frame needs no host
round trip and one build serves every spin.  The kernel is forward only:
inputs that require grad raise.  `LAUNCHES` counts launches by kernel: the
prologue `nt_frames<T>` and `nt_image<T>`, one each a launch.  The entry
point's instance has no counters; `count_disk_image` renders through the
instance with in-kernel counters compiled in (the same bits, 4-7% slower),
and `image_counters()` reads them.
"""

import ctypes

import torch

VARIANTS = {torch.float64: "nt_image<double>",
            torch.float32: "nt_image<float>"}
# the prologue launched before each instance, and the instance with the
# counters
PROLOGUES = {dt: v.replace("nt_image", "nt_frames")
             for dt, v in VARIANTS.items()}
COUNTED = {dt: v[:-1] + ", counted>" for dt, v in VARIANTS.items()}
LAUNCHES = dict.fromkeys([*PROLOGUES.values(), *VARIANTS.values(),
                          *COUNTED.values()], 0)

# the counters' slots, in the order of sim5::Slot (csrc/analytic.cuh): the
# stages (the init, R_roots' rf and K, the order-0 inversion, the order-1
# pass, the shading), the inversions of each order by trajectory type,
# the pixels by type, hit order, dark, and status code
COUNTERS = (
    "pixels", "rf_R", "K_R", "rad0", "order1", "shade",
    "rad0_RR", "rad0_RC", "rad0_CC", "rad1_RR", "rad1_RC", "rad1_CC",
    "type_RR", "type_RR_BH", "type_RR_double", "type_RC", "type_CC",
    "hit0", "hit1", "dark",
    "status_0", "status_3", "status_4", "status_7", "status_8", "status_9",
    "status_10", "status_11", "status_12")
# copies of the counters in device memory (the kernel's kCounterCopies),
# summed when read
COUNTER_COPIES = 64
# scalars in a frame's constants (the kernel's kFrameWords): the launch's
# work space is this many a frame, of the image's type
FRAME_WORDS = 18
# the counters of the last counted launch, (COUNTER_COPIES, len(COUNTERS),
# 2) int64 on the device: warps with a lane counted, and lanes
LAST_COUNTERS = None

_LIB = None
_P, _I = ctypes.c_void_p, ctypes.c_int
# (argtypes, restype) of the library's extern "C" functions
# (csrc/disk_image.cu)
SIGNATURES = {
    "sim5_nt_image": (
        [_I, _P, _P, _I, _P, _P,          # f64, scalars, work, n, f, g
         _I, _I, ctypes.c_double,         # nx, ny, aspect
         _P, _P],                         # counters, stream
        _I),
    "sim5_nt_image_config": ([_P], None),
    "sim5_nt_image_attributes": ([_I, _I, _P], _I),
}
# no FMA contraction: the error-free transforms need every rounding
NVCC_EXTRA = ("--fmad=false",)
# most frames a launch (the grid's second dimension)
MAX_FRAMES = 65535


def _lib():
    """The built disk image library, with its signatures declared."""
    global _LIB
    if _LIB is None:
        from .._build import load
        lib = load("disk_image", extra_flags=NVCC_EXTRA)
        for name, (argtypes, restype) in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes, fn.restype = argtypes, restype
        _LIB = lib
    return _LIB


def kernel_config():
    """The kernel's compile-time choices: threads a block, the block's
    pixel tile, the counters' slots and copies, each instance's minimum
    resident blocks, and the scalars of a frame's constants."""
    out = (ctypes.c_int * 8)()
    _lib().sim5_nt_image_config(out)
    return dict(threads=out[0], tile=(out[1], out[2]), slots=out[3],
                counter_copies=out[4],
                min_blocks={"nt_image<double>": out[5],
                            "nt_image<float>": out[6]},
                frame_words=out[7])


def kernel_attributes(dtype, counted=False):
    """Registers a thread, local memory a thread (bytes) and resident
    blocks an SM of the instance for `dtype` (the counted one if
    `counted`) on the current card."""
    out = (ctypes.c_int * 3)()
    rc = _lib().sim5_nt_image_attributes(int(dtype == torch.float64),
                                         int(counted), out)
    if rc != 0:
        name = (COUNTED if counted else VARIANTS)[dtype]
        raise RuntimeError(f"{name} attributes: cudaError {rc}")
    return dict(registers=out[0], local_bytes=out[1], blocks_per_sm=out[2])


def image_counters():
    """{slot: (warps, lanes)} of the last `count_disk_image`: per stage,
    the warps that entered it (each entry runs the stage's chain once) and
    the lanes that did; per class, the warps that held such a pixel and
    the pixels.  A stage's lane use is lanes / (32 warps).  Reads the
    device."""
    rows = LAST_COUNTERS.sum(0).tolist()
    return {name: tuple(v) for name, v in zip(COUNTERS, rows)}


def batch_shape(disk, incl, rmax=None):
    """The frames' batch shape: () for one frame, (n,) for n, the shapes
    of the disk's M, a, mdot and rms and of incl and rmax broadcast."""
    shapes = [t.shape for t in (disk.M, disk.a, disk.mdot, disk.rms)]
    shapes += [v.shape for v in (incl, rmax) if isinstance(v, torch.Tensor)]
    try:
        shape = torch.broadcast_shapes(*shapes)
    except RuntimeError as e:
        raise ValueError(f"the disk's and the view's batch shapes "
                         f"{[tuple(s) for s in shapes]} do not broadcast: "
                         f"{e}") from None
    if len(shape) > 1:
        raise ValueError(f"a batch of frames is one dimension, not "
                         f"{tuple(shape)}")
    return shape


def frame_scalars(disk, incl, rmax=None):
    """The frames' scalars a, incl, M, mdot, rms, rmax in the disk's dtype,
    on its device, computed there: (6,) for one frame, (n, 6) for a batch
    of n (`batch_shape`).  The default rmax is (rms - 1e-3) + 8, as the
    plain version computes it."""
    a = disk.a
    dt, dev = a.dtype, a.device
    shape = batch_shape(disk, incl, rmax)

    def column(v):
        if not isinstance(v, torch.Tensor):
            v = torch.full((), float(v), dtype=dt, device=dev)
        return v.to(dtype=dt, device=dev).broadcast_to(shape)

    rmax = (disk.rms - 1e-3) + 8.0 if rmax is None else rmax
    return torch.stack([column(v) for v in (a, incl, disk.M, disk.mdot,
                                            disk.rms, rmax)], dim=-1)


def render_disk_image_cuda(disk, incl, npix_x=512, npix_y=512, rmax=None):
    """`render_disk_image` of a disk on the card: one launch of
    `nt_image<T>` with T the disk's dtype, for one frame or a batch.
    Returns (image_f, image_g) of that dtype, each (npix_y, npix_x) for
    one frame and (n, npix_y, npix_x) for a batch of n."""
    return _render(disk, incl, npix_x, npix_y, rmax, counted=False)


def count_disk_image(disk, incl, npix_x=512, npix_y=512, rmax=None):
    """`render_disk_image_cuda` through the instance with the in-kernel
    counters, which `image_counters()` then reads: the same images, for
    measuring the kernel's stages and pixel classes."""
    return _render(disk, incl, npix_x, npix_y, rmax, counted=True)


def _render(disk, incl, npix_x, npix_y, rmax, counted):
    inputs = {"M": disk.M, "a": disk.a, "mdot": disk.mdot, "rms": disk.rms,
              "alpha": disk.alpha, "incl": incl, "rmax": rmax}
    for name, v in inputs.items():
        if isinstance(v, torch.Tensor) and v.requires_grad:
            raise RuntimeError(f"{name} requires grad: the disk image kernel "
                               "is forward only; render a CPU disk for "
                               "gradients")
    shape = batch_shape(disk, incl, rmax)
    n = shape.numel()
    dev, dt = disk.a.device, disk.a.dtype
    if not disk.a.is_cuda:
        raise ValueError(f"the disk is on {dev}, the kernel needs a CUDA "
                         "device")
    if dt not in VARIANTS:
        raise TypeError(f"the disk image kernel takes float64 or float32, "
                        f"not {dt}")
    for name in ("M", "a", "mdot", "rms"):
        t = inputs[name]
        if t.dtype != dt or t.device != dev:
            raise ValueError(f"disk.{name} is {t.dtype} on {t.device}; the "
                             f"kernel takes {dt} on {dev}")
    if not 1 <= n <= MAX_FRAMES:
        raise ValueError(f"{n} frames: a launch takes 1 to {MAX_FRAMES}")
    npix_x, npix_y = int(npix_x), int(npix_y)
    if npix_x < 1 or npix_y < 1 or npix_x * npix_y >= 2 ** 31:
        raise ValueError(f"image of {npix_x} x {npix_y} pixels")
    frames = frame_scalars(disk, incl, rmax).reshape(n, 6).contiguous()
    image_f = torch.empty((n, npix_y, npix_x), dtype=dt, device=dev)
    image_g = torch.empty_like(image_f)
    _launch(frames, image_f, image_g, new_counters(dev) if counted else None)
    out = tuple(shape) + (npix_y, npix_x)
    return image_f.reshape(out), image_g.reshape(out)


def new_counters(device):
    """Zeroed counters for a counted launch on `device`."""
    return torch.zeros((COUNTER_COPIES, len(COUNTERS), 2), dtype=torch.int64,
                       device=device)


def _launch(frames, image_f, image_g, counters=None, work=None):
    """One launch of nt_frames<T> (each frame's constants into `work`,
    (n, FRAME_WORDS) of type T, allocated here if None) and then
    nt_image<T> on the current stream: frames (n, 6), image_f and image_g
    (n, ny, nx), all of type T and contiguous on one card.  With
    `counters` (`new_counters`, added to), the counted instance."""
    n, ny, nx = image_f.shape
    dt, dev = image_f.dtype, image_f.device
    if work is None:
        work = torch.empty((n, FRAME_WORDS), dtype=dt, device=dev)
    rc = _lib().sim5_nt_image(
        int(dt == torch.float64), frames.data_ptr(), work.data_ptr(), n,
        image_f.data_ptr(), image_g.data_ptr(), nx, ny, ny / nx,
        None if counters is None else counters.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    name = (VARIANTS if counters is None else COUNTED)[dt]
    if rc != 0:
        raise RuntimeError(f"{PROLOGUES[dt]} + {name} launch failed: "
                           f"cudaError {rc}")
    LAUNCHES[PROLOGUES[dt]] += 1
    LAUNCHES[name] += 1
    if counters is not None:
        global LAST_COUNTERS
        LAST_COUNTERS = counters
