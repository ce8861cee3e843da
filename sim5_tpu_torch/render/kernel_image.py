"""The disk image kernel: n frames of the NT image in one launch, and its
derivative kernel.

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
round trip and one build serves every spin.

Gradients: the launch is a `torch.autograd.Function` (`_NTImage`) of the
six frame columns.  Its forward is the one launch above, whether or not
an input requires grad.  Its `jvp` (forward mode, `torch.autograd.
forward_ad`) launches the tangent kernel `nt_image_jvp<T>` once, which
returns the images' tangents; its `backward` launches the tangent
kernel's reduction instance `nt_image_jvp<T, reduce>` (and `nt_reduce<T>`)
once for each column that needs grad, which sums grad_f df + grad_g dg
over each frame's pixels in a fixed order.  The columns are plain torch
of the disk, so the gradient reaches `a` through rms and the default rmax
by autograd.  The tangent kernel replaces the JAX package's autodiff of
`render_disk_image` (XLA; no Pallas kernel); its plain version is
autograd through `image.render_disk_image_reference`.

`LAUNCHES` counts launches by kernel: the prologue `nt_frames<T>` and
`nt_image<T>`, one each a forward launch, and `nt_frames_jvp<T>` with
`nt_image_jvp<T>` (forward mode) or `nt_image_jvp<T, reduce>` and
`nt_reduce<T>` (a backward column).  The entry point's instance has no
counters; `count_disk_image` renders through the instance with in-kernel
counters compiled in (the same bits, 4-7% slower), and `image_counters()`
reads them.
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
# the tangent kernel: its prologue, its forward-mode instance, and the
# backward's reduction instance and second pass
JVP_PROLOGUES = {dt: v.replace("nt_image", "nt_frames_jvp")
                 for dt, v in VARIANTS.items()}
JVP_VARIANTS = {dt: v.replace("nt_image", "nt_image_jvp")
                for dt, v in VARIANTS.items()}
VJP_VARIANTS = {dt: v[:-1] + ", reduce>" for dt, v in JVP_VARIANTS.items()}
REDUCES = {dt: v.replace("nt_image", "nt_reduce")
           for dt, v in VARIANTS.items()}
LAUNCHES = dict.fromkeys([*PROLOGUES.values(), *VARIANTS.values(),
                          *COUNTED.values(), *JVP_PROLOGUES.values(),
                          *JVP_VARIANTS.values(), *VJP_VARIANTS.values(),
                          *REDUCES.values()], 0)

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
    "sim5_nt_image_jvp": (
        [_I, _P, _P, _P, _I,              # f64, scalars, tangents, work, n
         _P, _P, _P, _P,                  # f, g, df, dg
         _P, _P, _P, _P, _I,              # grad_f, grad_g, partials, out,
                                          # stride
         _I, _I, ctypes.c_double, _P],    # nx, ny, aspect, stream
        _I),
    "sim5_nt_image_jvp_config": ([_I, _I, _P], None),
    "sim5_nt_image_jvp_attributes": ([_I, _I, _P], _I),
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


def jvp_config(nx, ny):
    """The tangent kernel's blocks a frame of an (ny, nx) image (its
    backward's partial sums a frame), threads a block, and the scalars of
    a frame's dual constants."""
    out = (ctypes.c_int * 3)()
    _lib().sim5_nt_image_jvp_config(int(nx), int(ny), out)
    return dict(blocks=out[0], threads=out[1], frame_words=out[2])


def jvp_attributes(dtype, reduce=False):
    """Registers a thread, local memory a thread (bytes) and resident
    blocks an SM of the tangent kernel's instance for `dtype` (the
    backward's reduction instance if `reduce`) on the current card."""
    out = (ctypes.c_int * 3)()
    rc = _lib().sim5_nt_image_jvp_attributes(int(dtype == torch.float64),
                                             int(reduce), out)
    if rc != 0:
        name = (VJP_VARIANTS if reduce else JVP_VARIANTS)[dtype]
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


def frame_columns(disk, incl, rmax=None):
    """The frames' scalars a, incl, M, mdot, rms, rmax in the disk's dtype,
    on its device, computed there: six tensors of the batch shape
    (`batch_shape`), differentiable in the disk's and the view's tensors.
    The default rmax is (rms - 1e-3) + 8, as the plain version computes
    it."""
    a = disk.a
    dt, dev = a.dtype, a.device
    shape = batch_shape(disk, incl, rmax)

    def column(v):
        if not isinstance(v, torch.Tensor):
            v = torch.full((), float(v), dtype=dt, device=dev)
        return v.to(dtype=dt, device=dev).broadcast_to(shape)

    rmax = (disk.rms - 1e-3) + 8.0 if rmax is None else rmax
    return tuple(column(v) for v in (a, incl, disk.M, disk.mdot, disk.rms,
                                     rmax))


def frame_scalars(disk, incl, rmax=None):
    """`frame_columns` stacked: (6,) for one frame, (n, 6) for a batch of
    n."""
    return torch.stack(frame_columns(disk, incl, rmax), dim=-1)


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
        t = getattr(disk, name)
        if t.dtype != dt or t.device != dev:
            raise ValueError(f"disk.{name} is {t.dtype} on {t.device}; the "
                             f"kernel takes {dt} on {dev}")
    if not 1 <= n <= MAX_FRAMES:
        raise ValueError(f"{n} frames: a launch takes 1 to {MAX_FRAMES}")
    npix_x, npix_y = int(npix_x), int(npix_y)
    if npix_x < 1 or npix_y < 1 or npix_x * npix_y >= 2 ** 31:
        raise ValueError(f"image of {npix_x} x {npix_y} pixels")
    cols = [c.reshape(n) for c in frame_columns(disk, incl, rmax)]
    image_f, image_g = _NTImage.apply(*cols, npix_x, npix_y, counted)
    out = tuple(shape) + (npix_y, npix_x)
    return image_f.reshape(out), image_g.reshape(out)


class _NTImage(torch.autograd.Function):
    """The images of n frames from their six (n,) scalar columns (a, incl,
    M, mdot, rms, rmax): forward one launch of nt_image<T>; forward mode
    one launch of the tangent kernel; backward one reduction launch a
    column that needs grad (module docstring).  The context is taken in
    forward, not in a setup_context, which costs the host several times
    more a call: the entry point renders one frame a call in about the
    kernel's own time (PERF.md)."""

    @staticmethod
    def forward(ctx, a, incl, M, mdot, rms, rmax, nx, ny, counted):
        cols = (a, incl, M, mdot, rms, rmax)
        frames = torch.stack(cols, -1).contiguous()
        n = frames.shape[0]
        image_f = torch.empty((n, ny, nx), dtype=a.dtype, device=a.device)
        image_g = torch.empty_like(image_f)
        _launch(frames, image_f, image_g,
                new_counters(a.device) if counted else None)
        ctx.save_for_backward(*cols)
        ctx.save_for_forward(*cols)
        ctx.nx, ctx.ny = nx, ny
        return image_f, image_g

    @staticmethod
    def backward(ctx, grad_f, grad_g):
        cols = ctx.saved_tensors
        frames = torch.stack(cols, -1).contiguous()
        need = [c for c in range(6) if ctx.needs_input_grad[c]]
        grads = _backward(frames, grad_f.contiguous(), grad_g.contiguous(),
                          need)
        return (*(grads[:, c] if c in need else None for c in range(6)),
                None, None, None)

    @staticmethod
    def jvp(ctx, *tangents):
        cols = ctx.saved_tensors
        frames = torch.stack(cols, -1).contiguous()
        tangent = torch.stack(tangents[:6], -1).to(frames.dtype).contiguous()
        _, _, df, dg = _launch_jvp(frames, tangent, ctx.nx, ctx.ny)
        return df, dg


def _check_frames(frames, *others):
    dt, dev = frames.dtype, frames.device
    if not frames.is_cuda or dt not in VARIANTS:
        raise ValueError(f"frames are {dt} on {dev}: the kernel takes "
                         "float64 or float32 on a CUDA device")
    for t in others:
        if t.dtype != dt or t.device != dev or not t.is_contiguous():
            raise ValueError(f"a {t.dtype} tensor on {t.device}: the "
                             f"kernel takes contiguous {dt} on {dev}")


def _launch_jvp(frames, tangent, nx, ny):
    """Forward mode: one launch of nt_frames_jvp<T> and nt_image_jvp<T> on
    the current stream.  frames and tangent (n, 6) of type T; returns
    (f, g, df, dg), each (n, ny, nx)."""
    _check_frames(frames, tangent)
    n = frames.shape[0]
    dt, dev = frames.dtype, frames.device
    cfg = jvp_config(nx, ny)
    work = torch.empty((n, cfg["frame_words"]), dtype=dt, device=dev)
    f, g, df, dg = (torch.empty((n, ny, nx), dtype=dt, device=dev)
                    for _ in range(4))
    rc = _lib().sim5_nt_image_jvp(
        int(dt == torch.float64), frames.data_ptr(), tangent.data_ptr(),
        work.data_ptr(), n, f.data_ptr(), g.data_ptr(), df.data_ptr(),
        dg.data_ptr(), None, None, None, None, 0, nx, ny, ny / nx,
        torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{JVP_PROLOGUES[dt]} + {JVP_VARIANTS[dt]} launch "
                           f"failed: cudaError {rc}")
    LAUNCHES[JVP_PROLOGUES[dt]] += 1
    LAUNCHES[JVP_VARIANTS[dt]] += 1
    return f, g, df, dg


def _backward(frames, grad_f, grad_g, columns):
    """d/d frames of sum(grad_f image_f + grad_g image_g): (n, 6) of type
    T, the given columns filled (one launch of nt_frames_jvp<T>,
    nt_image_jvp<T, reduce> and nt_reduce<T> each), the others 0.  The
    sums are in a fixed order: the same inputs give the same bits."""
    n, ny, nx = grad_f.shape
    _check_frames(frames, grad_f, grad_g)
    dt, dev = frames.dtype, frames.device
    cfg = jvp_config(nx, ny)
    work = torch.empty((n, cfg["frame_words"]), dtype=dt, device=dev)
    partials = torch.empty((n, cfg["blocks"]), dtype=dt, device=dev)
    out = torch.zeros((n, 6), dtype=dt, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    for c in columns:
        tangent = torch.zeros((n, 6), dtype=dt, device=dev)
        tangent[:, c] = 1.0
        rc = _lib().sim5_nt_image_jvp(
            int(dt == torch.float64), frames.data_ptr(), tangent.data_ptr(),
            work.data_ptr(), n, None, None, None, None, grad_f.data_ptr(),
            grad_g.data_ptr(), partials.data_ptr(),
            out.data_ptr() + c * out.element_size(), 6, nx, ny, ny / nx,
            stream)
        if rc != 0:
            raise RuntimeError(f"{VJP_VARIANTS[dt]} launch failed: "
                               f"cudaError {rc}")
        for name in (JVP_PROLOGUES, VJP_VARIANTS, REDUCES):
            LAUNCHES[name[dt]] += 1
    return out


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
