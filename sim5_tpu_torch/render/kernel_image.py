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
an input requires grad.  The tangent kernel (`csrc/disk_image_jvp.cu`)
runs the pixel on duals of K tangent slots, each pixel's value chain and
the derivative rules' chains once for all slots.  The `jvp` (forward
mode, `torch.autograd.forward_ad`) launches its one-slot instance
`nt_image_jvp<T, 1>` once, which returns the images' tangents.  The
`backward` launches its reduction instance `nt_image_jvp<T, K, reduce>`
(and `nt_reduce<T>`) once, for all the columns that need grad
(`backward_launch`): the columns that enter the pixel's geodesic (a,
incl, rmax; `CHAIN_COLUMNS`) are the four-slot instance's first three
slots, and rms, which moves only the flux constants, its last, which the
geodesic does not carry.  It sums grad_f df_j + grad_g dg_j over each
frame's pixels in a fixed order, with grad_f f beside them, from which M
and mdot take their gradient (f is proportional to mdot / M).  The
columns are plain torch of the disk, so the gradient reaches `a` through
rms and the default rmax by autograd: a backward in (a, incl, mdot) is
one launch of the four-slot instance.  The tangent kernel replaces the
JAX package's autodiff of `render_disk_image` (XLA; no Pallas kernel);
its plain version is autograd through
`image.render_disk_image_reference`.

Row windows: every launch renders rows [row0, row0 + rows) of its (ny, nx)
frames (by default all of them), each pixel exactly as in the whole
frame (the grid, its aspect and rmax are the whole frame's), into (n,
rows, nx) images; a backward sums over the window's pixels.  A rank of
`parallel.render_disk_image_sharded` renders its rows so.  Every launch
helper below takes its window in one form: the arrays' rows (or, where
it allocates them, a `rows` argument) and the keywords row0 and ny, the
frame's rows (None: the window is the whole frame).

`LAUNCHES` counts launches by kernel: the prologue `nt_frames<T>` and
`nt_image<T>`, one each a forward launch, and `nt_frames_jvp<T, K>` with
`nt_image_jvp<T, K>` (forward mode) or `nt_image_jvp<T, K, reduce>` and
`nt_reduce<T>` (a backward).  The entry point's instance has no
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
# the tangent kernel's compiled slot counts (the library's
# sim5_nt_image_jvp_slots): one, for forward mode and a backward in one
# column, and the backward's, whose geodesic carries all its slots but the
# last
JVP_SLOTS = (1, 4)
# the frame columns (a, incl, M, mdot, rms, rmax) that enter the pixel's
# geodesic, and rms, which enters only the flux constants (M and mdot
# only scale the flux)
CHAIN_COLUMNS = (0, 1, 5)
RMS_COLUMN = 4


def _jvp_names(kernel, suffix=""):
    return {(dt, k): f"{kernel}<{v[len('nt_image<'):-1]}, {k}{suffix}>"
            for dt, v in VARIANTS.items() for k in JVP_SLOTS}


# the tangent kernel by (dtype, K): its prologue, its forward-mode
# instance, and the backward's reduction instance; and the backward's
# second pass by dtype
JVP_PROLOGUES = _jvp_names("nt_frames_jvp")
JVP_VARIANTS = _jvp_names("nt_image_jvp")
VJP_VARIANTS = _jvp_names("nt_image_jvp", ", reduce")
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

_LIB = _JVP_LIB = None
_P, _I = ctypes.c_void_p, ctypes.c_int
# (argtypes, restype) of the library's extern "C" functions
# (csrc/disk_image.cu)
SIGNATURES = {
    "sim5_nt_image": (
        [_I, _P, _P, _I, _P, _P,          # f64, scalars, work, n, f, g
         _I, _I, _I, _I,                  # nx, ny, row0, rows
         ctypes.c_double,                 # aspect
         _P, _P],                         # counters, stream
        _I),
    "sim5_nt_image_config": ([_P], None),
    "sim5_nt_image_attributes": ([_I, _I, _P], _I),
}
# the same of the tangent kernel's library (csrc/disk_image_jvp.cu)
JVP_SIGNATURES = {
    "sim5_nt_image_jvp": (
        [_I, _I, _P, _P, _P, _I,          # f64, K, scalars, tangents, work,
                                          # n
         _P, _P, _P, _P,                  # f, g, df, dg
         _P, _P, _P, _P,                  # grad_f, grad_g, partials, out
         _I, _I, _I, _I,                  # nx, ny, row0, rows
         ctypes.c_double, _P],            # aspect, stream
        _I),
    "sim5_nt_image_jvp_config": ([_I, _I, _I, _I, _I, _P], _I),
    "sim5_nt_image_jvp_slots": ([_P], None),
    "sim5_nt_image_jvp_attributes": ([_I, _I, _I, _P], _I),
}
# no FMA contraction: the error-free transforms need every rounding
NVCC_EXTRA = ("--fmad=false",)
# most frames a launch (the grid's second dimension)
MAX_FRAMES = 65535


def _load(name, signatures):
    from .._build import load
    lib = load(name, extra_flags=NVCC_EXTRA)
    for fname, (argtypes, restype) in signatures.items():
        fn = getattr(lib, fname)
        fn.argtypes, fn.restype = argtypes, restype
    return lib


def _lib():
    """The built disk image library, with its signatures declared."""
    global _LIB
    if _LIB is None:
        _LIB = _load("disk_image", SIGNATURES)
    return _LIB


def _jvp_lib():
    """The built tangent kernel's library, with its signatures declared."""
    global _JVP_LIB
    if _JVP_LIB is None:
        _JVP_LIB = _load("disk_image_jvp", JVP_SIGNATURES)
    return _JVP_LIB


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


def jvp_config(dtype, slots, reduce, nx, ny):
    """The tangent kernel's instance of `dtype` with `slots` tangent slots
    (the backward's reduction instance if `reduce`) for an (ny, nx) image:
    its blocks a frame (the backward's partial sums a frame), threads a
    block, minimum resident blocks, the scalars of a frame's dual
    constants in the work space, and the slots its geodesic carries."""
    out = (ctypes.c_int * 5)()
    rc = _jvp_lib().sim5_nt_image_jvp_config(
        int(dtype == torch.float64), int(slots), int(reduce), int(nx),
        int(ny), out)
    if rc != 0:
        raise ValueError(f"no tangent kernel of {slots} slots for {dtype}: "
                         f"cudaError {rc}")
    return dict(blocks=out[0], threads=out[1], min_blocks=out[2],
                frame_words=out[3], chain_slots=out[4])


def jvp_backward_slots():
    """(slots of the backward's instance, those its geodesic carries), as
    the library was compiled (JVP_SLOTS and CHAIN_COLUMNS mirror it)."""
    out = (ctypes.c_int * 2)()
    _jvp_lib().sim5_nt_image_jvp_slots(out)
    return out[0], out[1]


def jvp_attributes(dtype, slots=1, reduce=False):
    """Registers a thread, local memory a thread (bytes) and resident
    blocks an SM of the tangent kernel's instance for `dtype` with `slots`
    slots (the backward's reduction instance if `reduce`) on the current
    card."""
    out = (ctypes.c_int * 3)()
    rc = _jvp_lib().sim5_nt_image_jvp_attributes(
        int(dtype == torch.float64), int(slots), int(reduce), out)
    if rc != 0:
        name = (VJP_VARIANTS if reduce else JVP_VARIANTS)[dtype, slots]
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


def render_disk_image_cuda(disk, incl, npix_x=512, npix_y=512, rmax=None,
                           row0=0, rows=None):
    """`render_disk_image` of a disk on the card: one launch of
    `nt_image<T>` with T the disk's dtype, for one frame or a batch.
    Returns (image_f, image_g) of that dtype, each (rows, npix_x) for one
    frame and (n, rows, npix_x) for a batch of n: rows [row0, row0 + rows)
    of the (npix_y, npix_x) frames, all of them by default."""
    return _render(disk, incl, npix_x, npix_y, rmax, counted=False,
                   row0=row0, rows=rows)


def count_disk_image(disk, incl, npix_x=512, npix_y=512, rmax=None):
    """`render_disk_image_cuda` through the instance with the in-kernel
    counters, which `image_counters()` then reads: the same images, for
    measuring the kernel's stages and pixel classes."""
    return _render(disk, incl, npix_x, npix_y, rmax, counted=True)


def row_window(npix_y, row0=0, rows=None):
    """(row0, rows) of a window of an npix_y-row frame, checked; rows None
    is the rest of the frame."""
    row0 = int(row0)
    rows = int(npix_y) - row0 if rows is None else int(rows)
    if row0 < 0 or rows < 1 or row0 + rows > npix_y:
        raise ValueError(f"rows [{row0}, {row0 + rows}) of a frame of "
                         f"{npix_y} rows")
    return row0, rows


def _render(disk, incl, npix_x, npix_y, rmax, counted, row0=0, rows=None):
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
    row0, rows = row_window(npix_y, row0, rows)
    cols = [c.reshape(n) for c in frame_columns(disk, incl, rmax)]
    image_f, image_g = _NTImage.apply(*cols, npix_x, npix_y, counted, row0,
                                      rows)
    out = tuple(shape) + (rows, npix_x)
    return image_f.reshape(out), image_g.reshape(out)


class _NTImage(torch.autograd.Function):
    """The images of n frames from their six (n,) scalar columns (a, incl,
    M, mdot, rms, rmax), rows [row0, row0 + rows) of (ny, nx) frames (rows
    None: all ny): forward one launch of nt_image<T>; forward mode one
    launch of the tangent kernel's one-slot instance; backward one
    reduction launch for every column that needs grad (module docstring).
    The context is taken in forward, not in a setup_context, which costs
    the host several times more a call: the entry point renders one frame
    a call in about the kernel's own time (PERF.md)."""

    @staticmethod
    def forward(ctx, a, incl, M, mdot, rms, rmax, nx, ny, counted, row0=0,
                rows=None):
        cols = (a, incl, M, mdot, rms, rmax)
        frames = torch.stack(cols, -1).contiguous()
        n = frames.shape[0]
        rows = ny if rows is None else rows
        image_f = torch.empty((n, rows, nx), dtype=a.dtype, device=a.device)
        image_g = torch.empty_like(image_f)
        _launch(frames, image_f, image_g,
                new_counters(a.device) if counted else None, row0=row0,
                ny=ny)
        ctx.save_for_backward(*cols)
        ctx.save_for_forward(*cols)
        ctx.nx, ctx.ny, ctx.row0, ctx.rows = nx, ny, row0, rows
        return image_f, image_g

    @staticmethod
    def backward(ctx, grad_f, grad_g):
        cols = ctx.saved_tensors
        frames = torch.stack(cols, -1).contiguous()
        need = [c for c in range(6) if ctx.needs_input_grad[c]]
        grads = _backward(frames, grad_f.contiguous(), grad_g.contiguous(),
                          need, row0=ctx.row0, ny=ctx.ny)
        return (*(grads[:, c] if c in need else None for c in range(6)),
                *(None,) * (len(ctx.needs_input_grad) - 6))

    @staticmethod
    def jvp(ctx, *tangents):
        cols = ctx.saved_tensors
        frames = torch.stack(cols, -1).contiguous()
        tangent = torch.stack(tangents[:6], -1).to(frames.dtype)
        _, _, df, dg = _launch_jvp(frames, tangent[..., None].contiguous(),
                                   ctx.nx, ctx.rows, row0=ctx.row0,
                                   ny=ctx.ny)
        return df[:, 0], dg[:, 0]


def _check_frames(frames, *others):
    dt, dev = frames.dtype, frames.device
    if not frames.is_cuda or dt not in VARIANTS:
        raise ValueError(f"frames are {dt} on {dev}: the kernel takes "
                         "float64 or float32 on a CUDA device")
    for t in others:
        if t.dtype != dt or t.device != dev or not t.is_contiguous():
            raise ValueError(f"a {t.dtype} tensor on {t.device}: the "
                             f"kernel takes contiguous {dt} on {dev}")


def _slots(dt, tangent):
    """The slot count of an (n, 6, K) tangent matrix, if compiled."""
    n = tangent.shape[0]
    if tangent.dim() != 3 or tangent.shape[:2] != (n, 6):
        raise ValueError(f"a tangent matrix of shape {tuple(tangent.shape)}"
                         ": the kernel takes (n, 6, K)")
    k = tangent.shape[2]
    if k not in JVP_SLOTS:
        raise ValueError(f"{k} tangent slots: the tangent kernel is "
                         f"compiled for {JVP_SLOTS}")
    return k


def _launch_jvp(frames, tangent, nx, rows, row0=0, ny=None):
    """Forward mode in K directions: one launch of nt_frames_jvp<T, K> and
    nt_image_jvp<T, K> on the current stream, over rows [row0, row0 +
    rows) of (ny, nx) frames (ny None: rows, the whole frames).  frames
    (n, 6) and
    tangent (n, 6, K) of type T, K in JVP_SLOTS, or (n, 6) for K = 1; in
    the four-slot instance the geodesic does not carry the last slot, so
    it takes a tangent in rms alone (or M and mdot).  Returns (f, g, df,
    dg), f and g (n, rows, nx), df and dg (n, K, rows, nx), or (n, rows,
    nx) for an (n, 6) tangent."""
    flat = tangent.dim() == 2
    if flat:
        tangent = tangent[..., None]
    _check_frames(frames, tangent)
    k = _slots(frames.dtype, tangent)
    n = frames.shape[0]
    ny = rows if ny is None else int(ny)
    row0, rows = row_window(ny, row0, rows)
    dt, dev = frames.dtype, frames.device
    cfg = jvp_config(dt, k, False, nx, rows)
    work = torch.empty((n, cfg["frame_words"]), dtype=dt, device=dev)
    f, g = (torch.empty((n, rows, nx), dtype=dt, device=dev)
            for _ in range(2))
    df, dg = (torch.empty((n, k, rows, nx), dtype=dt, device=dev)
              for _ in range(2))
    rc = _jvp_lib().sim5_nt_image_jvp(
        int(dt == torch.float64), k, frames.data_ptr(), tangent.data_ptr(),
        work.data_ptr(), n, f.data_ptr(), g.data_ptr(), df.data_ptr(),
        dg.data_ptr(), None, None, None, None, nx, ny, row0, rows, ny / nx,
        torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{JVP_PROLOGUES[dt, k]} + {JVP_VARIANTS[dt, k]} "
                           f"launch failed: cudaError {rc}")
    LAUNCHES[JVP_PROLOGUES[dt, k]] += 1
    LAUNCHES[JVP_VARIANTS[dt, k]] += 1
    if flat:
        return f, g, df[:, 0], dg[:, 0]
    return f, g, df, dg


def _launch_vjp(frames, tangent, grad_f, grad_g, row0=0, ny=None):
    """The backward in K directions: one launch of nt_frames_jvp<T, K>,
    nt_image_jvp<T, K, reduce> and nt_reduce<T> on the current stream.
    frames (n, 6), tangent (n, 6, K) (as `_launch_jvp` takes it), grad_f
    and grad_g (n, rows, nx), the rows [row0, row0 + rows) of (ny, nx)
    frames (ny None: rows), all of type T; returns (n, K + 1) of type T:
    column j < K frame k's sum over the window's pixels of grad_f df_j +
    grad_g dg_j, column K that of grad_f f.  The sums are in a fixed
    order: the same inputs give the same bits."""
    _check_frames(frames, tangent, grad_f, grad_g)
    k = _slots(frames.dtype, tangent)
    n, rows, nx = grad_f.shape
    ny = rows if ny is None else int(ny)
    row0, rows = row_window(ny, row0, rows)
    dt, dev = frames.dtype, frames.device
    cfg = jvp_config(dt, k, True, nx, rows)
    work = torch.empty((n, cfg["frame_words"]), dtype=dt, device=dev)
    partials = torch.empty((n, cfg["blocks"], k + 1), dtype=dt, device=dev)
    out = torch.empty((n, k + 1), dtype=dt, device=dev)
    rc = _jvp_lib().sim5_nt_image_jvp(
        int(dt == torch.float64), k, frames.data_ptr(), tangent.data_ptr(),
        work.data_ptr(), n, None, None, None, None, grad_f.data_ptr(),
        grad_g.data_ptr(), partials.data_ptr(), out.data_ptr(), nx, ny,
        row0, rows, ny / nx, torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{VJP_VARIANTS[dt, k]} launch failed: "
                           f"cudaError {rc}")
    for name in (JVP_PROLOGUES[dt, k], VJP_VARIANTS[dt, k], REDUCES[dt]):
        LAUNCHES[name] += 1
    return out


def backward_launch(columns):
    """The one launch of a backward in the frame `columns` (of 0-5, at
    least one): (K, seeds), seeds[j] the column slot j is seeded with
    (None: a zero slot).  The one-slot instance where one column of the
    geodesic or rms needs grad, or only M or mdot (a zero seed: they take
    theirs from the sum of grad_f f); else the four-slot instance, with
    the columns of the geodesic that need grad in its first three slots
    and rms, where it does, in its last."""
    chain = [c for c in columns if c in CHAIN_COLUMNS]
    rms = [RMS_COLUMN] if RMS_COLUMN in columns else []
    if len(chain) + len(rms) <= 1:
        return 1, chain + rms or [None]
    k = JVP_SLOTS[-1]
    return k, chain + [None] * (k - 1 - len(chain)) + (rms or [None])


def _backward(frames, grad_f, grad_g, columns, row0=0, ny=None):
    """d/d frames of sum(grad_f image_f + grad_g image_g): (n, 6) of type
    T, the given columns filled, the others 0, from one launch
    (`backward_launch`); M and mdot take theirs from the sum of grad_f f
    (df/dmdot = f / mdot, df/dM = -f / M, g depends on neither).  grad_f
    and grad_g are (n, rows, nx), rows [row0, row0 + rows) of (ny, nx)
    frames (ny None: rows)."""
    n = frames.shape[0]
    dt, dev = frames.dtype, frames.device
    k, seeds = backward_launch(columns)
    tangent = torch.zeros((n, 6, k), dtype=dt, device=dev)
    for j, c in enumerate(seeds):
        if c is not None:
            tangent[:, c, j] = 1.0
    sums = _launch_vjp(frames, tangent, grad_f, grad_g, row0=row0, ny=ny)
    out = torch.zeros((n, 6), dtype=dt, device=dev)
    for j, c in enumerate(seeds):
        if c is not None:
            out[:, c] = sums[:, j]
    if 3 in columns:
        out[:, 3] = sums[:, k] / frames[:, 3]
    if 2 in columns:
        out[:, 2] = -sums[:, k] / frames[:, 2]
    return out


def new_counters(device):
    """Zeroed counters for a counted launch on `device`."""
    return torch.zeros((COUNTER_COPIES, len(COUNTERS), 2), dtype=torch.int64,
                       device=device)


def _launch(frames, image_f, image_g, counters=None, work=None, row0=0,
            ny=None):
    """One launch of nt_frames<T> (each frame's constants into `work`,
    (n, FRAME_WORDS) of type T, allocated here if None) and then
    nt_image<T> on the current stream: frames (n, 6), image_f and image_g
    (n, rows, nx), rows [row0, row0 + rows) of (ny, nx) frames (ny None:
    rows, the whole frames), all of type T and contiguous on one card.
    With `counters` (`new_counters`, added to), the counted instance."""
    n, rows, nx = image_f.shape
    ny = rows if ny is None else int(ny)
    row0, rows = row_window(ny, row0, rows)
    dt, dev = image_f.dtype, image_f.device
    if work is None:
        work = torch.empty((n, FRAME_WORDS), dtype=dt, device=dev)
    rc = _lib().sim5_nt_image(
        int(dt == torch.float64), frames.data_ptr(), work.data_ptr(), n,
        image_f.data_ptr(), image_g.data_ptr(), nx, ny, row0, rows,
        ny / nx, None if counters is None else counters.data_ptr(),
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
