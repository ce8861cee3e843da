"""The disk image kernel: one frame of the NT image in one launch.

`render_disk_image_cuda` runs `nt_image<double>` (the f64 parity path) or
`nt_image<float>` (the f32 fast path) of `csrc/disk_image.cu` on the
current stream, by the disk's dtype.  It has no Pallas twin: the JAX
package leaves this program to XLA (`sim5_tpu/render/image.py:35-75`).
Its plain torch version is `image.render_disk_image_reference`.

The frame's scalars (a, incl, M, mdot, rms, rmax) go to the kernel as a
small tensor on the card, built by torch ops from the disk's tensors, so
a frame needs no host round trip and one build serves every spin.  The
kernel is forward only: inputs that require grad raise.  `LAUNCHES`
counts launches by instance.
"""

import ctypes

import torch

VARIANTS = {torch.float64: "nt_image<double>",
            torch.float32: "nt_image<float>"}
LAUNCHES = dict.fromkeys(VARIANTS.values(), 0)

_LIB = None
_P, _I = ctypes.c_void_p, ctypes.c_int
# (argtypes, restype) of the library's extern "C" functions
# (csrc/disk_image.cu)
SIGNATURES = {
    "sim5_nt_image": (
        [_I, _P, _P, _P,                  # f64, frame, image_f, image_g
         _I, _I, ctypes.c_double, _P],    # nx, ny, aspect, stream
        _I),
    "sim5_nt_image_attributes": ([_I, _P], _I),
}
# no FMA contraction: the error-free transforms need every rounding
NVCC_EXTRA = ("--fmad=false",)


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


def kernel_attributes(dtype):
    """Registers a thread, local memory a thread (bytes) and resident
    blocks an SM of the instance for `dtype` on the current card."""
    out = (ctypes.c_int * 3)()
    rc = _lib().sim5_nt_image_attributes(int(dtype == torch.float64), out)
    if rc != 0:
        raise RuntimeError(f"{VARIANTS[dtype]} attributes: cudaError {rc}")
    return dict(registers=out[0], local_bytes=out[1], blocks_per_sm=out[2])


def frame_scalars(disk, incl, rmax=None):
    """(6,) tensor of the frame's scalars a, incl, M, mdot, rms, rmax in
    the disk's dtype, on its device, computed there: the default rmax is
    (rms - 1e-3) + 8, as the plain version computes it."""
    a = disk.a
    dt, dev = a.dtype, a.device

    def scalar(v):
        if isinstance(v, torch.Tensor):
            return v.to(dtype=dt, device=dev).reshape(())
        return torch.full((), float(v), dtype=dt, device=dev)

    rmax = (disk.rms - 1e-3) + 8.0 if rmax is None else scalar(rmax)
    return torch.stack([a.reshape(()), scalar(incl), disk.M.reshape(()),
                        disk.mdot.reshape(()), disk.rms.reshape(()),
                        rmax.reshape(())])


def render_disk_image_cuda(disk, incl, npix_x=512, npix_y=512, rmax=None):
    """`render_disk_image` of a disk on the card: one launch of
    `nt_image<T>` with T the disk's dtype.  Returns (image_f, image_g),
    each (npix_y, npix_x) of that dtype."""
    inputs = {"M": disk.M, "a": disk.a, "mdot": disk.mdot, "rms": disk.rms,
              "alpha": disk.alpha, "incl": incl, "rmax": rmax}
    for name, v in inputs.items():
        if isinstance(v, torch.Tensor) and v.requires_grad:
            raise RuntimeError(f"{name} requires grad: the disk image kernel "
                               "is forward only; render a CPU disk for "
                               "gradients")
    dev, dt = disk.a.device, disk.a.dtype
    if not disk.a.is_cuda:
        raise ValueError(f"the disk is on {dev}, the kernel needs a CUDA "
                         "device")
    if dt not in VARIANTS:
        raise TypeError(f"the disk image kernel takes float64 or float32, "
                        f"not {dt}")
    for name in ("M", "a", "mdot", "rms"):
        t = inputs[name]
        if t.dtype != dt or t.device != dev or t.numel() != 1:
            raise ValueError(f"disk.{name} is {t.dtype} {tuple(t.shape)} on "
                             f"{t.device}; the kernel takes one {dt} value "
                             f"on {dev}")
    npix_x, npix_y = int(npix_x), int(npix_y)
    if npix_x < 1 or npix_y < 1 or npix_x * npix_y >= 2 ** 31:
        raise ValueError(f"image of {npix_x} x {npix_y} pixels")
    frame = frame_scalars(disk, incl, rmax)
    image_f = torch.empty((npix_y, npix_x), dtype=dt, device=dev)
    image_g = torch.empty_like(image_f)
    rc = _lib().sim5_nt_image(
        int(dt == torch.float64), frame.data_ptr(), image_f.data_ptr(),
        image_g.data_ptr(), npix_x, npix_y, npix_y / npix_x,
        torch.cuda.current_stream(dev).cuda_stream)
    name = VARIANTS[dt]
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {rc}")
    LAUNCHES[name] += 1
    return image_f, image_g
