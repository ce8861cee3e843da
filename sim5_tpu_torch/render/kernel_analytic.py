"""The analytic engine's kernels: the equatorial crossing map and the volume
seed, one pixel a thread.

`crossing_maps` runs `crossing_map<double>` of `csrc/crossing_map.cu` for
a list of image orders in one launch (blockIdx.y is the order), and
`volume_seed_rays` runs `volume_seed<T, azm>` of `csrc/volume_seed.cu`
(T the seed's dtype; azm false for the axisymmetric seed, whose phi0 is
0).  Each thread branches on its own trajectory type and computes only
the branch it takes (`csrc/azimuth.cuh`).  Neither has a Pallas twin:
they replace the JAX package's XLA programs `equatorial_crossing_map` and
`_volume_seed_geom` / `_azm` / `_pack` (`sim5_tpu/render/lightcurve.py:
33-75, 113-167`).

On a CPU device each function runs its plain torch version,
`lightcurve._crossing_map_unanchored` and `lightcurve._volume_seed_plain`:
the same outputs, computed by the masked torch chain.  On the card it
launches its kernel or raises.  The kernels have no derivative: the entry
points (`lightcurve.equatorial_crossing_map`, `_volume_seed`) run the
plain chain under autograd when an input requires grad.

The CC rule's 16 Gauss-Legendre nodes, weights and 7 panel edges are the
plain version's own (`geodesic.analytic._GL16_X`, `_GL16_W`,
`_CC_PANELS`), passed to each launch as an argument.

`LAUNCHES` counts each kernel's launches.  `operation_counts` runs the
kernels' per-pixel functions on the host's cores on a counting scalar
(`csrc/analytic_ops.cpp`, built with g++): the operations a launch's
pixels execute, by precision and kind, for the kernels' bound.
"""

import ctypes

import numpy as np
import torch

CROSSING = "crossing_map<double>"
SEEDS = {(dt, azm): f"volume_seed<{n}, {str(azm).lower()}>"
         for dt, n in ((torch.float64, "double"), (torch.float32, "float"))
         for azm in (True, False)}
LAUNCHES = dict.fromkeys([CROSSING, *SEEDS.values()], 0)

_P, _I, _D = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
# (argtypes, restype) of each library's extern "C" functions
CROSSING_SIGNATURES = {
    "sim5_crossing_map": (
        [_D, _D, _D, _D, _I, _I,          # a, incl, rmax, rms, n, n_orders
         _P, _P,                          # orders, gauss (host)
         _P, _P, _P, _P, _P, _P],         # r, phi, g, dt, hit, stream
        _I),
    "sim5_crossing_map_attributes": ([_P], _I),
}
SEED_SIGNATURES = {
    "sim5_volume_seed": (
        [_I, _I, _D, _D, _D, _D, _D, _I,  # f64, azm, a, incl, rmax,
                                          # r_start, t0, n
         _P, _P, _P, _P, _P],             # gauss (host), x0, k, ok, stream
        _I),
    "sim5_volume_seed_attributes": ([_I, _I, _P], _I),
}
# most orders a crossing-map launch takes (the kernel's kMaxOrders); more
# are launched in groups of this many
MAX_ORDERS = 8
# no FMA contraction: the error-free transforms need every rounding
NVCC_EXTRA = ("--fmad=false",)
_LIBS = {}
# the operation counter's kinds, in the order of csrc/analytic_ops.cpp
OP_KINDS = ("add", "mul", "div", "sqrt", "transcendental")


def _lib(name):
    """The built library `name` (crossing_map or volume_seed), with its
    signatures declared."""
    if name not in _LIBS:
        from .._build import load
        sigs = {"crossing_map": CROSSING_SIGNATURES,
                "volume_seed": SEED_SIGNATURES}[name]
        lib = load(name, extra_flags=NVCC_EXTRA)
        for fname, (argtypes, restype) in sigs.items():
            fn = getattr(lib, fname)
            fn.argtypes, fn.restype = argtypes, restype
        _LIBS[name] = lib
    return _LIBS[name]


def gauss_rule():
    """The CC rule as the kernels take it: 16 nodes, 16 weights, 7 panel
    edges, f64 on the host."""
    from ..geodesic.analytic import _GL16_X, _GL16_W, _CC_PANELS
    return np.ascontiguousarray(np.concatenate(
        [_GL16_X, _GL16_W, _CC_PANELS]), dtype=np.float64)


def kernel_attributes(name):
    """Registers a thread, local memory a thread (bytes) and resident
    blocks an SM of the kernel `name` (CROSSING or a value of SEEDS) on
    the current card."""
    out = (ctypes.c_int * 3)()
    if name == CROSSING:
        rc = _lib("crossing_map").sim5_crossing_map_attributes(out)
    else:
        (dt, azm), = [k for k, v in SEEDS.items() if v == name]
        rc = _lib("volume_seed").sim5_volume_seed_attributes(
            int(dt == torch.float64), int(azm), out)
    if rc != 0:
        raise RuntimeError(f"{name} attributes: cudaError {rc}")
    return dict(registers=out[0], local_bytes=out[1], blocks_per_sm=out[2])


def _stream(device):
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def crossing_maps(a, incl, npix, rmax, orders, device):
    """The crossing maps of `orders` (a sequence of image orders) of an
    npix^2 image: a dict of (len(orders), npix, npix) tensors r, phi, g,
    dt (the delay before its anchoring) and hit, f64 on `device`.  One
    launch of `crossing_map<double>` on the card (one per MAX_ORDERS
    orders); the plain version on the CPU.  a, incl and rmax are
    numbers."""
    from ..core import r_ms
    from .lightcurve import _crossing_map_unanchored
    device = torch.device(device)
    orders = [int(o) for o in orders]
    if device.type != "cuda":
        maps = [_crossing_map_unanchored(a, incl, npix, rmax, o, device)
                for o in orders]
        return {k: torch.stack([m[k] for m in maps]) for k in maps[0]}
    npix = int(npix)
    lib = _lib("crossing_map")
    if not orders:
        raise ValueError("no image order to map")
    if npix < 1 or npix * npix >= 2 ** 31:
        raise ValueError(f"a map of {npix} x {npix} pixels")
    # the ISCO of the spin as given, by the plain version's r_ms
    rms = float(r_ms(torch.tensor(float(a), dtype=torch.float64)))
    shape = (len(orders), npix, npix)
    out = {k: torch.empty(shape, dtype=torch.float64, device=device)
           for k in ("r", "phi", "g", "dt")}
    out["hit"] = torch.empty(shape, dtype=torch.bool, device=device)
    gauss = gauss_rule()
    for i in range(0, len(orders), MAX_ORDERS):
        group = orders[i:i + MAX_ORDERS]
        with torch.cuda.device(device):
            rc = lib.sim5_crossing_map(
                float(a), float(incl), float(rmax), rms, npix, len(group),
                (ctypes.c_int * len(group))(*group), gauss.ctypes.data,
                *(out[k][i:].data_ptr() for k in
                  ("r", "phi", "g", "dt", "hit")), _stream(device))
        if rc != 0:
            raise RuntimeError(f"{CROSSING} launch failed: cudaError {rc}")
        LAUNCHES[CROSSING] += 1
    return out


def volume_seed_rays(a, incl, t0, npix, rmax, r_start, axisymmetric, dtype,
                     device):
    """Every pixel's ray of an npix^2 image on the sphere r_start: (x0, k,
    ok), x0 and k (npix, npix, 4) of `dtype` (float64 or float32; k^theta
    signed as the march takes it), ok (npix, npix) bool, on `device`.  One
    launch of `volume_seed<T, not axisymmetric>` on the card; the plain
    version on the CPU.  a, incl, t0, rmax and r_start are numbers."""
    from .lightcurve import _volume_seed_plain
    device = torch.device(device)
    if device.type != "cuda":
        return _volume_seed_plain(a, incl, t0, npix, rmax, r_start,
                                  axisymmetric, dtype, device)
    if dtype not in (torch.float64, torch.float32):
        raise TypeError(f"the volume seed kernel takes float64 or float32, "
                        f"not {dtype}")
    npix = int(npix)
    if npix < 1 or npix * npix >= 2 ** 31:
        raise ValueError(f"a seed of {npix} x {npix} pixels")
    lib = _lib("volume_seed")
    x0 = torch.empty((npix, npix, 4), dtype=dtype, device=device)
    k = torch.empty_like(x0)
    ok = torch.empty((npix, npix), dtype=torch.bool, device=device)
    azm = not axisymmetric
    gauss = gauss_rule()
    with torch.cuda.device(device):
        rc = lib.sim5_volume_seed(
            int(dtype == torch.float64), int(azm), float(a), float(incl),
            float(rmax), float(r_start), float(t0), npix, gauss.ctypes.data,
            x0.data_ptr(), k.data_ptr(), ok.data_ptr(), _stream(device))
    name = SEEDS[dtype, azm]
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {rc}")
    LAUNCHES[name] += 1
    return x0, k, ok


_OPS_LIB = None


def _ops_lib():
    """The operation counter (csrc/analytic_ops.cpp) built with g++."""
    global _OPS_LIB
    if _OPS_LIB is None:
        import shutil
        from .. import _build
        gxx = shutil.which("g++")
        if gxx is None:
            raise RuntimeError("no g++: the operation counter cannot be "
                               "built")
        lib = _build.load_host("analytic_ops", _build.CSRC / "analytic_ops.cpp",
                               gxx, sorted(_build.CSRC.glob("*.cuh")))
        lib.sim5_ops_crossing.argtypes = [_D] * 4 + [_I, _I] + [_P] * 6 + [
            _I, _P]
        lib.sim5_ops_seed.argtypes = [_I, _I] + [_D] * 5 + [_I] + [_P] * 4 + [
            _I, _P]
        for f in (lib.sim5_ops_crossing, lib.sim5_ops_seed):
            f.restype = None
        _OPS_LIB = lib
    return _OPS_LIB


def _op_dict(ops):
    return {p: dict(zip(OP_KINDS, (int(v) for v in ops[i]))) for i, p in
            enumerate(("f64", "f32"))}


def operation_counts(kind, a, incl, npix, rmax, orders=(0,), r_start=None,
                     t0=0.0, axisymmetric=False, dtype=torch.float64,
                     threads=8):
    """The operations the pixels of a launch execute, counted on the host's
    CPU (`threads` threads) by the kernels' own per-pixel functions on a
    counting scalar: {"f64": {kind: count}, "f32": {...}} (OP_KINDS), and
    the outputs those functions computed (numpy, the kernel's layout).
    kind "crossing": crossing_map<double> over `orders`, outputs (r, phi,
    g, dt, hit) each (len(orders), npix, npix); kind "seed":
    volume_seed<dtype, not axisymmetric>, outputs (x0, k, ok)."""
    from ..core import r_ms
    lib = _ops_lib()
    gauss = gauss_rule()
    ops = np.zeros((2, len(OP_KINDS)), np.int64)
    npix = int(npix)
    if kind == "crossing":
        rms = float(r_ms(torch.tensor(float(a), dtype=torch.float64)))
        shape = (len(orders), npix, npix)
        out = [np.empty(shape) for _ in range(4)] + [np.empty(shape, np.uint8)]
        for j, o in enumerate(orders):
            lib.sim5_ops_crossing(float(a), float(incl), float(rmax), rms,
                                  npix, int(o), gauss.ctypes.data,
                                  *(v[j].ctypes.data for v in out),
                                  int(threads), ops.ctypes.data)
        out[4] = out[4].astype(bool)
        return _op_dict(ops), tuple(out)
    if kind != "seed":
        raise ValueError(f"kind {kind!r}: 'crossing' or 'seed'")
    np_dt = np.float64 if dtype == torch.float64 else np.float32
    x0 = np.empty((npix, npix, 4), np_dt)
    k = np.empty_like(x0)
    ok = np.empty((npix, npix), np.uint8)
    lib.sim5_ops_seed(int(dtype == torch.float64), int(not axisymmetric),
                      float(a), float(incl), float(rmax), float(r_start),
                      float(t0), npix, gauss.ctypes.data, x0.ctypes.data,
                      k.ctypes.data, ok.ctypes.data, int(threads),
                      ops.ctypes.data)
    return _op_dict(ops), (x0, k, ok.astype(bool))
