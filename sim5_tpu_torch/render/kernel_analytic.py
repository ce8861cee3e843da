"""The analytic engine's kernels: the equatorial crossing map and the volume
seed, each in two passes over a work list.

`crossing_maps` runs `csrc/crossing_map.cu` for a list of image orders:
the classify pass `crossing_classify<double>` (one pixel a thread, every
order in one launch: blockIdx.y is the order) writes r, g, hit and the
misses' phi and delay, and lists each hit by trajectory type; the hit pass
`crossing_hits<double>` (persistent blocks, the list in type order) writes
the hits' phi and delay.  `volume_seed_rays` runs `csrc/volume_seed.cu`:
`seed_geometry<T, azm>` (one pixel a thread; the whole axisymmetric seed,
azm false, whose phi0 is 0) and, with the azimuth, `seed_azimuth<T>` over
the listed valid pixels (T the seed's dtype).  The azimuth and the delay
run their Carlson chains at Carlson's stopping rule, lane by lane
(`csrc/azimuth.cuh`, AdaptiveDepth).  Neither kernel has a Pallas twin:
they replace the JAX package's XLA programs `equatorial_crossing_map` and
`_volume_seed_geom` / `_azm` / `_pack` (`sim5_tpu/render/lightcurve.py:
33-75, 113-167`).

On a CPU device each function runs its plain torch version,
`lightcurve._crossing_map_unanchored` and `lightcurve._volume_seed_plain`:
the same outputs, computed by the masked torch chain (at the fixed depth
of the JAX package's chains).  On the card it launches its kernels or
raises.  The kernels have no derivative: the entry points
(`lightcurve.equatorial_crossing_map`, `_volume_seed`) run the plain chain
under autograd when an input requires grad.

The CC rule's 16 Gauss-Legendre nodes, weights and 7 panel edges are the
plain version's own (`geodesic.analytic._GL16_X`, `_GL16_W`,
`_CC_PANELS`), passed to each launch as an argument.  The work buffer (the
lists and each listed pixel's geodesic) is a `torch.empty` the wrapper
allocates.

`LAUNCHES` counts each pass's launches; `PASSES` names a kernel's passes.
`counted_run` runs the counted instances (their own libraries, which no
entry point launches): per stage, the warps and lanes that ran it and its
cycles; per Carlson chain, its calls and levels.  `operation_counts` runs
the kernels' per-pixel functions on the host's cores on a counting scalar
(`csrc/analytic_ops.cpp`, built with g++): the operations a launch's
pixels execute, by pass, precision and kind, for the kernels' bound, at
either depth policy.
"""

import ctypes
import functools

import numpy as np
import torch

CROSSING = "crossing_map<double>"
_TYPES = {torch.float64: "double", torch.float32: "float"}
SEEDS = {(dt, azm): f"volume_seed<{t}, {str(azm).lower()}>"
         for dt, t in _TYPES.items() for azm in (True, False)}
# each kernel's passes, in launch order
PASSES = {CROSSING: ("crossing_classify<double>", "crossing_hits<double>"),
          **{SEEDS[dt, True]: (f"seed_geometry<{t}, true>",
                               f"seed_azimuth<{t}>")
             for dt, t in _TYPES.items()},
          **{SEEDS[dt, False]: (f"seed_geometry<{t}, false>",)
             for dt, t in _TYPES.items()}}
LAUNCHES = dict.fromkeys([p for v in PASSES.values() for p in v], 0)

_P, _I, _D = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
# (argtypes, restype) of each library's extern "C" functions; the counted
# ones are in the counted builds (-DSIM5_COUNTED) only
CROSSING_SIGNATURES = {
    "sim5_crossing_map_work": ([_I, _I, _P], _I),   # n, n_orders, *bytes
    "sim5_crossing_map": (
        [_D, _D, _D, _D, _I, _I,          # a, incl, rmax, rms, n, n_orders
         _P, _P,                          # orders, gauss (host)
         _P, _P, _P, _P, _P,              # r, phi, g, dt, hit
         _P, _P],                         # work, stream
        _I),
    "sim5_crossing_map_attributes": ([_I, _P], _I),
    "sim5_crossing_map_counted": (
        [_D, _D, _D, _D, _I, _I,          # a, incl, rmax, rms, n, n_orders
         _P, _P, _P, _P, _P, _P, _P,      # orders, gauss, r, phi, g, dt, hit
         _P, _P, _P],                     # work, stream, counters (host)
        _I),
}
SEED_SIGNATURES = {
    "sim5_volume_seed_work": ([_I, _I, _P], _I),    # f64, n, *bytes
    "sim5_volume_seed": (
        [_I, _I, _D, _D, _D, _D, _D, _I,  # f64, azm, a, incl, rmax,
                                          # r_start, t0, n
         _P, _P, _P, _P,                  # gauss (host), x0, k, ok
         _P, _P],                         # work, stream
        _I),
    "sim5_volume_seed_attributes": ([_I, _I, _I, _P], _I),
    "sim5_volume_seed_counted": (
        [_D, _D, _D, _D, _D, _I,          # a, incl, rmax, r_start, t0, n
         _P, _P, _P, _P,                  # gauss, x0, k, ok
         _P, _P, _P],                     # work, stream, counters (host)
        _I),
}
COUNTED_FUNCTIONS = ("sim5_crossing_map_counted", "sim5_volume_seed_counted")
# most orders a crossing-map launch takes (the kernel's kMaxOrders); more
# are launched in groups of this many
MAX_ORDERS = 8
# no FMA contraction: the error-free transforms need every rounding
NVCC_EXTRA = ("--fmad=false",)
_LIBS = {}
# the operation counter's kinds, in the order of csrc/analytic_ops.cpp, and
# its transcendental functions
OP_KINDS = ("add", "mul", "div", "sqrt", "transcendental")
OP_FNS = ("sin", "cos", "acos", "asin", "atan", "atanh", "log", "log1p",
          "pow")
# the counted instances' stages (sim5::Stage, csrc/azimuth.cuh) and Carlson
# chains (sim5::ChainKind), in their order
TYPE_BINS = ("RR", "RR_BH", "RC", "CC")
STAGES = ("geometry", "far", *(f"azimuth {t}" for t in TYPE_BINS), "theta",
          *(f"delay {t}" for t in TYPE_BINS))
CHAINS = ("RF", "RD", "RJ", "RC")


def _lib(name):
    """The built library `name` (crossing_map or volume_seed, or either
    with "_counted": its counted instances), with its signatures
    declared."""
    if name not in _LIBS:
        from .._build import load
        source = name.removesuffix("_counted")
        counted = source != name
        sigs = {"crossing_map": CROSSING_SIGNATURES,
                "volume_seed": SEED_SIGNATURES}[source]
        lib = load(name, extra_flags=NVCC_EXTRA + (
            ("-DSIM5_COUNTED",) if counted else ()), source=source)
        for fname, (argtypes, restype) in sigs.items():
            if (fname in COUNTED_FUNCTIONS) != counted and \
                    not fname.endswith("_work"):
                continue
            fn = getattr(lib, fname)
            fn.argtypes, fn.restype = argtypes, restype
        _LIBS[name] = lib
    return _LIBS[name]


@functools.lru_cache(maxsize=None)
def gauss_rule():
    """The CC rule as the kernels take it: 16 nodes, 16 weights, 7 panel
    edges, f64 on the host (one array, made once)."""
    from ..geodesic.analytic import _GL16_X, _GL16_W, _CC_PANELS
    return np.ascontiguousarray(np.concatenate(
        [_GL16_X, _GL16_W, _CC_PANELS]), dtype=np.float64)


def kernel_attributes(name):
    """Registers a thread, local memory a thread (bytes), resident blocks
    an SM and threads a block of the pass `name` (a value of PASSES) on the
    current card."""
    out = (ctypes.c_int * 4)()
    (kernel, j), = [(k, v.index(name)) for k, v in PASSES.items()
                    if name in v]
    if kernel == CROSSING:
        rc = _lib("crossing_map").sim5_crossing_map_attributes(j, out)
    else:
        (dt, azm), = [k for k, v in SEEDS.items() if v == kernel]
        rc = _lib("volume_seed").sim5_volume_seed_attributes(
            int(dt == torch.float64), int(azm), j, out)
    if rc != 0:
        raise RuntimeError(f"{name} attributes: cudaError {rc}")
    return dict(registers=out[0], local_bytes=out[1], blocks_per_sm=out[2],
                threads=out[3])


def _stream(device):
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def _work(fn, args, device):
    """A work buffer of the bytes the library's _work function asks for."""
    nbytes = ctypes.c_longlong()
    rc = fn(*args, ctypes.byref(nbytes))
    if rc != 0:
        raise ValueError(f"no work buffer for {args}: cudaError {rc}")
    return torch.empty(nbytes.value, dtype=torch.uint8, device=device)


@functools.lru_cache(maxsize=64)
def _rms(a):
    """The ISCO of the spin as given, by the plain version's r_ms."""
    from ..core import r_ms
    return float(r_ms(torch.tensor(a, dtype=torch.float64)))


def _crossing_args(a, incl, npix, rmax, orders, device):
    """The map's outputs and the launch arguments they share."""
    npix = int(npix)
    if not orders:
        raise ValueError("no image order to map")
    if npix < 1 or npix * npix >= 2 ** 31:
        raise ValueError(f"a map of {npix} x {npix} pixels")
    rms = _rms(float(a))
    shape = (len(orders), npix, npix)
    out = {k: torch.empty(shape, dtype=torch.float64, device=device)
           for k in ("r", "phi", "g", "dt")}
    out["hit"] = torch.empty(shape, dtype=torch.bool, device=device)
    return npix, rms, out


def crossing_maps(a, incl, npix, rmax, orders, device):
    """The crossing maps of `orders` (a sequence of image orders) of an
    npix^2 image: a dict of (len(orders), npix, npix) tensors r, phi, g,
    dt (the delay before its anchoring) and hit, f64 on `device`.  On the
    card one launch of each pass (one per MAX_ORDERS orders); the plain
    version on the CPU.  a, incl and rmax are numbers."""
    from .lightcurve import _crossing_map_unanchored
    device = torch.device(device)
    orders = [int(o) for o in orders]
    if device.type != "cuda":
        maps = [_crossing_map_unanchored(a, incl, npix, rmax, o, device)
                for o in orders]
        return {k: torch.stack([m[k] for m in maps]) for k in maps[0]}
    lib = _lib("crossing_map")
    npix, rms, out = _crossing_args(a, incl, npix, rmax, orders, device)
    work = _work(lib.sim5_crossing_map_work,
                 (npix, min(len(orders), MAX_ORDERS)), device)
    gauss = gauss_rule()
    for i in range(0, len(orders), MAX_ORDERS):
        group = orders[i:i + MAX_ORDERS]
        with torch.cuda.device(device):
            rc = lib.sim5_crossing_map(
                float(a), float(incl), float(rmax), rms, npix, len(group),
                (ctypes.c_int * len(group))(*group), gauss.ctypes.data,
                *(out[k][i:].data_ptr() for k in
                  ("r", "phi", "g", "dt", "hit")), work.data_ptr(),
                _stream(device))
        if rc != 0:
            raise RuntimeError(f"{CROSSING} launch failed: cudaError {rc}")
        for name in PASSES[CROSSING]:
            LAUNCHES[name] += 1
    return out


def volume_seed_rays(a, incl, t0, npix, rmax, r_start, axisymmetric, dtype,
                     device):
    """Every pixel's ray of an npix^2 image on the sphere r_start: (x0, k,
    ok), x0 and k (npix, npix, 4) of `dtype` (float64 or float32; k^theta
    signed as the march takes it), ok (npix, npix) bool, on `device`.  On
    the card one launch of each pass of `volume_seed<T, not
    axisymmetric>`; the plain version on the CPU.  a, incl, t0, rmax and
    r_start are numbers."""
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
    f64 = int(dtype == torch.float64)
    azm = not axisymmetric
    x0 = torch.empty((npix, npix, 4), dtype=dtype, device=device)
    k = torch.empty_like(x0)
    ok = torch.empty((npix, npix), dtype=torch.bool, device=device)
    # the axisymmetric seed has no list
    work = (_work(lib.sim5_volume_seed_work, (f64, npix), device) if azm
            else None)
    name = SEEDS[dtype, azm]
    with torch.cuda.device(device):
        rc = lib.sim5_volume_seed(
            f64, int(azm), float(a), float(incl), float(rmax),
            float(r_start), float(t0), npix, gauss_rule().ctypes.data,
            x0.data_ptr(), k.data_ptr(), ok.data_ptr(),
            None if work is None else work.data_ptr(), _stream(device))
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {rc}")
    for p in PASSES[name]:
        LAUNCHES[p] += 1
    return x0, k, ok


def _counters(raw):
    """The counted run's counters by stage and by chain."""
    raw = np.asarray(raw, np.int64)
    ns = 3 * len(STAGES)
    stages = {s: dict(zip(("warps", "lanes", "cycles"),
                          (int(v) for v in raw[3 * j:3 * j + 3])))
              for j, s in enumerate(STAGES)}
    chains = {c: dict(zip(("warp_calls", "lane_calls", "levels",
                           "levels_issued"),
                          (int(v) for v in raw[ns + 4 * j:ns + 4 * j + 4])))
              for j, c in enumerate(CHAINS)}
    return stages, chains


def counted_run(kind, a, incl, npix, rmax, orders=(0, 1), r_start=None,
                t0=0.0, device=None):
    """The crossing map (kind "crossing", `orders`) or the f64 seed with
    the azimuth (kind "seed") through the counted instances of their two
    passes: (outputs as crossing_maps' or volume_seed_rays', {stage:
    {warps, lanes, cycles}}, {chain: {warp_calls, lane_calls, levels,
    levels_issued}}).  The counters include their own atomics: the cycles
    are the counted instance's, not the kernel's."""
    device = torch.device(device)
    counters = np.zeros(3 * len(STAGES) + 4 * len(CHAINS), np.int64)
    gauss = gauss_rule()
    if kind == "crossing":
        lib = _lib("crossing_map_counted")
        orders = [int(o) for o in orders]
        if len(orders) > MAX_ORDERS:
            raise ValueError(f"at most {MAX_ORDERS} orders")
        npix, rms, out = _crossing_args(a, incl, npix, rmax, orders, device)
        work = _work(lib.sim5_crossing_map_work, (npix, len(orders)), device)
        with torch.cuda.device(device):
            rc = lib.sim5_crossing_map_counted(
                float(a), float(incl), float(rmax), rms, npix,
                len(orders), (ctypes.c_int * len(orders))(*orders),
                gauss.ctypes.data, *(out[k].data_ptr() for k in
                                     ("r", "phi", "g", "dt", "hit")),
                work.data_ptr(), _stream(device), counters.ctypes.data)
    elif kind == "seed":
        lib = _lib("volume_seed_counted")
        npix = int(npix)
        x0 = torch.empty((npix, npix, 4), dtype=torch.float64, device=device)
        k = torch.empty_like(x0)
        ok = torch.empty((npix, npix), dtype=torch.bool, device=device)
        work = _work(lib.sim5_volume_seed_work, (1, npix), device)
        with torch.cuda.device(device):
            rc = lib.sim5_volume_seed_counted(
                float(a), float(incl), float(rmax),
                float(r_start), float(t0), npix, gauss.ctypes.data,
                x0.data_ptr(), k.data_ptr(), ok.data_ptr(), work.data_ptr(),
                _stream(device), counters.ctypes.data)
        out = (x0, k, ok)
    else:
        raise ValueError(f"kind {kind!r}: 'crossing' or 'seed'")
    if rc != 0:
        raise RuntimeError(f"counted {kind} failed: cudaError {rc}")
    return (out, *_counters(counters))


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
        lib.sim5_ops_crossing.argtypes = [_D] * 4 + [_I, _I, _I] + [_P] * 6 + [
            _I, _P]
        lib.sim5_ops_seed.argtypes = [_I, _I, _I] + [_D] * 5 + [_I] + [
            _P] * 4 + [_I, _P]
        for f in (lib.sim5_ops_crossing, lib.sim5_ops_seed):
            f.restype = None
        _OPS_LIB = lib
    return _OPS_LIB


# words of the counter's output: [pass][precision][kind], then
# [pass][precision][function], then [chain][calls, levels, deepest]
_NK, _NF = len(OP_KINDS), len(OP_FNS)


def _op_dict(raw):
    """The counter's words as {"f64": {kind: n}, "f32": {...}} (both
    passes), "passes": [the same of each pass], "fn": {"f64": {function:
    n}, ...}, "fn_passes": [...] and "levels": {chain: {calls, levels,
    deepest}}."""
    ops = raw[:4 * _NK].reshape(2, 2, _NK)
    fns = raw[4 * _NK:4 * (_NK + _NF)].reshape(2, 2, _NF)
    lev = raw[4 * (_NK + _NF):].reshape(len(CHAINS), 3)

    def by(a, names):
        return {p: dict(zip(names, (int(v) for v in a[i])))
                for i, p in enumerate(("f64", "f32"))}

    out = by(ops.sum(0), OP_KINDS)
    out["passes"] = [by(ops[j], OP_KINDS) for j in range(2)]
    out["fn"] = by(fns.sum(0), OP_FNS)
    out["fn_passes"] = [by(fns[j], OP_FNS) for j in range(2)]
    out["levels"] = {c: dict(zip(("calls", "levels", "deepest"),
                                 (int(v) for v in lev[j])))
                     for j, c in enumerate(CHAINS)}
    return out


def operation_counts(kind, a, incl, npix, rmax, orders=(0,), r_start=None,
                     t0=0.0, axisymmetric=False, dtype=torch.float64,
                     threads=8, adaptive=False):
    """The operations the pixels of a launch execute, counted on the host's
    CPU (`threads` threads) by the kernels' own per-pixel functions on a
    counting scalar, their Carlson chains at Carlson's rule (`adaptive`,
    the kernels') or at the fixed depth (the plain chains'): _op_dict's
    counts, and the outputs those functions computed (numpy, the kernel's
    layout).  kind "crossing": the crossing map over `orders`, outputs (r,
    phi, g, dt, hit) each (len(orders), npix, npix); kind "seed":
    volume_seed<dtype, not axisymmetric>, outputs (x0, k, ok).  Pass 0 is
    the geometry (the classify or geometry pass), pass 1 the rest."""
    from ..core import r_ms
    lib = _ops_lib()
    gauss = gauss_rule()
    raw = np.zeros(4 * (_NK + _NF) + 3 * len(CHAINS), np.int64)
    npix = int(npix)
    if kind == "crossing":
        rms = float(r_ms(torch.tensor(float(a), dtype=torch.float64)))
        shape = (len(orders), npix, npix)
        out = [np.empty(shape) for _ in range(4)] + [np.empty(shape, np.uint8)]
        for j, o in enumerate(orders):
            lib.sim5_ops_crossing(float(a), float(incl), float(rmax), rms,
                                  npix, int(o), int(adaptive),
                                  gauss.ctypes.data,
                                  *(v[j].ctypes.data for v in out),
                                  int(threads), raw.ctypes.data)
        out[4] = out[4].astype(bool)
        return _op_dict(raw), tuple(out)
    if kind != "seed":
        raise ValueError(f"kind {kind!r}: 'crossing' or 'seed'")
    np_dt = np.float64 if dtype == torch.float64 else np.float32
    x0 = np.empty((npix, npix, 4), np_dt)
    k = np.empty_like(x0)
    ok = np.empty((npix, npix), np.uint8)
    lib.sim5_ops_seed(int(dtype == torch.float64), int(not axisymmetric),
                      int(adaptive), float(a), float(incl), float(rmax),
                      float(r_start), float(t0), npix, gauss.ctypes.data,
                      x0.ctypes.data, k.ctypes.data, ok.ctypes.data,
                      int(threads), raw.ctypes.data)
    return _op_dict(raw), (x0, k, ok.astype(bool))
