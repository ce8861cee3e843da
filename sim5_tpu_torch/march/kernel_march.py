"""The march kernel: every ray marched to termination on the card.

Port of `sim5_tpu/march/pallas_march.py`.  `raytrace_kernel` is the
counterpart of `raytrace_pallas`: it packs the ray state into
structure-of-arrays (4, N) f32 components, with theta in place of
m = cos(theta) (the kernel carries theta through the whole march), and runs
either

* the CUDA kernel `march_f32<GR, POL, RT, Em, Ab>` (`csrc/march.cuh`) for
  CUDA tensors, in segments: ceil(max_steps / seg_trips) launches, with
  the rays still live after each compacted into a dense list for the
  next, or
* `march_reference`, its plain torch version, for CPU tensors.

A CUDA tensor always launches the kernel or raises; the plain version runs
only because the tensors lie on the CPU.  `LAUNCHES` counts kernel
launches by variant, and `march_counters()` reads the lane counters of the
last march on the card.

`march_reference` is a masked torch loop that mirrors the kernel body
(`_make_kernel` in the JAX package) operation for operation: theta carried
throughout, `_TINY = 1e-30`, err = 1e30 on a freeze, and the stage-1
acceleration reused for the curvature.  The fused radiative transfer
(RT > 0) takes any emissivity and absorption `raytrace_pallas` would take,
as torch callables (t, r, m, phi) -> tensor.  A pair of
`emission.GaussianSource` models (or None) runs in the kernel's own
library (`csrc/march.cu`), their parameters by value; any other pair is
traced (`model_trace.trace_model`, on every device, so what the kernel
cannot evaluate is refused on the CPU too) and runs in a library
generated for its structure and built at first use
(`model_trace.march_source`, `_build.load_generated`), its constants by
value: models that differ only in their numbers share one build.
"""

import ctypes
import hashlib

import numpy as np
import torch

from ..core import r_bh
from ..core.metric import _kerr_conn_entries, _flat_conn_entries
from . import model_trace
from .emission import GaussianSource, is_family, prepare, rt_mode

_TINY = 1e-30

# the kernel's variants: by its RT template argument, the family's
# instances (csrc/march.cu), then the generated ones for traced models
VARIANTS = ("march_f32", "march_f32 RT=emission",
            "march_f32 RT=emission+absorption",
            "march_f32 RT=emission (traced)",
            "march_f32 RT=emission+absorption (traced)")

# kernel launches made on CUDA tensors, by variant
LAUNCHES = dict.fromkeys(VARIANTS, 0)

# the counters of the last march on the card, (2 + launches,) int64 on the
# device: lane-trips, warp-trips, then the rays each launch appended
LAST_STATS = None

_LIB = None
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_GAUSS = [_F] * 9 + [_I]                  # GaussianSource.params()
_BUFFERS = ([_P] * 5                      # x, k, f, kt, active0
            + [_P] * 8                    # xo, ko, fo, kto, erro, stepso, acto, Io
            + [_P] * 5                    # lv_in, li_in, lv_out, li_out, stats
            + [ctypes.c_longlong]         # n
            + [_F] * 6                    # a, eps0, r_min, r_max, error_stop, error_gate
            + [_I, _F])                   # max_steps, max_step_dl
# (argtypes, restype) of the library's extern "C" functions (csrc/march.cu)
SIGNATURES = {
    "sim5_march_f32": (
        [_I] * 4                          # gr, pol, rt, seg
        + _BUFFERS
        + _GAUSS + _GAUSS                 # emissivity, absorption
        + [_P],                           # stream
        _I),
    "sim5_march_config": ([_P], None),
    "sim5_march_attributes": ([_I] * 3 + [_P], _I),
}
# ... and of a library generated for traced models (csrc/march_model.cuh)
MODEL_SIGNATURES = {
    "sim5_march_model_f32": (
        [_I] * 3                          # gr, pol, seg
        + _BUFFERS
        + [_P, _P]                        # the models' constants
        + [_P],                           # stream
        _I),
    "sim5_march_model_attributes": ([_I] * 2 + [_P], _I),
    "sim5_march_model_config": ([_P], None),
}


def _accel_components(opt_gr, a, r, m, U, V):
    """-Gamma^i_jk U^j V^k with U, V as length-4 lists of ray tensors.

    Contracts the <=20 nonzero Christoffel components inline, in the
    order the kernel does.
    """
    entries, _ = (_kerr_conn_entries(a, r, m) if opt_gr
                  else _flat_conn_entries(r, m))
    out = [None, None, None, None]
    for (i, j, k), g in entries.items():
        term = (g * (U[j] * V[k] + U[k] * V[j]) if j != k
                else g * (U[j] * V[k]))
        out[i] = term if out[i] is None else out[i] + term
    zero = torch.zeros_like(U[0])
    return [zero if o is None else -o for o in out]


def _metric_coeffs(opt_gr, a, r, m):
    """(g00, g11, g22, g33, g03) of the (t, r, theta, phi) BL/spherical
    metric, parametrized by m = cos(theta)  (sim5kerr.c:31-107)."""
    if not opt_gr:
        s2 = 1.0 - m * m
        one = torch.ones_like(r)
        return -one, one, r * r, r * r * s2, torch.zeros_like(r)
    r2 = r * r
    a2 = a * a
    m2 = m * m
    s2 = 1.0 - m2
    S = r2 + a2 * m2
    D = r2 - 2.0 * r + a2
    A = (r2 + a2) ** 2 - a2 * D * s2
    g00 = -(1.0 - 2.0 * r / S)
    g11 = S / D
    g22 = S
    g33 = A / S * s2
    g03 = -2.0 * a * r * s2 / S
    return g00, g11, g22, g33, g03


def march_reference(x, k, f, kt, active0, a, eps0, r_min, r_max, error_stop,
                    error_gate, opt_gr=True, opt_pol=False, max_steps=10000,
                    max_step_dl=1e9, emissivity=None, absorption=None):
    """Plain torch version of the march kernel, on any device.

    x, k, f: (4, N) f32 with x = (t, r, theta, phi); kt: (N,) f32;
    active0: (N,) bool.  The scalars are Python floats, used in f32.
    `emissivity` and `absorption` are any callables, called here as they
    are: the plain version traces nothing (`raytrace_kernel` refuses what
    the kernel cannot evaluate).  Returns (x, k, f, kt, err, steps,
    active, I) as the kernel does: x, k, f
    (4, N) f32, kt and err (N,) f32, steps (N,) int32, active (N,) bool,
    and the transferred intensity I (N,) f32 (None without emissivity).
    """
    rt = rt_mode(emissivity, absorption)
    dev = x.device

    def f32(v):
        return torch.tensor(v, dtype=torch.float32, device=dev)

    a, eps0, r_min, r_max = f32(a), f32(eps0), f32(r_min), f32(r_max)
    error_stop, error_gate = f32(error_stop), f32(error_gate)
    max_step_dl = f32(max_step_dl)

    x, k, f = list(x.unbind(0)), list(k.unbind(0)), list(f.unbind(0))
    err = torch.zeros_like(kt)
    steps = torch.zeros(kt.shape, dtype=torch.int32, device=dev)
    active = torch.isfinite(kt) & active0
    eps = torch.full_like(kt, float(eps0))
    I = torch.zeros_like(kt)
    tau = torch.zeros_like(kt)

    def accel(xth, kv, fv):
        rr, mm = xth[1], torch.cos(xth[2])
        dk = _accel_components(opt_gr, a, rr, mm, kv, kv)
        df = (_accel_components(opt_gr, a, rr, mm, kv, fv)
              if opt_pol else fv)
        return dk, df

    for _ in range(max_steps):
        if not bool(active.any()):
            break
        r, m = x[1], torch.cos(x[2])
        # adaptive step: dl = eps / sum_i |dk_i|/|k_i|  (sim5raytrace.c:164)
        dk0 = _accel_components(opt_gr, a, r, m, k, k)
        curv = sum(torch.abs(dk0[i]) / (torch.abs(k[i]) + _TINY)
                   for i in range(4)) + _TINY
        dl = torch.minimum(max_step_dl, eps / curv)
        # progress floor scaled with the retry shrink (see raytrace.py)
        dl = torch.maximum(dl, 1e-3 * eps / eps0)
        dl = torch.where(active, dl, 0.0)

        # RK4 in (t, r, theta, phi); stage-1 acceleration IS the curvature
        # evaluation above (same r, m, k)
        k1 = k
        dk1 = dk0
        df1 = _accel_components(opt_gr, a, r, m, k, f) if opt_pol else f
        h = 0.5 * dl
        x2_ = [x[i] + k1[i] * h for i in range(4)]
        k2 = [k[i] + dk1[i] * h for i in range(4)]
        f2 = [f[i] + df1[i] * h for i in range(4)] if opt_pol else f
        dk2, df2 = accel(x2_, k2, f2)
        x3_ = [x[i] + k2[i] * h for i in range(4)]
        k3 = [k[i] + dk2[i] * h for i in range(4)]
        f3 = [f[i] + df2[i] * h for i in range(4)] if opt_pol else f
        dk3, df3 = accel(x3_, k3, f3)
        x4_ = [x[i] + k3[i] * dl for i in range(4)]
        k4 = [k[i] + dk3[i] * dl for i in range(4)]
        f4 = [f[i] + df3[i] * dl for i in range(4)] if opt_pol else f
        dk4, df4 = accel(x4_, k4, f4)

        d6 = dl / 6.0
        xn = [x[i] + d6 * (k1[i] + 2.0 * (k2[i] + k3[i]) + k4[i])
              for i in range(4)]
        kn = [k[i] + d6 * (dk1[i] + 2.0 * (dk2[i] + dk3[i]) + dk4[i])
              for i in range(4)]
        fn = ([f[i] + d6 * (df1[i] + 2.0 * (df2[i] + df3[i]) + df4[i])
               for i in range(4)] if opt_pol else f)

        # error: k_t drift + |k.k|  (sim5raytrace.c:217-219)
        g00, g11, g22, g33, g03 = _metric_coeffs(opt_gr, a, xn[1],
                                                 torch.cos(xn[2]))
        kt_new = kn[0] * g00 + kn[3] * g03
        kk = torch.abs(g00 * kn[0] * kn[0] + g11 * kn[1] * kn[1]
                       + g22 * kn[2] * kn[2] + g33 * kn[3] * kn[3]
                       + 2.0 * g03 * kn[0] * kn[3])
        e_new = torch.maximum(
            torch.abs(kt_new - kt) / (torch.abs(kt) + _TINY), kk)

        # masked revert-and-retry (sim5raytrace.c:217-227); a non-finite
        # trial at the shrink floor FREEZES the ray with err = 1e30
        bad = ~(torch.isfinite(e_new) & torch.isfinite(xn[1]))
        reject = active & (bad | (e_new > error_gate)) & (eps > eps0 / 64.0)
        fail_floor = active & bad & ~reject
        acc = active & ~reject & ~bad
        eps = torch.where(reject, torch.maximum(0.5 * eps, eps0 / 128.0),
                          torch.where(acc, torch.minimum(eps0, 1.3 * eps),
                                      eps))

        x = [torch.where(acc, xn[i], x[i]) for i in range(4)]
        k = [torch.where(acc, kn[i], k[i]) for i in range(4)]
        if opt_pol:
            f = [torch.where(acc, fn[i], f[i]) for i in range(4)]
        kt = torch.where(acc, kt_new, kt)
        err = torch.where(acc, e_new, torch.where(fail_floor, 1e30, err))
        steps = steps + active.to(torch.int32)

        if rt:
            # radiative transfer on accepted steps, at the updated position,
            # with the trial's dl (the Pallas body's order and thresholds)
            mm = torch.cos(x[2])
            j = emissivity(x[0], x[1], mm, x[3])
            if absorption is not None:
                al = absorption(x[0], x[1], mm, x[3])
                dtau = al * dl
                seff = torch.where(dtau > 1e-6,
                                   (1.0 - torch.exp(-dtau))
                                   / torch.maximum(al, f32(_TINY)), dl)
                I = I + torch.where(acc, j * torch.exp(-tau) * seff, 0.0)
                tau = tau + torch.where(acc, dtau, 0.0)
            else:
                I = I + torch.where(acc, j * dl, 0.0)

        rr = x[1]
        active = (active & (rr > r_min) & (rr < r_max)
                  & (err < error_stop) & torch.isfinite(rr))

    return (torch.stack(x), torch.stack(k), torch.stack(f), kt, err, steps,
            active, I if rt else None)


def _declare(lib, signatures=SIGNATURES):
    """`lib` with the signatures of `signatures` declared."""
    for name, (argtypes, restype) in signatures.items():
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = argtypes, restype
    return lib


def _lib():
    """The built march library, with its functions' signatures declared."""
    global _LIB
    if _LIB is None:
        from .._build import load
        _LIB = _declare(load("march"))
    return _LIB


def model_library(emissivity, absorption=None):
    """(name, library) of the march library generated for a pair of models
    outside the family (any callables; a `GaussianSource` among them is
    traced through its own __call__), built at first use: `name` is its
    key in `_build.BUILDS`, shared by every pair of the same structure."""
    from .._build import load_generated
    jt = model_trace.trace_model(emissivity)
    at = None if absorption is None else model_trace.trace_model(absorption)
    source = model_trace.march_source(jt, at)
    name = "march_model_" + hashlib.sha256(source.encode()).hexdigest()[:16]
    return name, _declare(load_generated(name, source), MODEL_SIGNATURES)


def kernel_config():
    """The kernel's compile-time choices: threads a block, trips a segment
    (`seg_trips`) and floats a list entry."""
    return _config(_lib())


def _config(lib):
    """`kernel_config()` of a march library; a generated one adds its rt
    and the constants a model takes."""
    if hasattr(lib, "sim5_march_model_config"):
        out = (ctypes.c_int * 5)()
        lib.sim5_march_model_config(out)
    else:
        out = (ctypes.c_int * 3)()
        lib.sim5_march_config(out)
    cfg = dict(threads=out[0], seg_trips=out[1], list_floats=out[2])
    if len(out) == 5:
        cfg.update(rt=out[3], consts=out[4])
    return cfg


def kernel_attributes(opt_gr, opt_pol, rt, emissivity=None, absorption=None):
    """Registers a thread, local memory a thread (bytes) and resident
    blocks an SM of `march_f32<opt_gr, opt_pol, rt, J, A>` on the current
    card: the family's instance, or with models outside the family (and
    the rt they give) the instance generated for them."""
    out = (ctypes.c_int * 3)()
    if is_family(emissivity, absorption):
        rc = _lib().sim5_march_attributes(int(opt_gr), int(opt_pol), rt, out)
    else:
        lib = model_library(emissivity, absorption)[1]
        rc = lib.sim5_march_model_attributes(int(opt_gr), int(opt_pol), out)
    if rc != 0:
        raise RuntimeError(f"march_f32 attributes: cudaError {rc}")
    return dict(registers=out[0], local_bytes=out[1], blocks_per_sm=out[2])


def march_counters():
    """(lane_trips, warp_trips, appended) of the last march on the card:
    the live lanes of a warp summed over its trips, the trips the warps
    issued, and the rays each launch appended to the next list.  Lane use
    is lane_trips / (32 warp_trips); lane_trips is the sum of the steps.
    Reads the device."""
    stats = LAST_STATS.tolist()
    return stats[0], stats[1], stats[2:]


def _march_cuda(x, k, f, kt, active0, a, eps0, r_min, r_max, error_stop,
                error_gate, opt_gr=True, opt_pol=False, max_steps=10000,
                max_step_dl=1e9, emissivity=None, absorption=None,
                events=None):
    """The segmented march on CUDA tensors, on the current stream:
    `march_f32<opt_gr, opt_pol, rt>` in ceil(max_steps / seg_trips)
    launches, the live rays compacted between them.

    Same arguments and results as `march_reference`.  A pair of
    `GaussianSource` models (or None) launches the family's instance; any
    other pair, the instance generated for its traced structure (built at
    first use, `model_library`), with the constants of its trace: a model
    that comes as a `model_trace.TracedModel` is taken as it is, any other
    callable is traced here, once a call.  `events`, if a list, receives a CUDA
    event recorded before the first launch and one after each launch.
    """
    global LAST_STATS
    rt, emissivity, absorption = prepare(emissivity, absorption)
    n = kt.shape[0]
    dev = x.device
    for name, t, shape, dtype in (("x", x, (4, n), torch.float32),
                                  ("k", k, (4, n), torch.float32),
                                  ("f", f, (4, n), torch.float32),
                                  ("kt", kt, (n,), torch.float32),
                                  ("active0", active0, (n,), torch.bool)):
        if t.device != dev or not t.is_cuda:
            raise ValueError(f"{name} is on {t.device}, the kernel needs {dev}")
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"{name} is {t.dtype} {tuple(t.shape)}, the "
                             f"kernel takes {dtype} {shape}")
        if not t.is_contiguous():
            raise ValueError(f"{name} is not contiguous")
    if n == 0:
        raise ValueError("empty ray batch")
    if n >= 2 ** 31:
        raise ValueError("the kernel indexes rays with an int32")
    if max_steps >= 2 ** 31:
        raise ValueError("max_steps does not fit an int32")
    family = is_family(emissivity, absorption)
    lib = _lib() if family else model_library(emissivity, absorption)[1]
    cfg = _config(lib)
    if not family and (cfg["rt"], cfg["consts"]) != (
            rt, model_trace.MAX_CONSTS):
        raise RuntimeError(f"the generated march library has rt "
                           f"{cfg['rt']} and {cfg['consts']} constants, not "
                           f"{rt} and {model_trace.MAX_CONSTS}")
    launches = max(1, -(-max_steps // cfg["seg_trips"]))
    xo, ko, fo = (torch.empty_like(x) for _ in range(3))
    kto, erro = torch.empty_like(kt), torch.empty_like(kt)
    stepso = torch.empty(n, dtype=torch.int32, device=dev)
    acto = torch.empty(n, dtype=torch.bool, device=dev)
    Io = torch.empty_like(kt) if rt else None
    stats = torch.zeros(2 + launches, dtype=torch.int64, device=dev)
    # the two ping-pong lists of live rays
    lv = torch.empty((2, cfg["list_floats"], n), dtype=torch.float32,
                     device=dev)
    li = torch.empty((2, 2, n), dtype=torch.int32, device=dev)
    scalars = (n, a, eps0, r_min, r_max, error_stop, error_gate,
               int(max_steps), max_step_dl)
    stream = torch.cuda.current_stream(dev).cuda_stream
    if family:
        unused = GaussianSource(amp=0.0)
        launch = lib.sim5_march_f32
        head = (int(opt_gr), int(opt_pol), rt)
        models = (*(emissivity or unused).params(),
                  *(absorption or unused).params())
        name = VARIANTS[rt]
    else:
        launch = lib.sim5_march_model_f32
        head = (int(opt_gr), int(opt_pol))
        models = tuple(
            (ctypes.c_float * model_trace.MAX_CONSTS)(*m.consts)
            if m is not None
            else (ctypes.c_float * model_trace.MAX_CONSTS)()
            for m in (emissivity, absorption))
        name = VARIANTS[rt + 2]
    ptrs = [t.data_ptr() for t in (x, k, f, kt, active0, xo, ko, fo, kto,
                                   erro, stepso, acto)]
    ptrs.append(Io.data_ptr() if rt else None)

    def record():
        if events is not None:
            events.append(torch.cuda.Event(enable_timing=True))
            events[-1].record()

    record()
    for seg in range(launches):
        src, dst = (seg - 1) % 2, seg % 2
        lists = (lv[src].data_ptr(), li[src].data_ptr(),
                 lv[dst].data_ptr(), li[dst].data_ptr())
        rc = launch(*head, seg, *ptrs, *lists, stats.data_ptr(), *scalars,
                    *models, stream)
        if rc != 0:
            raise RuntimeError(f"{name} launch failed: cudaError {rc}")
        LAUNCHES[name] += 1
        record()
    LAST_STATS = stats
    return xo, ko, fo, kto, erro, stepso, acto, Io


def _pack(state, r_max, max_steps, error_stop, active0):
    """(tensors, scalars) of a march over `state`, in the kernel's layout."""
    n = int(np.prod(state.x.shape[:-1]))
    for name in ("x", "k", "f", "kt"):
        t = getattr(state, name)
        if t.dtype != torch.float32:
            raise TypeError(f"the march kernel is f32; state.{name} is "
                            f"{t.dtype}")
    # the kernel carries theta; convert m -> theta once
    m = state.x[..., 2]
    x_th = torch.cat([state.x[..., :2],
                      torch.arccos(torch.clamp(m, -1.0, 1.0))[..., None],
                      state.x[..., 3:]], -1)

    def comp(v):
        return v.reshape(n, 4).T.contiguous()

    dev = state.x.device
    act = (torch.ones(n, dtype=torch.bool, device=dev) if active0 is None
           else torch.as_tensor(active0, device=dev).reshape(n).to(torch.bool))
    # spin and precision of the first ray, as the JAX wrapper takes them
    a = state.a[(0,) * state.a.ndim]
    eps = state.step_epsilon0[(0,) * state.step_epsilon0.ndim]
    r_min = 1.05 * r_bh(a)
    tensors = (comp(x_th), comp(state.k), comp(state.f),
               state.kt.reshape(n).contiguous(), act.contiguous())
    scalars = dict(a=float(a), eps0=float(eps), r_min=float(r_min),
                   r_max=float(r_max), error_stop=float(error_stop),
                   error_gate=0.25 * error_stop, opt_gr=state.opt_gr,
                   opt_pol=state.opt_pol, max_steps=int(max_steps))
    return tensors, scalars


def _unpack(state, outs):
    """(RaytraceState, still_active) from the kernel's outputs, and the
    intensity I when the march carried transfer."""
    xo, ko, fo, kto, erro, stepso, acto, Io = outs
    batch = state.x.shape[:-1]

    def un(v):
        return v.T.reshape(batch + (4,))

    x = un(xo)
    x = torch.cat([x[..., :2], torch.cos(x[..., 2:3]), x[..., 3:]], -1)
    out = state._replace(x=x, k=un(ko), f=un(fo), kt=kto.reshape(batch),
                         error=erro.reshape(batch),
                         steps=stepso.reshape(batch))
    if Io is None:
        return out, acto.reshape(batch)
    return out, acto.reshape(batch), Io.reshape(batch)


def raytrace_kernel(state, r_max=1e4, max_steps=10000, error_stop=1e-2,
                    emissivity=None, absorption=None, active0=None):
    """f32 kernel equivalent of `raytrace(state, ...)`, the counterpart of
    `raytrace_pallas`.

    Marches every ray to termination and returns (final RaytraceState,
    still_active mask) like `raytrace`.  CUDA tensors
    go to the CUDA kernel (or raise); CPU tensors go to `march_reference`.
    `active0` (optional, bool per ray) starts masked rays inactive.

    `emissivity(t, r, m, phi)` fuses radiative transfer into the march:
    each ray accumulates I = int j e^{-tau} dl along its backward march,
    and the return becomes (state, still_active, I).
    `absorption(t, r, m, phi)` (needs `emissivity`) adds the optical depth
    tau = int alpha dl; without it the transfer is optically thin.  Each
    is any torch callable of the elementwise ops of `model_trace.OPS`, as
    `raytrace_pallas` takes any pure jnp callable; a `GaussianSource`
    runs in the kernel's compiled-in family.  The models are traced first,
    on every device and anew on every call (the numbers a callable reads
    are those of this call): one the kernel cannot evaluate raises
    TypeError (or ValueError for a captured tensor that requires grad)
    before anything is built or launched.  The kernel takes that trace;
    the plain version on the CPU calls the callables themselves.
    """
    _, traced_j, traced_a = prepare(emissivity, absorption)
    tensors, scalars = _pack(state, r_max, max_steps, error_stop, active0)
    dev = tensors[0].device
    if dev.type == "cuda":
        outs = _march_cuda(*tensors, emissivity=traced_j,
                           absorption=traced_a, **scalars)
    elif dev.type == "cpu":
        outs = march_reference(*tensors, emissivity=emissivity,
                               absorption=absorption, **scalars)
    else:
        raise ValueError(f"no march kernel for device {dev}")
    return _unpack(state, outs)


def raytrace_reference(state, r_max=1e4, max_steps=10000, error_stop=1e-2,
                       emissivity=None, absorption=None, active0=None):
    """`raytrace_kernel` through the plain version, on any device."""
    tensors, scalars = _pack(state, r_max, max_steps, error_stop, active0)
    return _unpack(state, march_reference(*tensors, emissivity=emissivity,
                                          absorption=absorption, **scalars))
