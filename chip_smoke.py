#!/usr/bin/env python3
"""Drive the PyTorch / CUDA port on one GPU: the stepwise Kerr ray march,
volume radiative transfer, the Novikov-Thorne disk image, the analytic
azimuth and travel time, and the hot-spot light curve.

Run from the repository root on a machine with an NVIDIA H100:

    python3 chip_smoke.py

The march kernel (`sim5_tpu_torch/csrc/march.cu`, all its variants, run
in segments with the live rays compacted between them) and the disk image
kernel (`sim5_tpu_torch/csrc/disk_image.cu`, f64 and f32) are built into
`build/` on first use, both at once.  Phases, one line each:

1. device: the card's name and power limit, the builds (with a probe of
   single-function kernels for the SASS lengths of divisions, square roots
   and transcendentals), each kernel's compile-time choices, registers,
   spills and resident blocks of every main-path instance, and the SASS
   instruction counts where `cuobjdump` is there;
2. kernel vs its plain torch version on 4096 rays (GR, GR+POL, flat at
   a = 0.3 and 0.9);
3. the march's main path, 131072 rays at a = 0.9 to r = 500, through
   raytrace_prepare -> raytrace_kernel -> raytrace_error, with the
   reference's Carter-drift gates, the launch counts and the lane
   counters (lane-trips == sum of steps);
4. the f64 torch engine on 8192 rays of the same workload, same gates;
5. the march timed at 131072 rays (CUDA events, the minimum of
   TIMED_RUNS): ms, ray-steps/s, lane use and the bound, every run bitwise
   equal to the first; the time of each segment; the plain version once;
6. the transfer variants vs their plain version on the volume seed of
   64^2 pixels (example 11's torus, thin and thick);
7. the volume path's main path: volume_image(engine="kernel") at 512^2
   for alpha0 = 0 and 1, with the launch counts and the image gates;
8. the kernel route against the f64 loop engine at 96^2;
9. phase 5's timing and gates for the transfer variants at 512^2, thin
   and thick, and their plain version once;
10. the disk image against the C goldens on the card (128^2, a = 0 and
    0.998): the f64 kernel and the f64 plain version, each within 1e-6 of
    the peak with the golden's footprint (ondevice_f64_err_a0 / a998);
11. the disk image's main path, bench.py's headline frame (512^2, a =
    0.998, i = 80 deg, M = 10, mdot = 0.1, alpha = 0.1) through nt_setup ->
    render_disk_image in f64 and f32: the f64 kernel against the f64 plain
    version (1e-9 of the peak), the f32 kernel and the f32 plain version
    against the f64 plain version (4e-6 of the peak, footprint mismatch
    <= 1e-5 of the pixels: fast_path_err_vs_f64), one launch of each
    instance, and each launch's in-kernel counters, held against its image;
12. the disk image timed, by CUDA events around runs of IMAGE_REPS
    launches (min / median / max of IMAGE_RUNS): one headline frame a
    launch, 64 frames of the spin sweep (a = 0.998 - 2e-4 k) in one launch
    (device_ms_per_frame is a frame of the f32 one), the entry point one
    frame a call; every frame of the 64-frame launch bitwise its
    single-frame launch, in both instances; the f64 kernel on a batch of
    three spins at 128^2 against the plain version (1e-9 of the peak); the
    f32 spin sweep through nt_setup(spins) -> render_disk_image in one
    launch and as one call a frame, on the host clock (frames/s, one build
    for all spins); the plain versions once, and the bound from the main
    path's counters;
13. the analytic azimuth and travel time on the card: phi against the C
    golden's position samples (geod.txt, at least 97% within rtol 1e-4,
    atol 1e-6), the time delay against timedelay.txt (95% within rtol
    1e-5, atol 1e-7); then the card against the same torch code on the
    CPU in f64 at 64^2, for the volume seed's azimuth and the crossing
    map's (r, phi, g, delay): r and g within 1e-12 relative, phi and the
    delay within their per-pixel bounds (`phi_bound`, `time_bound`);
14. the volume path with its default azimuth stage and an orbiting
    source (example 07's spot as a 3-D `GaussianSource`: a = 0.5, 70 deg,
    r = 7, width, height and arc 0.7, omega = OmegaK(7, 0.5)):
    volume_image(engine="kernel") at 512^2 thin and thick with the
    launch counts and phase 7's gates, the seed's three stages timed
    apart, phase 8's gates at 128^2, the flux one orbital period later
    equal to 1e-3 (volume_lightcurve), and the march timed on the 512^2
    seed and held against its plain version on the same inputs, as in
    phase 9;
15. example 07's hot-spot light curve at its full size
    (hotspot_lightcurve at 192^2, orders 0 and 1, 96 samples over two
    periods): each crossing map, the curve given the maps and the entry
    point timed, and the crossing map at 512^2; finite and positive,
    sample k equal to sample k + 48 to 1e-9, delays of the hit pixels
    from exactly 0.

Then one JSON line on the kernels, the card's name and power limit, and
the result as the last line.  Any failed check exits non-zero.  The script
needs a CUDA device and imports nothing of JAX.
"""

import contextlib
import concurrent.futures
import json
import math
import os
import pathlib
import re
import shutil
import subprocess
import sys
import time
from collections import Counter

import numpy as np
import torch

SEED_MAIN = 3
N_CMP = 4096
N_MAIN = 131072
N_F64 = 8192             # cut from 16384 to keep the script near 600 s
MAIN = dict(a=0.9, precision=0.01, r_max=500.0, max_steps=4000)
# example 11's translucent torus (examples/11_thick_volume_transfer.py),
# axisymmetric seed, at bench.py's headline resolution
VOL = dict(a=0.9, incl=math.radians(70.0), rmax=16.0, r_start=40.0,
           max_steps=2000, precision=0.02, axisymmetric=True)
N_VOL_PIX = 512
N_VOL_CMP = 64
N_VOL_LOOP = 128         # the orbiting source against the f64 loop engine
N_VOL_LOOP_TORUS = 96    # the torus (cut from 128 to keep the script near
                         # 600 s)
ALPHA0 = (0.0, 1.0)
# example 07's hot spot (examples/07_hotspot_lightcurve.py: a = 0.5, 70 deg,
# r_spot = 7, size 0.7, two periods in 96 samples at 192^2, orders 0 and 1)
SPOT = dict(a=0.5, incl=math.radians(70.0), r_spot=7.0, size=0.7)
N_HOTSPOT = 192
HOTSPOT_T = 96
N_MAP = 512              # the crossing map at the volume path's resolution
N_ANALYTIC = 64          # the analytic engine, card against the CPU
# the same spot as a 3-D source orbiting at OmegaK(7, 0.5) (width, height
# and arc 0.7), through the volume path with its azimuth stage
VOL_SPOT = dict(a=SPOT["a"], incl=SPOT["incl"], rmax=17.5, r_start=40.0,
                max_steps=2000, precision=0.02, axisymmetric=False)
TIMED_RUNS = 6           # timed runs of each march (the minimum is kept)
# bench.py's headline frame (bench.py:293-295) and its spin sweep
NT = dict(M=10.0, a=0.998, mdot=0.1, alpha=0.1, incl=math.radians(80.0))
N_IMAGE = 512
N_GOLDEN = 128
N_SWEEP = 64             # frames of the spin sweep, a = 0.998 - 2e-4 k
IMAGE_REPS = 20          # launches between two CUDA events
IMAGE_RUNS = 5           # event pairs timed (min, median and max kept)
SWEEP_RUNS = 5           # host-clock runs of each spin sweep
BATCH_SPINS = (0.998, 0.9, 0.3)   # the f64 batch held against the plain one
N_BATCH = 128

# The least time of a march (bound_ms): FP32 operations per trial step,
# counted from csrc/march.cu for the GR, no-polarization instance, a
# multiply-add as two, each division, sqrtf, cosf and expf as one (so the
# bound is a lower one): 4 connection evaluations of 158 (each with one
# sqrtf and 4 divisions), 4 cosf (m is carried from the last accepted
# trial), 4 contractions -Gamma k k of 52, the step size 25, the RK4 stage
# updates and combination 98, the error check 49, accept/reject and
# termination 14.
OPS_TRIAL = 4 * 158 + 4 + 4 * 52 + 25 + 98 + 49 + 14
# per step with transfer: one torus evaluation (19, with its sqrtf and
# expf) and I += j dl; or two evaluations, dtau, s_eff and I += j e^-tau s
# (3 expf); counted on every trial, though only accepted ones run them
OPS_RT = (0, 19 + 2, 2 * 19 + 13)
# bytes per ray: x, k, f, kt, active in; x, k, f, kt, err, steps, active
# out; and I out with transfer
BYTES_RAY = 4 * 13 + 1 + 4 * 15 + 1
H100_FP32 = 67e12        # FP32 FLOP/s outside the tensor cores, 700 W
H100_FP64 = 34e12        # FP64 FLOP/s outside the tensor cores, 700 W
H100_BYTES = 3.35e12     # HBM3 bytes/s

# The least time of a disk image frame (image_bound): the operations each
# pixel class needs, counted from csrc/analytic.cuh, times the pixels of
# that class in the frame (image_counters()), over the peak rate of the
# type.  A piece is (flops, {op: count}): flops are +, -, * (comparisons,
# selects, abs and negation not counted), and each division, square root
# and transcendental counts as the length of its SASS sequence on this card
# (op_lengths(): the instructions of a kernel that computes it, before
# EXIT, less those of x + y).  Where a piece's work depends on data that
# the counters do not split, the cheaper branch is counted (the Jacobi
# AGM's backward pass at one level), and a piece of every pixel is counted
# once a pixel: make_frame's once-a-frame work is left out.  The kernel is
# built with --fmad=false, so each counted operation is one instruction,
# while the peak counts an FMA as two: at the instruction issue rate the
# floor is twice the bound, and phase 12 prints it beside the bound.
def _piece(flops=0, **ops):
    return flops, ops


def _add(*pieces):
    flops, ops = 0, Counter()
    for f, o in pieces:
        flops += f
        ops.update(o)
    return flops, dict(ops)


def pixel_pieces(dtype):
    """{piece: (flops, {op: count})} of one pixel of the disk image in
    `dtype`, by the depths of csrc/analytic.cuh's Prec<T>."""
    f64 = dtype == torch.float64
    rf_dup, k_agm, jac = (16, 9, 13) if f64 else (7, 7, 8)
    rf = _piece(10 * rf_dup + 18, sqrt=3 * rf_dup + 1, div=5)
    K = _piece(3 * k_agm + 2, sqrt=k_agm + 1, div=1)
    sncndn = _piece(4 * jac + 9, sqrt=jac + 1, div=4, sin=1, cos=1)
    vlog = _piece(1, log1p=1) if f64 else _piece(14, div=3)
    rescale = _piece() if f64 else _piece(9, div=1, frexp=3, ldexp=1)
    # the quartic, sort and two-float polish by root pattern, then
    # R_roots' own branch
    rr = _add(_piece(79, div=20, sqrt=5, pow=1, acos=1, cos=3),
              _piece(4 * 107, div=8), _piece(19, sqrt=2, div=4))
    rc = _add(_piece(84, div=19, sqrt=4, pow=2), _piece(2 * 107 + 2 * 74,
                                                       div=4),
              _piece(40, sqrt=4, div=7))
    cc = _add(_piece(84, div=19, sqrt=4, pow=2), _piece(4 * 74),
              _piece(37, sqrt=4, div=8))
    return {
        # the grid, init_inf's own, T_roots, the quartic's coefficients,
        # Tpp's K, Tip's rf and the order-0 crossing
        "pixel": _add(_piece(63, div=10, sqrt=5), K, rf, rescale),
        "RR": rr, "RC": rc, "CC": cc, "rf": rf, "K": K,
        "rad_RR": _add(_piece(30, sqrt=1, div=2), sncndn),
        "rad_RC": _add(_piece(45, sqrt=3, div=6), sncndn),
        "rad_CC": _add(_piece(38, sqrt=3, div=6), sncndn),
        "cross": _piece(3, div=1, sqrt=1),
        # gfactorK, nt_flux with its four vlog, F g^4
        "shade": _add(_piece(65 + 42 + 3, sqrt=3, div=10), *[vlog] * 4),
    }


def pixel_mix(c):
    """{piece: pixels} of a frame from its counters (lanes)."""
    lanes = {k: v[1] for k, v in c.items()}
    return {
        "pixel": lanes["pixels"],
        "RR": lanes["type_RR"] + lanes["type_RR_BH"] + lanes["type_RR_double"],
        "RC": lanes["type_RC"], "CC": lanes["type_CC"],
        "rf": lanes["rf_R"], "K": lanes["K_R"],
        "rad_RR": lanes["rad0_RR"] + lanes["rad1_RR"],
        "rad_RC": lanes["rad0_RC"] + lanes["rad1_RC"],
        "rad_CC": lanes["rad0_CC"] + lanes["rad1_CC"],
        "cross": lanes["order1"], "shade": lanes["shade"]}


def image_ops(dtype, counters, lengths):
    """Operations of the frames the counters describe, each op at its SASS
    length (`lengths`, {(op, 'd' or 'f'): n}; 1 where not measured)."""
    t = "d" if dtype == torch.float64 else "f"
    pieces = pixel_pieces(dtype)
    total = 0
    for piece, n in pixel_mix(counters).items():
        flops, ops = pieces[piece]
        total += n * (flops + sum(k * lengths.get((op, t), 1)
                                  for op, k in ops.items()))
    return total


PEAK = {torch.float64: H100_FP64, torch.float32: H100_FP32}


class PhaseFailed(Exception):
    pass


def check(ok, msg):
    if not ok:
        raise PhaseFailed(msg)


def card():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def zamo_rays(n, a, seed, dtype, device, outward=0.0, flat=False, pol=False):
    """Rays off ZAMO tetrads at r in [6, 15], |m| < 0.5, random local
    directions (outward-biased by `outward`), from a numpy seed.
    Returns (x, k, f0); f0 is the tetrad's e2 leg when `pol`."""
    from sim5_tpu_torch.core import (kerr_metric, flat_metric, tetrad_zamo,
                                     on2bl)
    rng = np.random.default_rng(seed)
    r = rng.uniform(6.0, 15.0, n)
    m = rng.uniform(-0.5, 0.5, n)
    th = rng.uniform(0.3, np.pi - 0.3, n)
    ph = rng.uniform(0.0, 2 * np.pi, n)

    def t(v):
        return torch.as_tensor(v, dtype=dtype, device=device)

    r, m, th, ph = t(r), t(m), t(th), t(ph)
    met = flat_metric(r, m) if flat else kerr_metric(t(a), r, m)
    T = tetrad_zamo(met)
    d = torch.stack([torch.sin(th) * torch.cos(ph) + outward,
                     torch.sin(th) * torch.sin(ph), torch.cos(th)], -1)
    d = d / torch.linalg.vector_norm(d, dim=-1, keepdim=True)
    kloc = torch.cat([torch.ones_like(r)[:, None], d], -1)
    k = on2bl(kloc, T)
    x = torch.stack([torch.zeros_like(r), r, m, torch.zeros_like(r)], -1)
    f0 = on2bl(t([0.0, 0.0, 1.0, 0.0]).expand(n, 4), T) if pol else None
    return x, k, f0


def compare(st_k, st_p, pol):
    """Kernel vs plain results: (equal-steps share, max rel dr, max dtheta,
    max |df|, max |dr|) over the rays with equal step counts."""
    sk, sp = st_k.steps.cpu().numpy(), st_p.steps.cpu().numpy()
    xk, xp = st_k.x.double().cpu().numpy(), st_p.x.double().cpu().numpy()
    eq = sk == sp
    both = eq & np.isfinite(xk[:, 1]) & np.isfinite(xp[:, 1])
    dr = np.abs(xk[:, 1] - xp[:, 1])
    rel = (dr / np.maximum(np.abs(xp[:, 1]), 1.0))[both]
    dth = np.abs(np.arccos(np.clip(xk[:, 2], -1, 1))
                 - np.arccos(np.clip(xp[:, 2], -1, 1)))[both]
    df = 0.0
    if pol:
        fk, fp = st_k.f.double().cpu().numpy(), st_p.f.double().cpu().numpy()
        df = float(np.abs(fk - fp)[both].max())
    return (float(eq.mean()), float(rel.max()), float(dth.max()), df,
            float(dr[both].max()))


# march_f32<GR, POL, RT> in a mangled name
INSTANCE = re.compile(r"march_f32ILb([01])ELb([01])ELi([0-9])E")


def march_label(m):
    return f"GR={m[1]} POL={m[2]} RT={m[3]}"


def ptxas_summary(log, instance=INSTANCE, label=march_label):
    """'<label>: N regs, stack frame and spills' per kernel instance (the
    march's by default), from the compiler's -Xptxas -v report kept beside
    the library."""
    if not os.path.exists(log):
        return "no report (library was cached without its log)"
    out, kernel, spill = [], None, ""
    for ln in open(log).read().splitlines():
        entry = (instance.search(ln) if "Compiling entry function" in ln
                 else None)
        regs = re.search(r"Used (\d+) registers", ln)
        if entry:
            kernel = label(entry)
        elif "spill" in ln and kernel:
            spill = ln.strip()
        elif regs and kernel:
            out.append(f"{kernel}: {regs[1]} regs, {spill}")
            kernel = None
    return "; ".join(out)


SASS_OP = re.compile(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)")


def _cuobjdump():
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    return tool if os.path.exists(tool) else None


def sass_counts(lib_path, instance=INSTANCE,
                key=lambda m: tuple(int(g) for g in m.groups())):
    """{key: Counter of SASS opcodes} of each kernel instance in the
    library (the march's by default, keyed (GR, POL, RT)); a static count:
    each instruction of the function once.  None without cuobjdump."""
    tool = _cuobjdump()
    if tool is None:
        return None
    text = subprocess.run([tool, "-sass", str(lib_path)], capture_output=True,
                          text=True, timeout=300, check=True).stdout
    counts, cur = {}, None
    for ln in text.splitlines():
        if "Function :" in ln:
            m = instance.search(ln)
            cur = counts.setdefault(key(m), Counter()) if m else None
        elif cur is not None:
            op = SASS_OP.match(ln)
            if op:
                cur[op[1].split(".")[0]] += 1
    return counts


def image_sass_summary(counts):
    """Static SASS counts of each disk image instance: all, FP64, FP32,
    MUFU, CALL, and local loads and stores."""
    if counts is None:
        return "not measured (no cuobjdump)"
    out = []
    for name, c in sorted(counts.items()):
        fp64 = sum(c[o] for o in ("DFMA", "DMUL", "DADD", "DSETP", "DMNMX"))
        fp32 = sum(c[o] for o in ("FFMA", "FMUL", "FADD", "FMNMX", "FSETP",
                                  "FSEL", "FCHK"))
        out.append(f"{name}: {sum(c.values())} instructions, FP64 {fp64}, "
                   f"FP32 {fp32}, MUFU {c['MUFU']}, CALL {c['CALL']}, BRA "
                   f"{c['BRA']}, LDL {c['LDL']}, STL {c['STL']}")
    return "; ".join(out)


# kernels that each compute one function of two loaded values, for the
# SASS length of the function (op_lengths)
OP_LENGTH_SRC = r"""
#include <cuda_runtime.h>
#include <cmath>
#define K1(NAME, EXPR)                                                      \
  template <typename T>                                                     \
  __global__ void NAME(const T* in, T* out) {                               \
    const T x = in[threadIdx.x], y = in[threadIdx.x + 32];                  \
    out[threadIdx.x] = EXPR;                                                \
  }                                                                         \
  template __global__ void NAME<double>(const double*, double*);            \
  template __global__ void NAME<float>(const float*, float*);
__device__ double fr(double x) { int e; double m = frexp(x, &e); return m + e; }
__device__ float fr(float x) { int e; float m = frexpf(x, &e); return m + e; }
K1(op_base, x + y)
K1(op_div, x / y)
K1(op_sqrt, sqrt(x) + y)
K1(op_sin, sin(x) + y)
K1(op_cos, cos(x) + y)
K1(op_acos, acos(x) + y)
K1(op_log1p, log1p(x) + y)
K1(op_pow, pow(x, y))
K1(op_frexp, fr(x) + y)
K1(op_ldexp, ldexp(x, (int)y))
"""


def op_lengths():
    """{(op, 'd' or 'f'): SASS instructions} of each division, square root
    and transcendental the image kernel calls, built as the kernel is
    (sm_90a, --fmad=false, no fast math): a one-function kernel's
    instructions before its EXIT, less those of x + y (plus one for the
    binary ones, which replace the add).  An out-of-line slow path after
    EXIT is not counted; one inlined and branched over is.  {} without
    cuobjdump."""
    from sim5_tpu_torch import _build
    tool = _cuobjdump()
    if tool is None:
        return {}
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src = _build.BUILD_DIR / "op_lengths.cu"
    cubin = src.with_suffix(".cubin")
    src.write_text(OP_LENGTH_SRC)
    subprocess.run([_build._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
                    "-std=c++17", "-O3", "-cubin", "--fmad=false", "-o",
                    str(cubin), str(src)], check=True, capture_output=True,
                   timeout=300)
    text = subprocess.run([tool, "-sass", str(cubin)], capture_output=True,
                          text=True, timeout=300, check=True).stdout
    raw, cur = {}, None
    for ln in text.splitlines():
        if "Function :" in ln:
            m = re.search(r"op_(\w+?)I([df])E", ln)
            cur = (m[1], m[2]) if m else None
            if cur:
                raw[cur] = 0
        elif cur is not None:
            op = SASS_OP.match(ln)
            if op and op[1].startswith("EXIT"):
                cur = None
            elif op:
                raw[cur] += 1
    return {(op, t): n - raw[("base", t)] + (op in ("div", "pow", "ldexp"))
            for (op, t), n in raw.items() if op != "base"}


def sass_summary(counts, key):
    """Static SASS counts of one instance: all, FP32 arithmetic, MUFU
    (reciprocal, square-root and exponent seeds), branches and calls."""
    if counts is None:
        return "not measured (no cuobjdump)"
    c = counts[key]
    fp = sum(c[o] for o in ("FFMA", "FMUL", "FADD", "FMNMX", "FSETP",
                            "FSEL", "FCHK"))
    return (f"GR={key[0]} POL={key[1]} RT={key[2]}: {sum(c.values())} "
            f"instructions, FP32 {fp} (FFMA {c['FFMA']}, FMUL {c['FMUL']}, "
            f"FADD {c['FADD']}), MUFU {c['MUFU']}, BRA {c['BRA']}, CALL "
            f"{c['CALL']}")


def march_bound(n, ray_steps, rt):
    """(bound_ms, bound_by) of a march of n rays that made `ray_steps`
    trial steps in all, with transfer variant `rt`: the larger of its
    operations over the FP32 peak and its bytes over the memory rate."""
    t_ops = ray_steps * (OPS_TRIAL + OPS_RT[rt]) / H100_FP32
    t_bytes = n * (BYTES_RAY + (4 if rt else 0)) / H100_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def same_bits(outs_a, outs_b):
    """Whether two marches' outputs are bitwise equal, NaN included."""
    for a, b in zip(outs_a, outs_b):
        if (a is None) != (b is None):
            return False
        if a is None:
            continue
        if a.dtype == torch.float32:
            a, b = a.view(torch.int32), b.view(torch.int32)
        if not torch.equal(a, b):
            return False
    return True


def lane_use(counters):
    lane_trips, warp_trips, _ = counters
    return lane_trips / (32 * warp_trips) if warp_trips else float("nan")


def check_counters(tag, counters, steps):
    """lane-trips == sum of steps, and the last launch appended no ray."""
    lane_trips, _, appended = counters
    total = int(steps.long().sum())
    check(lane_trips == total, f"{tag}: lane-trips {lane_trips} != sum of "
          f"steps {total}")
    check(appended[-1] == 0, f"{tag}: the last launch appended "
          f"{appended[-1]} rays")


def march_timing(tensors, kw):
    """The segmented march on the same inputs: one warm-up, then
    TIMED_RUNS runs, each timed by CUDA events.  Returns (min ms, outputs
    of the first timed run, its lane counters) and whether every run gave
    bitwise the outputs of the first."""
    from sim5_tpu_torch.march import kernel_march
    kernel_march._march_cuda(*tensors, **kw)
    best, first, counters, same = float("inf"), None, None, True
    for _ in range(TIMED_RUNS):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        outs = kernel_march._march_cuda(*tensors, **kw)
        e1.record()
        torch.cuda.synchronize()
        best = min(best, e0.elapsed_time(e1))
        if first is None:
            first, counters = outs, kernel_march.march_counters()
        same = same and same_bits(outs, first)
    return (best, first, counters), same


def segment_profile(tensors, kw, resident_lanes):
    """One segmented march with a CUDA event after each launch: the ms of
    each launch, the rays live at its entry, and the ms of the launches
    entered with fewer live rays than the card keeps resident lanes, than
    10% and than 1% of the rays."""
    from sim5_tpu_torch.march import kernel_march
    events = []
    kernel_march._march_cuda(*tensors, events=events, **kw)
    torch.cuda.synchronize()
    ms = [a.elapsed_time(b) for a, b in zip(events, events[1:])]
    n = tensors[3].shape[0]
    live = [n] + kernel_march.march_counters()[2][:-1]
    total = sum(ms)
    part = {"below resident lanes": resident_lanes,
            "below 10% of rays": n / 10, "below 1% of rays": n / 100}
    tails = {k: sum(t for t, v in zip(ms, live) if v < lim)
             for k, lim in part.items()}
    text = (f"{len(ms)} launches {total:.3f} ms; " + "; ".join(
        f"{k}: {t:.3f} ms ({t / total:.3f})" for k, t in tails.items())
        + f"; first launch {ms[0]:.3f} ms; ms per launch "
        + " ".join(f"{t:.3f}" for t in ms)
        + "; live at entry " + " ".join(str(v) for v in live))
    return text


def resident_lanes(rt):
    """Threads of march_f32<GR, no POL, rt> the card keeps resident."""
    from sim5_tpu_torch.march import kernel_march
    att = kernel_march.kernel_attributes(True, False, rt)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return att["blocks_per_sm"] * kernel_march.kernel_config()["threads"] * sms


def instance_text(rt):
    from sim5_tpu_torch.march import kernel_march
    att = kernel_march.kernel_attributes(True, False, rt)
    return (f"GR RT={rt}: {att['registers']} registers, {att['local_bytes']} "
            f"bytes local, {att['blocks_per_sm']} blocks an SM")


# nt_image<T, C> in a mangled name (T = d for double, f for float; C = 1
# for the counted instance)
IMAGE_INSTANCE = re.compile(r"nt_imageI([df])Lb([01])E")


def image_label(m):
    return ("nt_image<" + ("double" if m[1] == "d" else "float")
            + (", counted>" if m[2] == "1" else ">"))


def phase_device():
    from sim5_tpu_torch._build import BUILDS
    from sim5_tpu_torch.march import kernel_march
    from sim5_tpu_torch.render import kernel_image
    name = card()
    # one nvcc for each source (and the op-length probe), all started
    # together
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(3) as pool:
        futs = [pool.submit(kernel_march._lib), pool.submit(kernel_image._lib),
                pool.submit(op_lengths)]
        lengths = [f.result() for f in futs][2]
    build_s = time.perf_counter() - t0
    b, bi = BUILDS["march"], BUILDS["disk_image"]
    cfg = kernel_march.kernel_config()
    image_att = "; ".join(
        f"{names[dt]}: {att['registers']} registers, {att['local_bytes']} "
        f"bytes local, {att['blocks_per_sm']} blocks an SM"
        for counted, names in ((False, kernel_image.VARIANTS),
                               (True, kernel_image.COUNTED))
        for dt, att in ((dt, kernel_image.kernel_attributes(dt, counted))
                        for dt in names))
    image_sass = sass_counts(bi["path"], IMAGE_INSTANCE, image_label)
    print(f"phase 1 device: {name} | torch {torch.__version__} cuda "
          f"{torch.version.cuda} | builds {build_s:.2f} s together: march "
          f"{b['seconds']:.2f} s cached={b['cached']}, disk_image "
          f"{bi['seconds']:.2f} s cached={bi['cached']} | {cfg} | "
          + "; ".join(instance_text(rt) for rt in range(3))
          + f" | ptxas: {ptxas_summary(b['log'])} | SASS (static): "
          + "; ".join(sass_summary(sass_counts(b["path"]), (1, 0, rt))
                      for rt in range(3))
          + f" | image: {kernel_image.kernel_config()}; {image_att} | image "
          f"ptxas: " + ptxas_summary(bi["log"], IMAGE_INSTANCE, image_label)
          + f" | image SASS (static): {image_sass_summary(image_sass)} | SASS "
          f"lengths (f64 d, f32 f): "
          + (", ".join(f"{op}_{t} {n}" for (op, t), n in sorted(
              lengths.items())) or "not measured (no cuobjdump)"),
          flush=True)
    return name, lengths


def phase_compare(dev):
    from sim5_tpu_torch.march import (raytrace_prepare, raytrace_kernel,
                                      raytrace_reference, RTOPT_FLAT,
                                      RTOPT_POLARIZATION)
    worst = dict(eq=1.0, rel=0.0, dth=0.0, df=0.0)
    for a in (0.3, 0.9):
        for variant in ("gr", "gr+pol", "flat"):
            pol, flat = variant == "gr+pol", variant == "flat"
            x, k, f0 = zamo_rays(N_CMP, a, seed=0, dtype=torch.float32,
                                 device=dev, flat=flat, pol=pol)
            opts = (RTOPT_POLARIZATION if pol else 0) | (RTOPT_FLAT if flat
                                                         else 0)
            st0 = raytrace_prepare(a, x, k, f=f0, precision=0.01,
                                   options=opts)
            kw = dict(r_max=50.0, max_steps=300)
            st_k, _ = raytrace_kernel(st0, **kw)
            st_p, _ = raytrace_reference(st0, **kw)
            torch.cuda.synchronize()
            eq, rel, dth, df, _ = compare(st_k, st_p, pol)
            tag = f"a={a} {variant}"
            check(eq > 0.9, f"{tag}: equal steps on only {eq:.4f} of rays")
            check(rel < 1e-3, f"{tag}: relative dr {rel:.2e} >= 1e-3")
            check(dth < 1e-3, f"{tag}: dtheta {dth:.2e} >= 1e-3")
            check(df < 2e-3, f"{tag}: |df| {df:.2e} >= 2e-3")
            worst = dict(eq=min(worst["eq"], eq), rel=max(worst["rel"], rel),
                         dth=max(worst["dth"], dth), df=max(worst["df"], df))
    print(f"phase 2 kernel vs plain ({N_CMP} rays, a in (0.3, 0.9), gr / "
          f"gr+pol / flat, r_max 50, 300 steps): equal steps >= "
          f"{worst['eq']:.4f} (gate > 0.9), rel dr <= {worst['rel']:.3e} "
          f"(gate 1e-3), dtheta <= {worst['dth']:.3e} (gate 1e-3), "
          f"|df| <= {worst['df']:.3e} (gate 2e-3)", flush=True)
    return worst


def drift_gates(tag, st, act, r_max, raytrace_error):
    r_fin = st.x[..., 1].double().cpu().numpy()
    done = ~act.cpu().numpy()
    drift = raytrace_error(st).double().cpu().numpy()
    nan_frac = float((~np.isfinite(r_fin)).mean())
    esc = done & (r_fin >= r_max) & np.isfinite(drift)
    check(nan_frac == 0.0, f"{tag}: NaN fraction {nan_frac:.2e}")
    check(done.mean() > 0.99, f"{tag}: only {done.mean():.4f} finished")
    check(esc.mean() > 0.99, f"{tag}: only {esc.mean():.4f} escaped")
    med = float(np.median(drift[esc]))
    p99 = float(np.percentile(drift[esc], 99))
    check(med <= 1e-4, f"{tag}: median Carter drift {med:.3e} > 1e-4")
    check(p99 <= 1e-3, f"{tag}: p99 Carter drift {p99:.3e} > 1e-3")
    return dict(nan_frac=nan_frac, finished=float(done.mean()),
                escaped=float(esc.mean()), drift_median=med, drift_p99=p99)


def main_path(n, dtype, dev, engine):
    from sim5_tpu_torch.march import raytrace_prepare
    x, k, _ = zamo_rays(n, MAIN["a"], SEED_MAIN, dtype, dev, outward=1.0)
    st0 = raytrace_prepare(MAIN["a"], x, k, precision=MAIN["precision"])
    return engine(st0, r_max=MAIN["r_max"], max_steps=MAIN["max_steps"])


def phase_main(dev):
    from sim5_tpu_torch.march import (raytrace_kernel, raytrace_error,
                                      kernel_march)
    kernel_march.LAUNCHES.update(dict.fromkeys(kernel_march.LAUNCHES, 0))
    t0 = time.perf_counter()
    st, act = main_path(N_MAIN, torch.float32, dev, raytrace_kernel)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = dict(kernel_march.LAUNCHES)
    launches = counts["march_f32"]
    check(launches >= 1, "main path launched the march kernel 0 times")
    counters = kernel_march.march_counters()
    check_counters("main path", counters, st.steps)
    g = drift_gates("main path", st, act, MAIN["r_max"], raytrace_error)
    steps = int(st.steps.long().sum())
    print(f"phase 3 main path ({N_MAIN} rays f32, a=0.9, r_max 500, 4000 "
          f"steps): LAUNCHES={counts} nan_frac={g['nan_frac']} finished="
          f"{g['finished']:.5f} escaped={g['escaped']:.5f} drift median="
          f"{g['drift_median']:.3e} p99={g['drift_p99']:.3e} ray-steps="
          f"{steps} mean steps={steps / N_MAIN:.1f} max steps="
          f"{int(st.steps.max())} lane-trips={counters[0]} (== sum of "
          f"steps) warp-trips={counters[1]} lane use="
          f"{lane_use(counters):.4f} wall={secs:.3f} s", flush=True)
    return counts, g


def phase_f64(dev):
    from sim5_tpu_torch.march import raytrace, raytrace_error
    t0 = time.perf_counter()
    st, act = main_path(N_F64, torch.float64, dev, raytrace)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    g = drift_gates("f64 engine", st, act, MAIN["r_max"], raytrace_error)
    print(f"phase 4 f64 torch engine ({N_F64} rays): nan_frac="
          f"{g['nan_frac']} finished={g['finished']:.5f} escaped="
          f"{g['escaped']:.5f} drift median={g['drift_median']:.3e} p99="
          f"{g['drift_p99']:.3e} steps={int(st.steps.max())} "
          f"wall={secs:.2f} s", flush=True)
    return g


def timing_report(tag, n, rt, timing, same, plain_outs, plain_ms,
                  compare_fn):
    """Gate and describe one march timing: returns (text, row)."""
    check(same, f"{tag}: two runs of the segmented march are not bitwise "
          f"equal")
    ms, outs, counters = timing
    check_counters(tag, counters, outs[5])
    ray_steps = int(outs[5].long().sum())
    bound_ms, bound_by = march_bound(n, ray_steps, rt)
    row = dict(ms=ms, plain_ms=plain_ms, max_abs_err=compare_fn(outs,
                                                                plain_outs),
               bound_ms=bound_ms, bound_by=bound_by)
    text = (f"segmented {ms:.3f} ms (min of {TIMED_RUNS}) "
            f"{ray_steps / (ms * 1e-3):.4e} ray-steps/s lane use "
            f"{lane_use(counters):.4f} ({bound_ms / ms:.3f} of bound) | bound "
            f"{bound_ms:.3f} ms ({bound_by}) | all {TIMED_RUNS} timed runs "
            f"bitwise equal, steps equal on every ray | plain "
            f"{plain_ms:.3f} ms")
    return text, row


def phase_timing(dev, name):
    """The segmented march (CUDA events, min of TIMED_RUNS) and the plain
    version once (it is host-launch-bound and takes tens of seconds) on
    the main path's packed inputs.  Holds the runs bitwise equal and the
    kernel against the plain version."""
    from sim5_tpu_torch.march import raytrace_prepare, kernel_march
    x, k, _ = zamo_rays(N_MAIN, MAIN["a"], SEED_MAIN, torch.float32, dev,
                        outward=1.0)
    st0 = raytrace_prepare(MAIN["a"], x, k, precision=MAIN["precision"])
    tensors, scalars = kernel_march._pack(st0, MAIN["r_max"],
                                          MAIN["max_steps"], 1e-2, None)
    timing, same = march_timing(tensors, scalars)
    ms_p, out_p = timed(kernel_march.march_reference, tensors, scalars)
    st_p, _ = kernel_march._unpack(st0, out_p)
    st_k, _ = kernel_march._unpack(st0, timing[1])
    eq, rel, _, _, _ = compare(st_k, st_p, False)
    check(eq > 0.9, f"main shape: equal steps on only {eq:.4f} of rays")
    check(rel < 1e-3, f"main shape: relative dr {rel:.3e} >= 1e-3")

    def max_dr(outs, plain):
        return compare(kernel_march._unpack(st0, outs)[0], st_p, False)[4]

    text, row = timing_report("main shape", N_MAIN, 0, timing, same, out_p,
                              ms_p, max_dr)
    segs = segment_profile(tensors, scalars, resident_lanes(0))
    print(f"phase 5 timing ({N_MAIN} rays f32, a=0.9, r_max 500; {name}): "
          f"{text} | kernel vs plain: equal steps {eq:.4f} rel dr "
          f"{rel:.3e} | segments: {segs}", flush=True)
    return row


def timed(fn, tensors, scalars):
    """(ms, outputs) of one run of fn(*tensors, **scalars), by CUDA
    events."""
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    outs = fn(*tensors, **scalars)
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1), outs


def torus(alpha0=1.0):
    """Example 11's torus emissivity (alpha0 = 1) or its absorption
    alpha0 * j (None for alpha0 = 0, the thin limit)."""
    from sim5_tpu_torch.march.emission import GaussianSource
    if alpha0 == 0.0:
        return None
    return GaussianSource(amp=alpha0, center=8.0, inv_width=1.0 / 1.5,
                          inv_height=1.0 / 1.5, cylindrical=True)


def volume_seed_f32(npix, dev, cfg=VOL):
    """The f64 analytic seed of a volume configuration at npix^2, cast to
    f32 as the kernel route does, and the valid mask, as a flat batch of
    npix^2 rays."""
    from sim5_tpu_torch.render import lightcurve
    kw = {k: cfg[k] for k in ("rmax", "r_start", "precision",
                              "axisymmetric")}
    st, ok = lightcurve._volume_seed(cfg["a"], cfg["incl"], 0.0, npix=npix,
                                     device=dev, **kw)
    st = lightcurve._as_f32(st)
    flat = {f: getattr(st, f).flatten(0, 1) for f in (
        "x", "k", "f", "a", "E", "Q", "kt", "error", "steps", "step_epsilon",
        "step_epsilon0")}
    return st._replace(**flat), ok.flatten()


def compare_transfer(out_k, out_p, st0):
    """Kernel vs plain transfer march: (equal-steps share, max rel dr over
    equal finite rays, max |dI| over equal rays, peak I of the plain)."""
    from sim5_tpu_torch.march import kernel_march
    st_k, _, I_k = kernel_march._unpack(st0, out_k)
    st_p, _, I_p = kernel_march._unpack(st0, out_p)
    eq, rel, _, _, _ = compare(st_k, st_p, False)
    same = (st_k.steps == st_p.steps).cpu().numpy()
    dI = (I_k.double() - I_p.double()).abs().cpu().numpy()[same]
    return eq, rel, float(dI.max()), float(I_p.double().max())


@contextlib.contextmanager
def launch_events():
    """CUDA events around every march kernel launch made in the block."""
    from sim5_tpu_torch.march import kernel_march
    launch, events = kernel_march._march_cuda, []

    def bracketed(*args, **kw):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        outs = launch(*args, **kw)
        e1.record()
        events.append((e0, e1))
        return outs

    kernel_march._march_cuda = bracketed
    try:
        yield events
    finally:
        kernel_march._march_cuda = launch


def phase_transfer_compare(dev):
    """The transfer variants vs their plain version on the seeded rays of
    a 64^2 image, thin and thick."""
    from sim5_tpu_torch.march import kernel_march
    st0, ok = volume_seed_f32(N_VOL_CMP, dev)
    tensors, scalars = kernel_march._pack(
        st0, 1.2 * VOL["r_start"], VOL["max_steps"], 1e-2, ok)
    parts = []
    for alpha0 in ALPHA0:
        kw = dict(scalars, emissivity=torus(), absorption=torus(alpha0))
        out_k = kernel_march._march_cuda(*tensors, **kw)
        out_p = kernel_march.march_reference(*tensors, **kw)
        torch.cuda.synchronize()
        eq, rel, dI, peak = compare_transfer(out_k, out_p, st0)
        tag = f"alpha0={alpha0}"
        check(peak > 0.0, f"{tag}: plain peak I is {peak}")
        check(eq > 0.9, f"{tag}: equal steps on only {eq:.4f} of rays")
        check(rel < 1e-3, f"{tag}: relative dr {rel:.3e} >= 1e-3")
        check(dI <= 1e-3 * peak, f"{tag}: |dI| {dI:.3e} > 1e-3 of peak "
              f"{peak:.4e}")
        parts.append(f"{tag}: equal steps {eq:.4f} rel dr {rel:.3e} |dI| "
                     f"{dI:.3e} ({dI / peak:.3e} of peak {peak:.4e})")
    print(f"phase 6 transfer kernel vs plain ({N_VOL_CMP}^2 seeded rays, "
          f"GR; gates: equal steps > 0.9, rel dr < 1e-3, |dI| <= 1e-3 of "
          f"peak): " + " | ".join(parts), flush=True)


def volume_kw(cfg, npix):
    """volume_image's keywords of a volume configuration at npix^2."""
    return dict(npix=npix, rmax=cfg["rmax"], r_start=cfg["r_start"],
                max_steps=cfg["max_steps"], precision=cfg["precision"],
                axisymmetric=cfg["axisymmetric"])


def volume_main(dev, cfg=VOL, source=None):
    """A volume main path: volume_image(engine="kernel") at 512^2 of
    `source` (alpha0 -> model or None; the torus by default), thin then
    thick, through the entry point a user calls, each with the launch
    counts set to 0 just before it.  Returns (images, launches a
    variant, march ms a variant, text of each, text of the thick-thin
    gate)."""
    from sim5_tpu_torch.march import kernel_march
    from sim5_tpu_torch.render import lightcurve, volume_image
    source = source or torus
    images, launches, march, parts = {}, {}, {}, []
    for alpha0 in ALPHA0:
        kernel_march.LAUNCHES.update(dict.fromkeys(kernel_march.LAUNCHES, 0))
        t0 = time.perf_counter()
        with launch_events() as events:
            I = volume_image(cfg["a"], cfg["incl"], source(),
                             engine="kernel", absorption_fn=source(alpha0),
                             **volume_kw(cfg, N_VOL_PIX))
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = dict(kernel_march.LAUNCHES)
        march_ms = sum(e0.elapsed_time(e1) for e0, e1 in events)
        variant = kernel_march.VARIANTS[1 if alpha0 == 0.0 else 2]
        check(counts[variant] >= 1,
              f"alpha0={alpha0}: the image launched {variant} 0 times")
        launches[variant] = counts[variant]
        march[variant] = march_ms
        # the seed alone, warm, on the host clock
        t0 = time.perf_counter()
        lightcurve._volume_seed(
            cfg["a"], cfg["incl"], 0.0, npix=N_VOL_PIX, rmax=cfg["rmax"],
            r_start=cfg["r_start"], precision=cfg["precision"],
            axisymmetric=cfg["axisymmetric"], device=dev)
        torch.cuda.synchronize()
        seed_s = time.perf_counter() - t0
        Id = I.double()
        peak = float(Id.max())
        check(tuple(I.shape) == (N_VOL_PIX, N_VOL_PIX),
              f"image shape {tuple(I.shape)}")
        check(bool(torch.isfinite(Id).all()), f"alpha0={alpha0}: non-finite I")
        check(bool((Id >= 0.0).all()), f"alpha0={alpha0}: negative I")
        check(peak > 0.0, f"alpha0={alpha0}: peak I {peak}")
        images[alpha0] = Id
        parts.append(f"alpha0={alpha0}: {variant} LAUNCHES={counts[variant]} "
                     f"(all {counts}) flux {float(Id.sum()):.6e} peak "
                     f"{peak:.6e} | image {wall:.3f} s (host clock), march "
                     f"{march_ms:.3f} ms (CUDA events), seed alone "
                     f"{seed_s:.3f} s (host clock)")
    thin, thick = images[0.0], images[1.0]
    peak = float(thin.max())
    excess = float((thick - thin).max())
    # Absorption only removes light, but the thick branch of the Pallas body
    # (which the kernel follows) takes s_eff = (1 - expf(-dtau)) / alpha in
    # f32: expf's error of up to 2 ulp near 1 lets s_eff exceed dl by up to
    # 2^-23 / alpha on an accepted step with dtau > 1e-6, so a thick pixel
    # may exceed its thin one by 2^-23 j / alpha a step (j / alpha =
    # 1 / alpha0 for the torus and the spot), on at most max_steps steps.
    allow = 1e-6 * peak + cfg["max_steps"] * 2.0 ** -23 / ALPHA0[1]
    check(excess <= allow, f"thick exceeds thin by {excess:.3e} > "
          f"{allow:.3e} (1e-6 of peak {peak:.4e} + f32 rounding of s_eff)")
    check(float(thick.sum()) < float(thin.sum()),
          "thick total flux is not below thin")
    gate = (f"thick - thin <= {excess:.3e} = {excess / peak:.3e} of peak "
            f"(gate {allow:.3e}: 1e-6 of peak + max_steps 2^-23 / alpha0), "
            f"flux ratio thick/thin "
            f"{float(thick.sum()) / float(thin.sum()):.5f}")
    return images, launches, march, parts, gate


def phase_volume_main(dev):
    """The volume path's main path for example 11's torus."""
    _, launches, march, parts, gate = volume_main(dev)
    print(f"phase 7 volume main path ({N_VOL_PIX}^2, a={VOL['a']}, incl "
          f"{math.degrees(VOL['incl']):.0f}, r_start {VOL['r_start']}, "
          f"{VOL['max_steps']} steps, f64 seed -> f32 kernel): "
          + " | ".join(parts) + f" | {gate}", flush=True)
    return launches


def volume_loop(dev, npix, cfg=VOL, source=None):
    """The kernel route against the f64 loop engine at npix^2 for `source`
    (the torus by default), and the loop engine's thick image against its
    thin one pixel by pixel, at the JAX package's gate for that engine
    (test_pallas_march.py): returns the text."""
    from sim5_tpu_torch.render import volume_image
    source = source or torus
    kw = volume_kw(cfg, npix)
    parts, loop = [], {}
    for alpha0 in ALPHA0:
        t0 = time.perf_counter()
        I_l = volume_image(cfg["a"], cfg["incl"], source(), engine="loop",
                           absorption_fn=source(alpha0), **kw).double()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        I_k = volume_image(cfg["a"], cfg["incl"], source(), engine="kernel",
                           absorption_fn=source(alpha0), **kw).double()
        peak = float(I_l.max())
        err = float((I_k - I_l).abs().max())
        check(peak > 0.0, f"alpha0={alpha0}: loop peak I {peak}")
        check(err <= 2e-2 * peak, f"alpha0={alpha0}: kernel vs f64 loop "
              f"{err / peak:.3e} of peak > 2e-2")
        loop[alpha0] = I_l
        parts.append(f"alpha0={alpha0}: max |dI| {err:.3e} = "
                     f"{err / peak:.3e} of peak {peak:.4e} (f64 loop "
                     f"{secs:.2f} s)")
    peak = float(loop[0.0].max())
    excess = float((loop[1.0] - loop[0.0]).max())
    check(excess <= 1e-6 * peak, f"f64 loop: thick exceeds thin by "
          f"{excess:.3e} > 1e-6 of peak {peak:.4e}")
    return " | ".join(parts) + (f" | f64 loop thick - thin <= {excess:.3e} "
                                f"(gate 1e-6 of peak)")


def phase_volume_loop(dev):
    print(f"phase 8 kernel route vs f64 loop engine ({N_VOL_LOOP_TORUS}^2; "
          f"gate 2e-2 of peak): " + volume_loop(dev, N_VOL_LOOP_TORUS),
          flush=True)


def phase_volume_timing(dev, name):
    """Phase 5's timing for the transfer variants at 512^2, on the packed
    inputs of the volume main path, and their plain version once."""
    from sim5_tpu_torch.march import kernel_march
    st0, ok = volume_seed_f32(N_VOL_PIX, dev)
    tensors, scalars = kernel_march._pack(
        st0, 1.2 * VOL["r_start"], VOL["max_steps"], 1e-2, ok)
    n = N_VOL_PIX * N_VOL_PIX
    out, parts = {}, []
    for alpha0 in ALPHA0:
        rt = 1 if alpha0 == 0.0 else 2
        tag = f"512^2 alpha0={alpha0}"
        kw = dict(scalars, emissivity=torus(), absorption=torus(alpha0))
        timing, same = march_timing(tensors, kw)
        ms_p, out_p = timed(kernel_march.march_reference, tensors, kw)
        eq, rel, dI, peak = compare_transfer(timing[1], out_p, st0)
        check(eq > 0.9, f"{tag}: equal steps {eq:.4f}")
        check(dI <= 1e-3 * peak, f"{tag}: |dI| {dI:.3e} > 1e-3 of peak "
              f"{peak:.4e}")

        def max_dI(outs, plain):
            return compare_transfer(outs, plain, st0)[2]

        text, row = timing_report(tag, n, rt, timing, same, out_p, ms_p,
                                  max_dI)
        out[rt] = row
        steps = timing[1][5]
        parts.append(
            f"alpha0={alpha0}: {text} | ray-steps {int(steps.long().sum())} "
            f"(mean {float(steps.double().mean()):.1f}, max "
            f"{int(steps.max())}) | kernel vs plain: equal steps {eq:.4f} "
            f"|dI| {dI:.3e} | segments: "
            + segment_profile(tensors, kw, resident_lanes(rt)))
    print(f"phase 9 transfer timing ({N_VOL_PIX}^2 rays f32; {name}): "
          + " | ".join(parts), flush=True)
    return out


def nt_disk(dtype, dev, a=NT["a"]):
    """nt_setup of the headline frame's disk (spin `a`), in `dtype` on the
    card, from scalars filled on the device (no host copy)."""
    from sim5_tpu_torch.disk import nt_setup
    return nt_setup(*(torch.full((), v, dtype=dtype, device=dev)
                      for v in (NT["M"], a, NT["mdot"], NT["alpha"])))


def sweep_spins():
    """The spin sweep's spins, a = 0.998 - 2e-4 k, as Python floats."""
    return [NT["a"] - 2e-4 * k for k in range(N_SWEEP)]


def nt_disks(dtype, dev, spins):
    """nt_setup over a vector of spins: one disk of (n,) tensors, the
    headline frame's disk at each spin."""
    from sim5_tpu_torch.disk import nt_setup
    n = len(spins)
    return nt_setup(*(torch.full((n,), v, dtype=dtype, device=dev)
                      for v in (NT["M"],)),
                    torch.tensor(spins, dtype=torch.float64,
                                 device=dev).to(dtype),
                    *(torch.full((n,), v, dtype=dtype, device=dev)
                      for v in (NT["mdot"], NT["alpha"])))


def bits(t):
    return t.view(torch.int64 if t.dtype == torch.float64 else torch.int32)


def image_err(got, want):
    """(max |got - want| over the pixels both hit / peak of want, footprint
    mismatches, max |got - want| over those pixels) of two images."""
    got, want = got.double(), want.double()
    both = (got > 0) & (want > 0)
    diff = (got - want).abs()[both]
    d = float(diff.max()) if diff.numel() else 0.0
    return d / float(want.max()), int(((got > 0) != (want > 0)).sum()), d


def check_image(tag, imf, img, npix, batch=()):
    check(tuple(imf.shape) == tuple(batch) + (npix, npix) == tuple(img.shape),
          f"{tag}: image shape {tuple(imf.shape)}")
    check(bool(torch.isfinite(imf).all() and torch.isfinite(img).all()),
          f"{tag}: non-finite pixels")
    check(bool((imf >= 0).all() and (img >= 0).all()),
          f"{tag}: negative pixels")
    check(float(imf.max()) > 0.0, f"{tag}: dark image")


def phase_image_golden(dev):
    """The f64 kernel and the f64 plain version on the card against the C
    goldens at 128^2: 1e-6 of the peak with the golden's footprint."""
    from sim5_tpu_torch.render import kernel_image, render_disk_image
    from sim5_tpu_torch.render.image import render_disk_image_reference
    golden = pathlib.Path(__file__).resolve().parent / "tests" / "golden"
    kernel_image.LAUNCHES.update(dict.fromkeys(kernel_image.LAUNCHES, 0))
    errs, parts = {}, []
    for tag, fname, a, inc in (("a0", "image128_a0.txt", 0.0, 60.0),
                               ("a998", "image128_a998.txt", 0.998, 80.0)):
        d = np.loadtxt(golden / fname)
        ref = torch.as_tensor(d[:, 2].reshape(N_GOLDEN, N_GOLDEN))
        disk = nt_disk(torch.float64, dev, a=a)
        for route, fn in (("kernel", render_disk_image),
                          ("plain", render_disk_image_reference)):
            imf, img = fn(disk, math.radians(inc), N_GOLDEN, N_GOLDEN)
            check_image(f"{tag} {route}", imf, img, N_GOLDEN)
            imf = imf.cpu()
            err = float((imf - ref).abs().max() / ref.max())
            mismatch = int(((imf > 0) != (ref > 0)).sum())
            check(err <= 1e-6, f"golden {tag} {route}: {err:.3e} of peak > "
                  f"1e-6")
            check(mismatch == 0, f"golden {tag} {route}: footprint differs "
                  f"on {mismatch} pixels")
            if route == "kernel":
                errs[tag] = err
            parts.append(f"{tag} {route} {err:.3e}")
    counts = dict(kernel_image.LAUNCHES)
    want = {k: 2 if k in ("nt_frames<double>", "nt_image<double>") else 0
            for k in counts}
    check(counts == want, f"golden renders launched {counts}, not 2 f64 "
          f"kernel launches")
    print(f"phase 10 disk image vs C goldens ({N_GOLDEN}^2 f64 on the card; "
          f"gate 1e-6 of peak, identical footprint): "
          + " | ".join(parts) + f" | ondevice_f64_err_a0={errs['a0']:.3e} "
          f"ondevice_f64_err_a998={errs['a998']:.3e} | LAUNCHES={counts}",
          flush=True)
    return errs


def check_image_counters(tag, c, n, image_g):
    """The counters of one launch against its image: every pixel counted
    once by type, status and hit order, and the shaded pixels are those
    with g > 0."""
    lanes = {k: v[1] for k, v in c.items()}
    hits = int((image_g > 0).sum())
    check(lanes["pixels"] == n, f"{tag}: counted {lanes['pixels']} pixels, "
          f"not {n}")
    for group in ("type_", "status_"):
        total = sum(v for k, v in lanes.items() if k.startswith(group))
        check(total == n, f"{tag}: {group}* counters sum to {total}, not {n}")
    check(lanes["hit0"] + lanes["hit1"] + lanes["dark"] == n,
          f"{tag}: hit0 + hit1 + dark != {n}")
    check(lanes["shade"] == lanes["hit0"] + lanes["hit1"] == hits,
          f"{tag}: shaded {lanes['shade']}, hits {lanes['hit0']} + "
          f"{lanes['hit1']}, pixels with g > 0 {hits}")
    for stage, parts in (("rad0", ("rad0_RR", "rad0_RC", "rad0_CC")),
                         ("order1", ("rad1_RR", "rad1_RC", "rad1_CC"))):
        check(lanes[stage] == sum(lanes[p] for p in parts),
              f"{tag}: {stage} != the sum of {parts}")


def counters_text(c):
    """The stages' warps, lanes and lane use, and the nonzero classes."""
    stages = ("pixels", "rf_R", "K_R", "rad0", "order1", "shade")
    out = [f"{k} {c[k][0]} warps {c[k][1]} lanes (use "
           f"{c[k][1] / (32 * c[k][0]) if c[k][0] else float('nan'):.4f})"
           for k in stages]
    out += [f"{k} {v[1]}" for k, v in c.items()
            if k not in stages and v[1]]
    return ", ".join(out)


def phase_image_main(dev):
    """The disk image's main path: the headline frame through nt_setup ->
    render_disk_image in f64 and f32, held against the plain version; then
    the same frames through the counted instance (count_disk_image), whose
    images must be bitwise the main path's, for the kernel's counters."""
    from sim5_tpu_torch.render import kernel_image, render_disk_image
    from sim5_tpu_torch.render.image import render_disk_image_reference
    npix, n = N_IMAGE, N_IMAGE * N_IMAGE
    kernel_image.LAUNCHES.update(dict.fromkeys(kernel_image.LAUNCHES, 0))
    t0 = time.perf_counter()
    kern, counters = {}, {}
    for dt in (torch.float64, torch.float32):
        kern[dt] = render_disk_image(nt_disk(dt, dev), NT["incl"], npix, npix)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(kernel_image.LAUNCHES)
    want = {k: 0 if k in kernel_image.COUNTED.values() else 1 for k in counts}
    check(counts == want, f"the main path launched {counts}, not each "
          f"instance and its prologue once")
    for dt in (torch.float64, torch.float32):
        cf, cg = kernel_image.count_disk_image(nt_disk(dt, dev), NT["incl"],
                                               npix, npix)
        counters[dt] = kernel_image.image_counters()
        check(torch.equal(bits(cf), bits(kern[dt][0]))
              and torch.equal(bits(cg), bits(kern[dt][1])),
              f"{kernel_image.COUNTED[dt]}: the images are not bitwise the "
              f"main path's")
    plain = {dt: render_disk_image_reference(nt_disk(dt, dev), NT["incl"],
                                             npix, npix)
             for dt in (torch.float64, torch.float32)}
    torch.cuda.synchronize()
    for dt in kern:
        check_image(f"kernel {dt}", *kern[dt], npix)
        check_image(f"plain {dt}", *plain[dt], npix)
        check(kern[dt][0].dtype == dt, f"kernel image is {kern[dt][0].dtype}")
        check_image_counters(kernel_image.COUNTED[dt], counters[dt], n,
                             kern[dt][1])
    f64p, g64p = plain[torch.float64]
    err_f, mis_f, _ = image_err(kern[torch.float64][0], f64p)
    err_g, mis_g, _ = image_err(kern[torch.float64][1], g64p)
    check(err_f <= 1e-9 and err_g <= 1e-9, f"f64 kernel vs plain: image_f "
          f"{err_f:.3e}, image_g {err_g:.3e} of peak > 1e-9")
    check(mis_f <= 1e-5 * n, f"f64 kernel vs plain: footprint differs on "
          f"{mis_f} pixels")
    fast_k, mis_k, _ = image_err(kern[torch.float32][0], f64p)
    fast_p, mis_p, _ = image_err(plain[torch.float32][0], f64p)
    for tag, err, mis in (("f32 kernel", fast_k, mis_k),
                          ("f32 plain", fast_p, mis_p)):
        check(err <= 4e-6, f"{tag} vs f64 plain: {err:.3e} of peak > 4e-6")
        check(mis <= 1e-5 * n, f"{tag} vs f64 plain: footprint differs on "
              f"{mis} pixels > 1e-5 of {n}")
    # each kernel against its own plain version (the kernels line)
    errs = {dt: image_err(kern[dt][0], plain[dt][0])
            for dt in (torch.float64, torch.float32)}
    hit = float((f64p > 0).double().mean())
    print(f"phase 11 disk image main path ({npix}^2, a={NT['a']}, incl 80, "
          f"M={NT['M']}, mdot={NT['mdot']}, alpha={NT['alpha']}; "
          f"LAUNCHES={counts}, both frames {wall:.3f} s host clock incl. "
          f"nt_setup): f64 kernel vs f64 plain image_f {err_f:.3e} image_g "
          f"{err_g:.3e} of peak, footprint mismatch {mis_f} (gates 1e-9, "
          f"{1e-5 * n:.2f}) | fast_path_err_vs_f64={fast_k:.3e} (f32 kernel, "
          f"footprint mismatch {mis_k}) | f32 plain vs f64 plain {fast_p:.3e} "
          f"(mismatch {mis_p}) (gates 4e-6, {1e-5 * n:.2f}) | f32 kernel vs "
          f"f32 plain {errs[torch.float32][0]:.3e} of peak (mismatch "
          f"{errs[torch.float32][1]}) | hit share {hit:.4f} peak "
          f"{float(f64p.max()):.6e} flux {float(f64p.sum()):.6e} | counted "
          f"instances bitwise the main path's images | counters "
          + " | ".join(f"{kernel_image.COUNTED[dt]}: {counters_text(c)}"
                       for dt, c in counters.items()), flush=True)
    return counts, {dt: e[2] for dt, e in errs.items()}, fast_k, counters


def image_bound(dtype, counters, lengths, npix):
    """(bound_ms, bound_by) of one npix^2 frame whose counters are
    `counters`: the operations of its pixel classes (image_ops) over the
    peak rate of the type, or the bytes (two images written, six scalars
    read) over the memory rate."""
    item = torch.tensor([], dtype=dtype).element_size()
    t_ops = image_ops(dtype, counters, lengths) / PEAK[dtype]
    t_bytes = (2 * npix * npix + 6) * item / H100_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def event_runs(fn, reps):
    """ms a call of fn(), sorted, over IMAGE_RUNS CUDA-event pairs around
    `reps` calls each, after a warm-up call."""
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(IMAGE_RUNS):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(reps):
            fn()
        e1.record()
        torch.cuda.synchronize()
        out.append(e0.elapsed_time(e1) / reps)
    return sorted(out)


def spread(ms, scale=1.0):
    return (f"{ms[0] * scale:.4f} / {ms[len(ms) // 2] * scale:.4f} / "
            f"{ms[-1] * scale:.4f}")


def host_runs(fn):
    """Seconds a call of fn() takes on the host clock, synchronised,
    sorted over SWEEP_RUNS calls after a warm-up call."""
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(SWEEP_RUNS):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append(time.perf_counter() - t0)
    return sorted(out)


def phase_image_timing(dev, name, errs, counters, lengths):
    """Each instance timed by CUDA events around runs of IMAGE_REPS
    launches: one headline frame a launch, and N_SWEEP frames of the spin
    sweep in one launch; the entry point's time a frame; the plain version
    once; the bound from the main path's counters.  Gates: every frame of
    an N_SWEEP-frame launch is bitwise the single-frame launch of its spin,
    in both instances; the f64 kernel on a batch of three spins at 128^2
    is within 1e-9 of the plain version's peak.  Then the f32 spin sweep
    through nt_setup(spins) -> render_disk_image in one launch, and the
    loop of one call a frame, on the host clock."""
    from sim5_tpu_torch import _build
    from sim5_tpu_torch.render import kernel_image, render_disk_image
    from sim5_tpu_torch.render.image import render_disk_image_reference
    npix, rows, parts = N_IMAGE, {}, []
    spins = sweep_spins()
    for dt in (torch.float64, torch.float32):
        name_k = kernel_image.VARIANTS[dt]
        disk = nt_disk(dt, dev)
        frames = kernel_image.frame_scalars(disk, NT["incl"]).reshape(1, 6)
        f = torch.empty((1, npix, npix), dtype=dt, device=dev)
        g = torch.empty_like(f)
        work = torch.empty((1, kernel_image.FRAME_WORDS), dtype=dt,
                           device=dev)
        cnt = kernel_image.new_counters(dev)
        one = event_runs(lambda: kernel_image._launch(frames, f, g, None,
                                                      work), IMAGE_REPS)
        counted = event_runs(lambda: kernel_image._launch(frames, f, g, cnt,
                                                          work), IMAGE_REPS)
        entry = event_runs(lambda: render_disk_image(disk, NT["incl"], npix,
                                                     npix), IMAGE_REPS)
        # the sweep's frames in one launch, each against its single frame
        batch = nt_disks(dt, dev, spins)
        bf, bg = render_disk_image(batch, NT["incl"], npix, npix)
        check_image(f"{name_k} {N_SWEEP}-frame launch", bf, bg, npix,
                    (N_SWEEP,))
        for k, a in enumerate(spins):
            sf, sg = render_disk_image(nt_disk(dt, dev, a=a), NT["incl"],
                                       npix, npix)
            check(torch.equal(bits(bf[k]), bits(sf))
                  and torch.equal(bits(bg[k]), bits(sg)),
                  f"{name_k}: frame {k} (a = {a}) of the {N_SWEEP}-frame "
                  f"launch is not bitwise its single-frame launch")
        framesN = kernel_image.frame_scalars(batch, NT["incl"])
        workN = torch.empty((N_SWEEP, kernel_image.FRAME_WORDS), dtype=dt,
                            device=dev)
        many = event_runs(lambda: kernel_image._launch(framesN, bf, bg, None,
                                                       workN), 2)
        plain_ms, _ = timed(render_disk_image_reference, (disk, NT["incl"],
                                                          npix, npix), {})
        bound_ms, bound_by = image_bound(dt, counters[dt], lengths, npix)
        rows[name_k] = dict(ms=one[0], plain_ms=plain_ms, bound_ms=bound_ms,
                            bound_by=bound_by, max_abs_err=errs[dt],
                            ms_batch=many[0] / N_SWEEP)
        ops = image_ops(dt, counters[dt], lengths)
        # --fmad=false: each counted operation is one instruction, issued
        # at half the FLOP peak (which counts an FMA as two)
        issue_ms = 2 * ops / PEAK[dt] * 1e3
        parts.append(
            f"{name_k}: one frame a launch {spread(one)} ms (min / median / "
            f"max of {IMAGE_RUNS} runs of {IMAGE_REPS} launches; "
            f"{npix * npix / (one[0] * 1e-3):.4e} rays/s); {N_SWEEP} frames "
            f"a launch {spread(many, 1 / N_SWEEP)} ms a frame; "
            f"{kernel_image.COUNTED[dt]} one frame a launch {spread(counted)}"
            f" ms ({counted[0] / one[0] - 1:+.2%}); the entry point "
            f"render_disk_image, one frame a call, {spread(entry)} ms; "
            f"bound {bound_ms:.4f} ms ({bound_by}, "
            f"{ops / (npix * npix):.1f} operations a pixel over the frame's "
            f"classes; {bound_ms / one[0]:.3f} of the one-frame launch, "
            f"{bound_ms / rows[name_k]['ms_batch']:.3f} of a frame in the "
            f"{N_SWEEP}-frame launch); at the instruction issue rate "
            f"{issue_ms:.4f} ms ({issue_ms / one[0]:.3f}, "
            f"{issue_ms / rows[name_k]['ms_batch']:.3f}); plain "
            f"{plain_ms:.3f} ms; every frame of the {N_SWEEP}-frame launch "
            f"bitwise its single-frame launch")
    # the f64 kernel on a batch of spins against the plain version's batch
    small = nt_disks(torch.float64, dev, list(BATCH_SPINS))
    kf, _ = render_disk_image(small, NT["incl"], N_BATCH, N_BATCH)
    pf, _ = render_disk_image_reference(small, NT["incl"], N_BATCH, N_BATCH)
    batch_errs = [image_err(kf[k], pf[k]) for k in range(len(BATCH_SPINS))]
    for a, (err, mis, _) in zip(BATCH_SPINS, batch_errs):
        check(err <= 1e-9, f"f64 batch, a = {a}: kernel vs plain {err:.3e} "
              f"of the peak > 1e-9")
        check(mis <= 1e-5 * N_BATCH * N_BATCH, f"f64 batch, a = {a}: "
              f"footprint differs on {mis} pixels")
    # the f32 spin sweep through the entry points: one launch, and the loop
    # of one call a frame
    lib = kernel_image._lib()
    before = kernel_image.LAUNCHES["nt_image<float>"]

    def sweep_once():
        return render_disk_image(nt_disks(torch.float32, dev, spins),
                                 NT["incl"], npix, npix)

    def sweep_loop():
        for a in spins:
            out = render_disk_image(nt_disk(torch.float32, dev, a=a),
                                    NT["incl"], npix, npix)
        return out

    one_launch = host_runs(sweep_once)
    mid = kernel_image.LAUNCHES["nt_image<float>"]
    loop = host_runs(sweep_loop)
    launches_once = (mid - before) // (SWEEP_RUNS + 1)
    launches_loop = (kernel_image.LAUNCHES["nt_image<float>"] - mid) // (
        SWEEP_RUNS + 1)
    libs = sorted(_build.BUILD_DIR.glob("libdisk_image_*.so"))
    check(launches_once == 1 and launches_loop == N_SWEEP,
          f"the sweeps launched {launches_once} and {launches_loop} times")
    check(kernel_image._lib() is lib and len(libs) == 1,
          f"the sweep rebuilt the library: {libs}")
    check_image("sweep, one launch", *sweep_once(), npix, (N_SWEEP,))
    device_ms = rows["nt_image<float>"]["ms_batch"]
    print(f"phase 12 disk image timing ({npix}^2; {name}): "
          + " | ".join(parts) + f" | device_ms_per_frame={device_ms:.4f} "
          f"(f32, a frame of the {N_SWEEP}-frame launch) | f64 kernel vs "
          f"plain on a batch of spins {BATCH_SPINS} at {N_BATCH}^2: "
          + ", ".join(f"{e:.3e} (mismatch {m})" for e, m, _ in batch_errs)
          + f" of each frame's peak (gate 1e-9) | spin sweep of {N_SWEEP} "
          f"f32 frames (a = 0.998 - 2e-4 k), host clock, min / median / max "
          f"of {SWEEP_RUNS}: nt_setup(spins) -> render_disk_image in one "
          f"launch {spread(one_launch)} s, {N_SWEEP / one_launch[0]:.2f} "
          f"frames/s ({N_SWEEP * npix * npix / one_launch[0]:.4e} rays/s); "
          f"one call a frame {spread(loop)} s, {N_SWEEP / loop[0]:.2f} "
          f"frames/s; one library ({libs[0].name}) for every spin",
          flush=True)
    return rows


# --- phases 13-15: the analytic azimuth and travel time, the orbiting
# source through the volume path, and example 07's hot-spot light curve

EPS64 = float(np.finfo(np.float64).eps)


def phi_bound(g, phi):
    """The bound on phi between two evaluations of the same f64 algebra
    whose sin/cos round differently by an ulp (the card's and the CPU's):
    near a poloidal turning point x -> b = sqrt(m2p) the theta term's
    integrand goes as 1 / ((1 - b^2) sqrt(a^2 + b^2) sqrt(2b (b - x))),
    so an ulp of cn moves phi by about sqrt(eps) |l/a| / ((1 - m2p)
    sqrt(m2m + m2p)) (tests/test_torch_azimuth.py measures 1-2 x that
    between the JAX package's jitted and op-by-op programs)."""
    S = (g.l / g.a).abs() / ((1.0 - g.m2p).abs()
                              * (g.m2m + g.m2p).abs().sqrt())
    return 8.0 * math.sqrt(EPS64) * S + 1e-12 * (1.0 + phi.abs())


def time_bound(g, t, t_far=0.0):
    """The same for a travel time: its poloidal part a integral_T_m2 has
    the same turning point, sqrt(eps) a m2p / sqrt(m2m + m2p); its radial
    part from a far radius t_far in is a sum of Byrd & Friedman terms of
    size ~t_far that cancel down to the result, and loses up to 1.1e-11
    t_far (the jitted JAX program against the port from R_FAR = 1e4,
    tests/test_torch_slow_parity.py): 1e-10 t_far."""
    return (8.0 * math.sqrt(EPS64) * g.a * g.m2p
            / (g.m2m + g.m2p).abs().sqrt() + 1e-12 * (1.0 + t.abs())
            + 1e-10 * t_far)


def golden_rows(fname, tag):
    """The rows of one tag of a golden file in tests/golden."""
    path = pathlib.Path(__file__).resolve().parent / "tests" / "golden"
    return np.asarray([[float(v) for v in line.split()[1:]] for line in
                       (path / fname).read_text().splitlines()
                       if line.split()[:1] == [tag]])


def gpos_rows():
    """(a, incl, alpha, beta, P, phi) of geod.txt's position samples of the
    geodesics the reference initialized."""
    path = pathlib.Path(__file__).resolve().parent / "tests" / "golden"
    rows, cur = [], None
    for line in (path / "geod.txt").read_text().splitlines():
        parts = line.split()
        if not parts:
            continue
        vals = [float(v) for v in parts[1:]]
        if parts[0] == "ginit":
            cur = vals if vals[4] == 1 else None
        elif parts[0] == "gpos" and cur is not None:
            rows.append(cur[:4] + [vals[0], vals[3]])
    return np.asarray(rows)


def worst(err, bound, sel):
    """(max err / bound, max err, the bound there) over `sel`."""
    ratio = torch.where(sel, err / bound, 0.0)
    i = int(ratio.flatten().argmax())
    return (float(ratio.flatten()[i]), float(err[sel].max()),
            float(bound.flatten()[i]))


def analytic_f64(device):
    """The seed's azimuth (VOL_SPOT at N_ANALYTIC^2) and the crossing map
    (order 0, N_ANALYTIC^2) on `device`, and the image grid's geodesic."""
    from sim5_tpu_torch import geodesic as gd
    from sim5_tpu_torch.render import lightcurve, image_grid
    c = VOL_SPOT
    g, ok, P0s, r0, m0 = lightcurve._volume_seed_geom(
        c["a"], c["incl"], N_ANALYTIC, c["rmax"], c["r_start"],
        torch.float64, device)
    phi = lightcurve._volume_seed_azm(g, ok, P0s, r0, m0)
    m = lightcurve.equatorial_crossing_map(c["a"], c["incl"], N_ANALYTIC,
                                           2.5 * SPOT["r_spot"], 0,
                                           device=device)
    alpha, beta = image_grid(N_ANALYTIC, N_ANALYTIC, 2.5 * SPOT["r_spot"],
                             device=device)
    gm = gd.geodesic_init_inf(c["incl"], c["a"], alpha, beta)
    if device != "cpu":
        torch.cuda.synchronize()
    return g, ok, phi, m, gm


def phase_analytic(dev):
    """The analytic azimuth and travel time on the card: against the C
    goldens, and against the same torch code on the CPU in f64."""
    from sim5_tpu_torch import geodesic as gd
    from sim5_tpu_torch.render import lightcurve
    d = gpos_rows()
    t = [torch.tensor(d[:, i], device=dev) for i in range(6)]
    g = gd.geodesic_init_inf(t[1], t[0], t[2], t[3])
    r = gd.geodesic_position_rad(g, t[4])
    m = gd.geodesic_position_pol(g, t[4])
    phi = gd.geodesic_position_azm(g, r, m, t[4])
    ok = (torch.isfinite(t[5]) & torch.isfinite(phi) & torch.isfinite(r)
          & torch.isfinite(m))
    close = ((phi - t[5]).abs() <= 1e-6 + 1e-4 * t[5].abs())[ok]
    frac = float(close.double().mean())
    check(int(ok.sum()) > 100 and frac > 0.97,
          f"azimuth vs C golden: {frac:.4f} of {int(ok.sum())} within "
          f"rtol 1e-4 atol 1e-6 (gate > 0.97)")
    d = golden_rows("timedelay.txt", "td")
    t = [torch.tensor(d[:, i], device=dev) for i in range(10)]
    g = gd.geodesic_init_inf(t[1], t[0], t[2], t[3])
    dt = gd.geodesic_timedelay(g, t[4], t[5], t[6], t[7], t[8],
                               torch.zeros_like(t[8]))
    fin = torch.isfinite(dt) == torch.isfinite(t[9])
    both = torch.isfinite(dt) & torch.isfinite(t[9])
    td_ok = ((dt - t[9]).abs() <= 1e-7 + 1e-5 * t[9].abs())[both]
    td_frac = float(td_ok.double().mean())
    check(float(fin.double().mean()) > 0.95 and td_frac > 0.95,
          f"time delay vs C golden: finiteness agrees on "
          f"{float(fin.double().mean()):.4f}, {td_frac:.4f} within rtol "
          f"1e-5 atol 1e-7 (gates > 0.95)")
    # the card against the CPU, f64, the same torch code
    t0 = time.perf_counter()
    gk, okk, phik, mk, gmk = analytic_f64(dev)
    card_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    gc, okc, phic, mc, gmc = analytic_f64("cpu")
    cpu_s = time.perf_counter() - t0
    okc = okc & torch.isfinite(phic)
    check(torch.equal(okk.cpu() & torch.isfinite(phik.cpu()), okc),
          "seed: valid pixels differ between the card and the CPU")
    seed_w = worst((phik.cpu() - phic).abs(), phi_bound(gc, phic), okc)
    hit = mc["hit"]
    check(torch.equal(mk["hit"].cpu(), hit),
          "crossing map: hit pixels differ between the card and the CPU")
    rel = {k: float(((mk[k].cpu() - mc[k]).abs() / mc[k].abs())[hit].max())
           for k in ("r", "g")}
    map_phi = worst((mk["phi"].cpu() - mc["phi"]).abs(),
                    phi_bound(gmc, mc["phi"]), hit)
    tb = time_bound(gmc, mc["delay"], lightcurve.R_FAR)
    tb = tb + tb[hit][int(mc["delay"][hit].argmin())]   # the anchor pixel
    map_dt = worst((mk["delay"].cpu() - mc["delay"]).abs(), tb, hit)
    for k, v in rel.items():
        check(v <= 1e-12, f"crossing map {k}: card vs CPU {v:.3e} > 1e-12")
    for tag, w in (("seed phi", seed_w), ("map phi", map_phi),
                   ("map delay", map_dt)):
        check(w[0] <= 1.0, f"{tag}: card vs CPU {w[1]:.3e} exceeds its "
              f"bound ({w[0]:.3f} of it)")
    print(f"phase 13 analytic azimuth and delay: vs C goldens on the card: "
          f"phi {frac:.4f} of {int(ok.sum())} samples within rtol 1e-4 "
          f"atol 1e-6 (gate > 0.97), time delay {td_frac:.4f} within rtol "
          f"1e-5 atol 1e-7 (gate > 0.95) | card vs CPU, f64, "
          f"{N_ANALYTIC}^2 (card {card_s:.2f} s, CPU {cpu_s:.2f} s): "
          f"crossing map r {rel['r']:.3e}, g {rel['g']:.3e} relative (gate "
          f"1e-12); phi and delay against their per-pixel bounds "
          f"(8 sqrt(eps) times the turning-point factor; + 1e-10 R_FAR for "
          f"the delay's radial part): seed phi max "
          f"{seed_w[1]:.3e} rad ({seed_w[0]:.3f} of its bound, bound there "
          f"{seed_w[2]:.3e}), map phi max {map_phi[1]:.3e} rad "
          f"({map_phi[0]:.3f}, {map_phi[2]:.3e}), map delay max "
          f"{map_dt[1]:.3e} ({map_dt[0]:.3f}, {map_dt[2]:.3e})", flush=True)


def spot(alpha0=1.0):
    """Example 07's spot as a 3-D source orbiting at OmegaK(7, 0.5) (alpha0
    = 1), or its absorption alpha0 * j (None for alpha0 = 0)."""
    from sim5_tpu_torch.core import OmegaK
    from sim5_tpu_torch.march.emission import GaussianSource
    if alpha0 == 0.0:
        return None
    om = float(OmegaK(torch.tensor(SPOT["r_spot"], dtype=torch.float64),
                      SPOT["a"]))
    w = 1.0 / SPOT["size"]
    return GaussianSource(amp=alpha0, center=SPOT["r_spot"], inv_width=w,
                          inv_height=w, cylindrical=True, omega=om,
                          inv_arc=w)


def seed_stages(dev, cfg, npix):
    """Seconds of each stage of the f64 seed (geometry / azimuth /
    packing) at npix^2, warm, on the synchronised host clock."""
    from sim5_tpu_torch.render import lightcurve
    secs = []

    def lap(t0):
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        return time.perf_counter()

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    g, ok, P0s, r0, m0 = lightcurve._volume_seed_geom(
        cfg["a"], cfg["incl"], npix, cfg["rmax"], cfg["r_start"],
        torch.float64, dev)
    t0 = lap(t0)
    phi0 = lightcurve._volume_seed_azm(g, ok, P0s, r0, m0)
    t0 = lap(t0)
    lightcurve._volume_seed_pack(g, ok, P0s, r0, m0, phi0, cfg["a"], 0.0,
                                 cfg["r_start"], cfg["precision"])
    lap(t0)
    return secs


def phase_orbit_volume(dev, name):
    """The volume path with its default azimuth stage and an orbiting
    source, through the march kernel: the 512^2 main path thin and thick,
    the seed's stages, the kernel against the f64 loop engine (128^2),
    the light curve's periodicity, and the march timed on the 512^2 seed
    and held against its plain version there (phase 9's gates).  Returns
    the launches and the kernels line's row of each variant."""
    from sim5_tpu_torch.core import OmegaK
    from sim5_tpu_torch.march import kernel_march
    from sim5_tpu_torch.render import volume_lightcurve
    cfg = VOL_SPOT
    images, launches, march, parts, gate = volume_main(dev, cfg, spot)
    for v, n in launches.items():
        check(n >= 1, f"orbiting source: {v} launched {n} times")
    stages = seed_stages(dev, cfg, N_VOL_PIX)   # warm: the images ran it
    loop_text = volume_loop(dev, N_VOL_LOOP, cfg, spot)
    # the source is periodic in t and the spacetime stationary: one period
    # later the light curve repeats
    period = 2.0 * math.pi / float(OmegaK(torch.tensor(
        SPOT["r_spot"], dtype=torch.float64), SPOT["a"]))
    flux = volume_lightcurve(cfg["a"], cfg["incl"], spot(), [0.0, period],
                             engine="kernel", device=dev,
                             **volume_kw(cfg, N_VOL_PIX))
    lc_rel = abs(flux[1] - flux[0]) / abs(flux[0])
    check(flux[0] > 0.0 and lc_rel <= 1e-3, f"orbiting source: flux at t0 "
          f"= 0 and one period later differ by {lc_rel:.3e} > 1e-3")
    # the march timed on the 512^2 seed and held against its plain
    # version on the same inputs, as phase 9
    st0, ok = volume_seed_f32(N_VOL_PIX, dev, cfg)
    tensors, scalars = kernel_march._pack(
        st0, 1.2 * cfg["r_start"], cfg["max_steps"], 1e-2, ok)
    n = N_VOL_PIX * N_VOL_PIX
    rows, timed_parts = {}, []
    for alpha0 in ALPHA0:
        rt = 1 if alpha0 == 0.0 else 2
        tag = f"orbiting {N_VOL_PIX}^2 alpha0={alpha0}"
        kw = dict(scalars, emissivity=spot(), absorption=spot(alpha0))
        timing, same = march_timing(tensors, kw)
        ms_p, out_p = timed(kernel_march.march_reference, tensors, kw)
        eq, rel, dI, peak_p = compare_transfer(timing[1], out_p, st0)
        check(peak_p > 0.0, f"{tag}: plain peak I is {peak_p}")
        check(eq > 0.9, f"{tag}: equal steps {eq:.4f}")
        check(dI <= 1e-3 * peak_p, f"{tag}: |dI| {dI:.3e} > 1e-3 of peak "
              f"{peak_p:.4e}")

        def max_dI(outs, plain):
            return compare_transfer(outs, plain, st0)[2]

        text, rows[rt] = timing_report(tag, n, rt, timing, same, out_p,
                                       ms_p, max_dI)
        timed_parts.append(
            f"alpha0={alpha0}: {text} | kernel vs plain: equal steps "
            f"{eq:.4f} rel dr {rel:.3e} |dI| {dI:.3e} ({dI / peak_p:.3e} of "
            f"peak {peak_p:.4e})")
    # the azimuth's share of one image, from this phase's own stage and
    # march times
    image_s = sum(stages) + rows[1]["ms"] * 1e-3
    peak = float(images[0.0].max())
    print(f"phase 14 orbiting source through the volume path ({N_VOL_PIX}^2, "
          f"a={cfg['a']}, incl {math.degrees(cfg['incl']):.0f}, spot at r="
          f"{SPOT['r_spot']} of width, height and arc {SPOT['size']}, omega "
          f"{2 * math.pi / period:.6f}, r_start {cfg['r_start']}, "
          f"{cfg['max_steps']} steps, default axisymmetric=False; {name}): "
          + " | ".join(parts) + f" | {gate} | seed stages (f64, host clock, "
          f"warm): geometry {stages[0]:.3f} s, azimuth {stages[1]:.3f} s, "
          f"packing {stages[2]:.3f} s; the azimuth is {stages[1] / image_s:.4f}"
          f" of seed + thin march ({image_s:.3f} s) | vs f64 loop "
          f"({N_VOL_LOOP}^2; gate "
          f"2e-2 of peak): {loop_text} | light curve t0 = 0 / one period: "
          f"{flux[0]:.9e} / {flux[1]:.9e}, relative {lc_rel:.3e} (gate "
          f"1e-3) | march timed on the {N_VOL_PIX}^2 seed (gates: equal "
          f"steps > 0.9, "
          f"|dI| <= 1e-3 of peak): " + " | ".join(timed_parts)
          + f" | peak {peak:.4e}", flush=True)
    return launches, rows


def phase_hotspot(dev):
    """Example 07 at its full size: the crossing maps at 192^2 (orders 0
    and 1), the light curve over two orbital periods in 96 samples given
    the maps, the entry point, and the crossing map at 512^2."""
    from sim5_tpu_torch.core import OmegaK
    from sim5_tpu_torch.render import (equatorial_crossing_map,
                                       hotspot_lightcurve, lightcurve)
    a, incl, rs, size = (SPOT[k] for k in ("a", "incl", "r_spot", "size"))
    Om = OmegaK(torch.tensor(rs, dtype=torch.float64, device=dev), a)
    period = 2.0 * math.pi / float(Om)
    t_obs = np.arange(HOTSPOT_T) / HOTSPOT_T * 2 * period
    maps, map_s = [], []
    for order in (0, 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        maps.append(equatorial_crossing_map(a, incl, N_HOTSPOT, 2.5 * rs,
                                            order, device=dev))
        torch.cuda.synchronize()
        map_s.append(time.perf_counter() - t0)
    t = torch.as_tensor(t_obs, device=dev)
    t0 = time.perf_counter()
    lc = sum(lightcurve.spot_flux(m, Om, rs, size, t) for m in maps)
    torch.cuda.synchronize()
    lc_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    lc_entry = hotspot_lightcurve(a, incl, rs, size, t_obs, npix=N_HOTSPOT,
                                  n_orders=2, device=dev)
    torch.cuda.synchronize()
    entry_s = time.perf_counter() - t0
    check(torch.equal(lc, lc_entry), "the light curve composed from the "
          "maps is not bitwise the entry point's")
    check(bool(torch.isfinite(lc).all()) and bool((lc > 0).all()),
          "light curve not finite and positive")
    half = HOTSPOT_T // 2
    per_rel = float(((lc[half:] - lc[:half]).abs() / lc[:half]).max())
    check(per_rel <= 1e-9, f"light curve: sample k vs k + {half} (one "
          f"period) {per_rel:.3e} > 1e-9")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    big = equatorial_crossing_map(a, incl, N_MAP, 2.5 * rs, 0, device=dev)
    torch.cuda.synchronize()
    big_s = time.perf_counter() - t0
    hits = []
    for tag, m in ((f"{N_HOTSPOT}^2 order 0", maps[0]),
                   (f"{N_HOTSPOT}^2 order 1", maps[1]),
                   (f"{N_MAP}^2 order 0", big)):
        d = m["delay"][m["hit"]]
        check(d.numel() > 0 and float(d.min()) == 0.0 and bool(
            torch.isfinite(d).all()), f"{tag}: delays over hits not finite "
              f"with minimum exactly 0")
        hits.append(f"{tag} {float(m['hit'].double().mean()):.4f} (delays "
                    f"0 to {float(d.max()):.4f})")
    lcn = lc.cpu().numpy()
    print(f"phase 15 hot-spot light curve (example 07: a={a}, incl "
          f"{math.degrees(incl):.0f}, r_spot {rs}, size {size}, "
          f"{N_HOTSPOT}^2, orders 0 and 1, {HOTSPOT_T} samples over two "
          f"periods of {period:.4f}): crossing maps {map_s[0]:.3f} / "
          f"{map_s[1]:.3f} s, the light curve given the maps {lc_s * 1e3:.3f}"
          f" ms, the entry point {entry_s:.3f} s (host clock, synchronised) "
          f"| crossing map at {N_MAP}^2 {big_s:.3f} s | hit fractions: "
          + ", ".join(hits) + f" | flux min {lcn.min():.6e} max "
          f"{lcn.max():.6e} (modulation {lcn.max() / lcn.min():.3f}x), one "
          f"period apart within {per_rel:.3e} (gate 1e-9)", flush=True)
    return dict(map_s=map_s, lc_s=lc_s, entry_s=entry_s, big_s=big_s)


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "runs only on a CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    t_start = time.perf_counter()
    try:
        name, lengths = phase_device()
        torch.cuda.synchronize()
        phase_compare(dev)
        torch.cuda.synchronize()
        launches, _ = phase_main(dev)
        torch.cuda.synchronize()
        phase_f64(dev)
        torch.cuda.synchronize()
        t = phase_timing(dev, name)
        torch.cuda.synchronize()
        phase_transfer_compare(dev)
        torch.cuda.synchronize()
        vol_launches = phase_volume_main(dev)
        torch.cuda.synchronize()
        phase_volume_loop(dev)
        torch.cuda.synchronize()
        vol_t = phase_volume_timing(dev, name)
        torch.cuda.synchronize()
        phase_image_golden(dev)
        torch.cuda.synchronize()
        image_launches, image_errs, _, image_counts = phase_image_main(dev)
        torch.cuda.synchronize()
        image_t = phase_image_timing(dev, name, image_errs, image_counts,
                                     lengths)
        torch.cuda.synchronize()
        phase_analytic(dev)
        torch.cuda.synchronize()
        orbit_launches, orbit_rows = phase_orbit_volume(dev, name)
        torch.cuda.synchronize()
        phase_hotspot(dev)
        torch.cuda.synchronize()
    except PhaseFailed as e:
        print(f"FAILED: {e}", file=sys.stderr)
        return 1
    print(f"all phases passed in {time.perf_counter() - t_start:.1f} s",
          flush=True)
    from sim5_tpu_torch.march import kernel_march
    march_src = dict(route="cuda", source="sim5_tpu_torch/csrc/march.cu",
                     replaces="sim5_tpu/march/pallas_march.py:296")
    image_src = dict(route="cuda",
                     source="sim5_tpu_torch/csrc/disk_image.cu",
                     replaces="sim5_tpu/render/image.py:35 (XLA-fused jnp; "
                              "no Pallas kernel)")
    rows = []
    for rt, timing in {0: t, **vol_t}.items():
        v = kernel_march.VARIANTS[rt]
        extra = ({} if rt == 0 else {
            f"orbiting_{k}": orbit_rows[rt][k] for k in (
                "ms", "plain_ms", "max_abs_err", "bound_ms", "bound_by")})
        if rt:
            extra["orbiting_launches"] = orbit_launches[v]
        rows.append((v, dict(march_src, **extra),
                     (launches if rt == 0 else vol_launches)[v], timing))
    from sim5_tpu_torch.render import kernel_image
    for dt, v in kernel_image.VARIANTS.items():
        pro = kernel_image.PROLOGUES[dt]
        rows.append((f"{pro} + {v}", image_src,
                     image_launches[pro] + image_launches[v], image_t[v]))
    print(json.dumps({"kernels": [{
        "name": v, **src, "launches": n, "max_abs_err": r["max_abs_err"],
        "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
        "bound_by": r["bound_by"], "library_ms": None}
        for v, src, n, r in rows]}))
    print(card())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
