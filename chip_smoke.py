#!/usr/bin/env python3
"""Drive the PyTorch / CUDA port on one GPU: the stepwise Kerr ray march,
volume radiative transfer and the Novikov-Thorne disk image.

Run from the repository root on a machine with an NVIDIA H100:

    python3 chip_smoke.py

The march kernel (`sim5_tpu_torch/csrc/march.cu`, all its variants, run
in segments with the live rays compacted between them) and the disk image
kernel (`sim5_tpu_torch/csrc/disk_image.cu`, f64 and f32) are built into
`build/` on first use, both at once.  Phases, one line each:

1. device: the card's name and power limit, the two builds, the march
   kernel's compile-time choices, registers, spills and resident blocks of
   every main-path instance, and the march kernel's SASS instruction
   counts where `cuobjdump` is there;
2. kernel vs its plain torch version on 4096 rays (GR, GR+POL, flat at
   a = 0.3 and 0.9);
3. the march's main path, 131072 rays at a = 0.9 to r = 500, through
   raytrace_prepare -> raytrace_kernel -> raytrace_error, with the
   reference's Carter-drift gates, the launch counts and the lane
   counters (lane-trips == sum of steps);
4. the f64 torch engine on 16384 rays of the same workload, same gates;
5. the march timed at 131072 rays (CUDA events, the minimum of
   TIMED_RUNS): ms, ray-steps/s, lane use and the bound, every run bitwise
   equal to the first; the time of each segment; the plain version once;
6. the transfer variants vs their plain version on the volume seed of
   64^2 pixels (example 11's torus, thin and thick);
7. the volume path's main path: volume_image(engine="kernel") at 512^2
   for alpha0 = 0 and 1, with the launch counts and the image gates;
8. the kernel route against the f64 loop engine at 128^2;
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
    instance;
12. the disk image timed: one 512^2 frame of each instance (CUDA events,
    the minimum of IMAGE_RUNS; device_ms_per_frame is the f32 one), a
    64-frame f32 spin sweep through nt_setup -> render_disk_image on the
    host clock (frames/s, rays/s, one build for all spins), the plain
    versions once, and the bound.

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
N_F64 = 16384
MAIN = dict(a=0.9, precision=0.01, r_max=500.0, max_steps=4000)
# example 11's translucent torus (examples/11_thick_volume_transfer.py),
# axisymmetric seed, at bench.py's headline resolution
VOL = dict(a=0.9, incl=math.radians(70.0), rmax=16.0, r_start=40.0,
           max_steps=2000, precision=0.02, axisymmetric=True)
N_VOL_PIX = 512
N_VOL_CMP = 64
N_VOL_LOOP = 128
ALPHA0 = (0.0, 1.0)
TIMED_RUNS = 6           # timed runs of each march (the minimum is kept)
# bench.py's headline frame (bench.py:293-295) and its spin sweep
NT = dict(M=10.0, a=0.998, mdot=0.1, alpha=0.1, incl=math.radians(80.0))
N_IMAGE = 512
N_GOLDEN = 128
N_SWEEP = 64             # frames of the spin sweep, a = 0.998 - 2e-4 k
IMAGE_RUNS = 10          # timed frames of each image instance

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

# The least time of a disk image frame: operations per pixel counted from
# csrc/analytic.cuh on the cheapest pixel's path (a four-complex-root ray
# whose order-0 crossing does not exist), each +, -, *, / and each sqrt,
# sin, cos, acos, pow, frexp as one (comparisons, selects, abs and
# negation not counted): the grid 12, init_inf's own 29, T_roots 22, the
# quartic's coefficients 9, the quartic 117 (f32: + 14 for the rescale),
# the polish of four complex roots 4 x 78, the CC branch 41, two RF (231
# f64 with 16 duplications, 114 f32 with 7), two K AGMs (40 f64, 32 f32)
# and the crossing 5.
OPS_PIXEL_BASE = 12 + 29 + 22 + 9 + 117 + 4 * 78 + 41 + 5
OPS_PIXEL = {torch.float64: OPS_PIXEL_BASE + 2 * 231 + 2 * 40,
             torch.float32: OPS_PIXEL_BASE + 14 + 2 * 114 + 2 * 32}
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


def sass_counts(lib_path):
    """{(GR, POL, RT): Counter of SASS opcodes} of each kernel instance in
    the library (a static count: each instruction of the function once),
    or None without cuobjdump."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        return None
    text = subprocess.run([tool, "-sass", str(lib_path)], capture_output=True,
                          text=True, timeout=300, check=True).stdout
    counts, cur = {}, None
    for ln in text.splitlines():
        if "Function :" in ln:
            m = INSTANCE.search(ln)
            cur = counts.setdefault(tuple(int(g) for g in m.groups()),
                                    Counter()) if m else None
        elif cur is not None:
            op = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)",
                          ln)
            if op:
                cur[op[1].split(".")[0]] += 1
    return counts


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


# nt_image<T> in a mangled name (T = d for double, f for float)
IMAGE_INSTANCE = re.compile(r"nt_imageI([df])E")


def image_label(m):
    return "nt_image<" + ("double" if m[1] == "d" else "float") + ">"


def phase_device():
    from sim5_tpu_torch._build import BUILDS
    from sim5_tpu_torch.march import kernel_march
    from sim5_tpu_torch.render import kernel_image
    name = card()
    # one nvcc for each source, both started together
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        for fut in [pool.submit(kernel_march._lib),
                    pool.submit(kernel_image._lib)]:
            fut.result()
    build_s = time.perf_counter() - t0
    b, bi = BUILDS["march"], BUILDS["disk_image"]
    cfg = kernel_march.kernel_config()
    image_att = "; ".join(
        f"{kernel_image.VARIANTS[dt]}: {att['registers']} registers, "
        f"{att['local_bytes']} bytes local, {att['blocks_per_sm']} blocks an "
        f"SM" for dt, att in ((dt, kernel_image.kernel_attributes(dt))
                              for dt in kernel_image.VARIANTS))
    print(f"phase 1 device: {name} | torch {torch.__version__} cuda "
          f"{torch.version.cuda} | builds {build_s:.2f} s together: march "
          f"{b['seconds']:.2f} s cached={b['cached']}, disk_image "
          f"{bi['seconds']:.2f} s cached={bi['cached']} | {cfg} | "
          + "; ".join(instance_text(rt) for rt in range(3))
          + f" | ptxas: {ptxas_summary(b['log'])} | SASS (static): "
          + "; ".join(sass_summary(sass_counts(b["path"]), (1, 0, rt))
                      for rt in range(3))
          + f" | image: {image_att} | image ptxas: "
          + ptxas_summary(bi["log"], IMAGE_INSTANCE, image_label), flush=True)
    return name


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


def volume_seed_f32(npix, dev):
    """The f64 analytic seed of the volume configuration at npix^2, cast to
    f32 as the kernel route does, and the valid mask, as a flat batch of
    npix^2 rays."""
    from sim5_tpu_torch.render import lightcurve
    kw = {k: VOL[k] for k in ("rmax", "r_start", "precision",
                              "axisymmetric")}
    st, ok = lightcurve._volume_seed(VOL["a"], VOL["incl"], 0.0, npix=npix,
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


def phase_volume_main(dev):
    """The volume path's main path: volume_image(engine="kernel") at
    512^2, thin then thick, through the entry point a user calls."""
    from sim5_tpu_torch.march import kernel_march
    from sim5_tpu_torch.render import lightcurve, volume_image
    images, launches, parts = {}, {}, []
    for alpha0 in ALPHA0:
        kernel_march.LAUNCHES.update(dict.fromkeys(kernel_march.LAUNCHES, 0))
        t0 = time.perf_counter()
        with launch_events() as events:
            I = volume_image(VOL["a"], VOL["incl"], torus(), npix=N_VOL_PIX,
                             rmax=VOL["rmax"], r_start=VOL["r_start"],
                             max_steps=VOL["max_steps"],
                             precision=VOL["precision"], engine="kernel",
                             absorption_fn=torus(alpha0),
                             axisymmetric=VOL["axisymmetric"])
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = dict(kernel_march.LAUNCHES)
        march_ms = sum(e0.elapsed_time(e1) for e0, e1 in events)
        variant = kernel_march.VARIANTS[1 if alpha0 == 0.0 else 2]
        check(counts[variant] >= 1,
              f"alpha0={alpha0}: the image launched {variant} 0 times")
        launches[variant] = counts[variant]
        # the seed alone, warm, on the host clock
        t0 = time.perf_counter()
        lightcurve._volume_seed(
            VOL["a"], VOL["incl"], 0.0, npix=N_VOL_PIX, rmax=VOL["rmax"],
            r_start=VOL["r_start"], precision=VOL["precision"],
            axisymmetric=VOL["axisymmetric"], device=dev)
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
    # 1 / alpha0 for this torus), on at most max_steps steps.
    allow = 1e-6 * peak + VOL["max_steps"] * 2.0 ** -23 / ALPHA0[1]
    check(excess <= allow, f"thick exceeds thin by {excess:.3e} > "
          f"{allow:.3e} (1e-6 of peak {peak:.4e} + f32 rounding of s_eff)")
    check(float(thick.sum()) < float(thin.sum()),
          "thick total flux is not below thin")
    print(f"phase 7 volume main path ({N_VOL_PIX}^2, a={VOL['a']}, incl "
          f"{math.degrees(VOL['incl']):.0f}, r_start {VOL['r_start']}, "
          f"{VOL['max_steps']} steps, f64 seed -> f32 kernel): "
          + " | ".join(parts) + f" | thick - thin <= {excess:.3e} = "
          f"{excess / peak:.3e} of peak (gate {allow:.3e}: 1e-6 of peak + "
          f"max_steps 2^-23 / alpha0), flux ratio thick/thin "
          f"{float(thick.sum()) / float(thin.sum()):.5f}", flush=True)
    return launches


def phase_volume_loop(dev):
    """The kernel route against the f64 loop engine at 128^2, and the loop
    engine's thick image against its thin one pixel by pixel, at the JAX
    package's gate for that engine (test_pallas_march.py)."""
    from sim5_tpu_torch.render import volume_image
    kw = dict(npix=N_VOL_LOOP, rmax=VOL["rmax"], r_start=VOL["r_start"],
              max_steps=VOL["max_steps"], precision=VOL["precision"],
              axisymmetric=VOL["axisymmetric"])
    parts, loop = [], {}
    for alpha0 in ALPHA0:
        t0 = time.perf_counter()
        I_l = volume_image(VOL["a"], VOL["incl"], torus(), engine="loop",
                           absorption_fn=torus(alpha0), **kw).double()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        I_k = volume_image(VOL["a"], VOL["incl"], torus(), engine="kernel",
                           absorption_fn=torus(alpha0), **kw).double()
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
    print(f"phase 8 kernel route vs f64 loop engine ({N_VOL_LOOP}^2; gate "
          f"2e-2 of peak): " + " | ".join(parts) + f" | f64 loop thick - "
          f"thin <= {excess:.3e} (gate 1e-6 of peak)", flush=True)


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


def image_err(got, want):
    """(max |got - want| over the pixels both hit / peak of want, footprint
    mismatches, max |got - want| over those pixels) of two images."""
    got, want = got.double(), want.double()
    both = (got > 0) & (want > 0)
    diff = (got - want).abs()[both]
    d = float(diff.max()) if diff.numel() else 0.0
    return d / float(want.max()), int(((got > 0) != (want > 0)).sum()), d


def check_image(tag, imf, img, npix):
    check(tuple(imf.shape) == (npix, npix) == tuple(img.shape),
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
    check(counts == {"nt_image<double>": 2, "nt_image<float>": 0},
          f"golden renders launched {counts}, not 2 f64 kernel launches")
    print(f"phase 10 disk image vs C goldens ({N_GOLDEN}^2 f64 on the card; "
          f"gate 1e-6 of peak, identical footprint): "
          + " | ".join(parts) + f" | ondevice_f64_err_a0={errs['a0']:.3e} "
          f"ondevice_f64_err_a998={errs['a998']:.3e} | LAUNCHES={counts}",
          flush=True)
    return errs


def phase_image_main(dev):
    """The disk image's main path: the headline frame through nt_setup ->
    render_disk_image in f64 and f32, held against the plain version."""
    from sim5_tpu_torch.render import kernel_image, render_disk_image
    from sim5_tpu_torch.render.image import render_disk_image_reference
    npix, n = N_IMAGE, N_IMAGE * N_IMAGE
    kernel_image.LAUNCHES.update(dict.fromkeys(kernel_image.LAUNCHES, 0))
    t0 = time.perf_counter()
    kern = {dt: render_disk_image(nt_disk(dt, dev), NT["incl"], npix, npix)
            for dt in (torch.float64, torch.float32)}
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(kernel_image.LAUNCHES)
    check(counts == {"nt_image<double>": 1, "nt_image<float>": 1},
          f"the main path launched {counts}, not each instance once")
    plain = {dt: render_disk_image_reference(nt_disk(dt, dev), NT["incl"],
                                             npix, npix)
             for dt in (torch.float64, torch.float32)}
    torch.cuda.synchronize()
    for dt in kern:
        check_image(f"kernel {dt}", *kern[dt], npix)
        check_image(f"plain {dt}", *plain[dt], npix)
        check(kern[dt][0].dtype == dt, f"kernel image is {kern[dt][0].dtype}")
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
          f"{float(f64p.max()):.6e} flux {float(f64p.sum()):.6e}",
          flush=True)
    return counts, {dt: e[2] for dt, e in errs.items()}, fast_k


def image_bound(dtype, npix):
    """(bound_ms, bound_by) of one npix^2 frame: operations per pixel on
    the cheapest pixel's path over the peak rate of the type, or the bytes
    (two images written, six scalars read) over the memory rate."""
    item = torch.tensor([], dtype=dtype).element_size()
    t_ops = npix * npix * OPS_PIXEL[dtype] / PEAK[dtype]
    t_bytes = (2 * npix * npix + 6) * item / H100_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def phase_image_timing(dev, name, errs):
    """One frame of each instance (CUDA events, min of IMAGE_RUNS), the
    f32 spin sweep through the entry points on the host clock, the plain
    versions once, and the bound."""
    from sim5_tpu_torch import _build
    from sim5_tpu_torch.render import kernel_image, render_disk_image
    from sim5_tpu_torch.render.image import render_disk_image_reference
    npix, rows, parts = N_IMAGE, {}, []
    for dt in (torch.float64, torch.float32):
        disk = nt_disk(dt, dev)
        render_disk_image(disk, NT["incl"], npix, npix)   # warm-up
        best = float("inf")
        for _ in range(IMAGE_RUNS):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            render_disk_image(disk, NT["incl"], npix, npix)
            e1.record()
            torch.cuda.synchronize()
            best = min(best, e0.elapsed_time(e1))
        plain_ms, _ = timed(render_disk_image_reference, (disk, NT["incl"],
                                                          npix, npix), {})
        bound_ms, bound_by = image_bound(dt, npix)
        name_k = kernel_image.VARIANTS[dt]
        rows[name_k] = dict(ms=best, plain_ms=plain_ms, bound_ms=bound_ms,
                            bound_by=bound_by, max_abs_err=errs[dt])
        parts.append(f"{name_k} {best:.3f} ms a frame (min of {IMAGE_RUNS}; "
                     f"{npix * npix / (best * 1e-3):.4e} rays/s), bound "
                     f"{bound_ms:.4f} ms ({bound_by}, {OPS_PIXEL[dt]} "
                     f"operations a pixel; {bound_ms / best:.4f} of bound), "
                     f"plain {plain_ms:.3f} ms")
    # the f32 spin sweep, every frame through nt_setup -> render_disk_image
    lib = kernel_image._lib()
    before = kernel_image.LAUNCHES["nt_image<float>"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for k in range(N_SWEEP):
        out = render_disk_image(nt_disk(torch.float32, dev,
                                        a=NT["a"] - 2e-4 * k),
                                NT["incl"], npix, npix)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    frames = kernel_image.LAUNCHES["nt_image<float>"] - before
    libs = sorted(_build.BUILD_DIR.glob("libdisk_image_*.so"))
    check(frames == N_SWEEP, f"the sweep launched {frames} frames")
    check(kernel_image._lib() is lib and len(libs) == 1,
          f"the sweep rebuilt the library: {libs}")
    check_image("sweep last frame", *out, npix)
    device_ms = rows["nt_image<float>"]["ms"]
    print(f"phase 12 disk image timing ({npix}^2; {name}): "
          + " | ".join(parts) + f" | device_ms_per_frame={device_ms:.4f} "
          f"(f32) | spin sweep of {N_SWEEP} f32 frames (a = 0.998 - 2e-4 k) "
          f"through nt_setup -> render_disk_image: {secs:.3f} s host clock, "
          f"{N_SWEEP / secs:.2f} frames/s, {N_SWEEP * npix * npix / secs:.4e} "
          f"rays/s, {frames} launches, one library ({libs[0].name}) built "
          f"once for every spin", flush=True)
    return rows


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "runs only on a CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    t_start = time.perf_counter()
    try:
        name = phase_device()
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
        image_launches, image_errs, _ = phase_image_main(dev)
        torch.cuda.synchronize()
        image_t = phase_image_timing(dev, name, image_errs)
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
        rows.append((v, march_src, (launches if rt == 0 else vol_launches)[v],
                     timing))
    rows += [(v, image_src, image_launches[v], image_t[v])
             for v in image_t]
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
