#!/usr/bin/env python3
"""Drive the PyTorch / CUDA port on one GPU: the stepwise Kerr ray march
and volume radiative transfer.

Run from the repository root on a machine with an NVIDIA H100:

    python3 chip_smoke.py

The march kernel (`sim5_tpu_torch/csrc/march.cu`, all its variants) is
built into `build/` on first use.  Every main path runs it in segments,
with the live rays compacted between them; the one-launch schedule of the
first version (`kernel_march._march_cuda_one_launch`) runs only in the A/B
timings of phases 5 and 9.  Phases, one line each:

1. device: the card's name and power limit, the kernel build, its
   compile-time choices, registers, spills and resident blocks, and its
   SASS instruction counts where `cuobjdump` is there;
2. kernel vs its plain torch version on 4096 rays (GR, GR+POL, flat at
   a = 0.3 and 0.9);
3. the march's main path, 131072 rays at a = 0.9 to r = 500, through
   raytrace_prepare -> raytrace_kernel -> raytrace_error, with the
   reference's Carter-drift gates, the launch counts (the one-launch
   schedule's stay 0) and the lane counters (lane-trips == sum of steps);
4. the f64 torch engine on 16384 rays of the same workload, same gates;
5. the two schedules in turns at 131072 rays (one-launch, segmented,
   segmented, one-launch, ...; the minimum of each): ms, ray-steps/s, lane
   use and the bound, with every output bitwise equal between them and
   between two segmented runs; the time of each segment; the plain
   version once;
6. the transfer variants vs their plain version on the volume seed of
   64^2 pixels (example 11's torus, thin and thick);
7. the volume path's main path: volume_image(engine="kernel") at 512^2
   for alpha0 = 0 and 1, with the launch counts and the image gates;
8. the kernel route against the f64 loop engine at 128^2;
9. phase 5's A/B and gates for the transfer variants at 512^2, thin and
   thick, and their plain version once.

Then one JSON line on the kernels (both schedules), the card's name and
power limit, and the result as the last line.  Any failed check exits
non-zero.  The script needs a CUDA device and imports nothing of JAX.
"""

import contextlib
import json
import math
import os
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
AB_ROUNDS = 3            # rounds of one-launch, segmented, segmented, one-launch

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
H100_BYTES = 3.35e12     # HBM3 bytes/s


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


def ptxas_summary(log):
    """'GR=.. POL=.. RT=..: N regs, stack frame and spills' per kernel
    instance, from the compiler's -Xptxas -v report kept beside the
    library."""
    if not os.path.exists(log):
        return "no report (library was cached without its log)"
    out, kernel, spill = [], None, ""
    for ln in open(log).read().splitlines():
        entry = INSTANCE.search(ln) if "Compiling entry function" in ln else None
        regs = re.search(r"Used (\d+) registers", ln)
        if entry:
            kernel = f"GR={entry[1]} POL={entry[2]} RT={entry[3]}"
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


def ab_timing(tensors, kw):
    """The one-launch and segmented schedules on the same inputs, in turns
    on one card: one warm-up each, then AB_ROUNDS of one-launch, segmented,
    segmented, one-launch, each timed by CUDA events.  Returns {schedule:
    (min ms, outputs of its first timed run, lane counters)} and whether
    every run of both schedules gave bitwise the outputs of the first."""
    from sim5_tpu_torch.march import kernel_march
    fns = {"one-launch": kernel_march._march_cuda_one_launch,
           "segmented": kernel_march._march_cuda}
    for fn in fns.values():
        fn(*tensors, **kw)
    best, first, counters, same = {}, {}, {}, True
    for _ in range(AB_ROUNDS):
        for name in ("one-launch", "segmented", "segmented", "one-launch"):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            outs = fns[name](*tensors, **kw)
            e1.record()
            torch.cuda.synchronize()
            best[name] = min(best.get(name, float("inf")), e0.elapsed_time(e1))
            counters.setdefault(name, kernel_march.march_counters())
            if name not in first:
                first[name] = outs
            same = same and same_bits(outs, first["one-launch"])
    return ({k: (best[k], first[k], counters[k]) for k in fns}, same)


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


def phase_device():
    from sim5_tpu_torch._build import BUILDS
    from sim5_tpu_torch.march import kernel_march
    name = card()
    kernel_march._lib()
    b = BUILDS["march"]
    cfg = kernel_march.kernel_config()
    print(f"phase 1 device: {name} | torch {torch.__version__} cuda "
          f"{torch.version.cuda} | march build {b['seconds']:.2f} s "
          f"cached={b['cached']} | {cfg} | "
          + "; ".join(instance_text(rt) for rt in range(3))
          + f" | ptxas: {ptxas_summary(b['log'])} | SASS (static): "
          + "; ".join(sass_summary(sass_counts(b["path"]), (1, 0, rt))
                      for rt in range(3)), flush=True)
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
    check(not any(counts[v] for v in kernel_march.ONE_LAUNCH),
          f"main path launched the one-launch schedule: {counts}")
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


def ab_report(tag, n, rt, ab, same, plain_outs, plain_ms, compare_fn):
    """Gate and describe one A/B timing: returns (text, {schedule: row})."""
    check(same, f"{tag}: the segmented and one-launch schedules (or two "
          f"runs of one) are not bitwise equal")
    parts, rows = [], {}
    for sched, (ms, outs, counters) in ab.items():
        check_counters(f"{tag} {sched}", counters, outs[5])
        ray_steps = int(outs[5].long().sum())
        bound_ms, bound_by = march_bound(n, ray_steps, rt)
        err = compare_fn(outs, plain_outs)
        rows[sched] = dict(ms=ms, plain_ms=plain_ms, max_abs_err=err,
                           bound_ms=bound_ms, bound_by=bound_by)
        parts.append(f"{sched} {ms:.3f} ms {ray_steps / (ms * 1e-3):.4e} "
                     f"ray-steps/s lane use {lane_use(counters):.4f} "
                     f"({bound_ms / ms:.3f} of bound)")
    text = (" | ".join(parts) + f" | segmented/one-launch "
            f"{ab['segmented'][0] / ab['one-launch'][0]:.4f} | bound "
            f"{rows['segmented']['bound_ms']:.3f} ms "
            f"({rows['segmented']['bound_by']}) | all {4 * AB_ROUNDS} timed "
            f"runs bitwise equal, steps equal on every ray | plain "
            f"{plain_ms:.3f} ms")
    return text, rows


def phase_timing(dev, name):
    """The two schedules in turns (CUDA events, min of AB_ROUNDS x 2 each)
    and the plain version once (it is host-launch-bound and takes tens of
    seconds) on the main path's packed inputs.  Holds the schedules
    bitwise equal and the kernel against the plain version."""
    from sim5_tpu_torch.march import raytrace_prepare, kernel_march
    x, k, _ = zamo_rays(N_MAIN, MAIN["a"], SEED_MAIN, torch.float32, dev,
                        outward=1.0)
    st0 = raytrace_prepare(MAIN["a"], x, k, precision=MAIN["precision"])
    tensors, scalars = kernel_march._pack(st0, MAIN["r_max"],
                                          MAIN["max_steps"], 1e-2, None)
    ab, same = ab_timing(tensors, scalars)
    ms_p, out_p = timed(kernel_march.march_reference, tensors, scalars)
    st_p, _ = kernel_march._unpack(st0, out_p)
    st_k, _ = kernel_march._unpack(st0, ab["segmented"][1])
    eq, rel, _, _, _ = compare(st_k, st_p, False)
    check(eq > 0.9, f"main shape: equal steps on only {eq:.4f} of rays")
    check(rel < 1e-3, f"main shape: relative dr {rel:.3e} >= 1e-3")

    def max_dr(outs, plain):
        return compare(kernel_march._unpack(st0, outs)[0], st_p, False)[4]

    text, rows = ab_report("main shape", N_MAIN, 0, ab, same, out_p, ms_p,
                           max_dr)
    segs = segment_profile(tensors, scalars, resident_lanes(0))
    print(f"phase 5 timing ({N_MAIN} rays f32, a=0.9, r_max 500; {name}): "
          f"{text} | kernel vs plain: equal steps {eq:.4f} rel dr "
          f"{rel:.3e} | segments: {segs}", flush=True)
    return rows


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
        check(not any(counts[v] for v in kernel_march.ONE_LAUNCH),
              f"alpha0={alpha0}: the image launched the one-launch "
              f"schedule: {counts}")
        launches[variant] = counts[variant]
        for v in kernel_march.ONE_LAUNCH:
            launches[v] = launches.get(v, 0) + counts[v]
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
    """Phase 5's A/B for the transfer variants at 512^2, on the packed
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
        ab, same = ab_timing(tensors, kw)
        ms_p, out_p = timed(kernel_march.march_reference, tensors, kw)
        eq, rel, dI, peak = compare_transfer(ab["segmented"][1], out_p, st0)
        check(eq > 0.9, f"{tag}: equal steps {eq:.4f}")
        check(dI <= 1e-3 * peak, f"{tag}: |dI| {dI:.3e} > 1e-3 of peak "
              f"{peak:.4e}")

        def max_dI(outs, plain):
            return compare_transfer(outs, plain, st0)[2]

        text, rows = ab_report(tag, n, rt, ab, same, out_p, ms_p, max_dI)
        out[rt] = rows
        steps = ab["segmented"][1][5]
        parts.append(
            f"alpha0={alpha0}: {text} | ray-steps {int(steps.long().sum())} "
            f"(mean {float(steps.double().mean()):.1f}, max "
            f"{int(steps.max())}) | kernel vs plain: equal steps {eq:.4f} "
            f"|dI| {dI:.3e} | segments: "
            + segment_profile(tensors, kw, resident_lanes(rt)))
    print(f"phase 9 transfer timing ({N_VOL_PIX}^2 rays f32; {name}): "
          + " | ".join(parts), flush=True)
    return out


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
    except PhaseFailed as e:
        print(f"FAILED: {e}", file=sys.stderr)
        return 1
    print(f"all phases passed in {time.perf_counter() - t_start:.1f} s",
          flush=True)
    from sim5_tpu_torch.march import kernel_march
    rows = []
    for rt, timing in {0: t, **vol_t}.items():
        counts = launches if rt == 0 else vol_launches
        for sched, names in (("segmented", kernel_march.VARIANTS),
                             ("one-launch", kernel_march.ONE_LAUNCH)):
            rows.append((names[rt], counts[names[rt]], timing[sched]))
    print(json.dumps({"kernels": [{
        "name": v, "route": "cuda",
        "source": "sim5_tpu_torch/csrc/march.cu",
        "replaces": "sim5_tpu/march/pallas_march.py:296",
        "launches": n, "max_abs_err": r["max_abs_err"], "ms": r["ms"],
        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
        "bound_by": r["bound_by"], "library_ms": None}
        for v, n, r in rows]}))
    print(card())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
