#!/usr/bin/env python3
"""Drive the PyTorch / CUDA port on one GPU: the stepwise Kerr ray march
and volume radiative transfer.

Run from the repository root on a machine with an NVIDIA H100:

    python3 chip_smoke.py

The march kernel (`sim5_tpu_torch/csrc/march.cu`, all its variants) is
built into `build/` on first use.  Phases, one line each:

1. device: the card's name and power limit, and the kernel build;
2. kernel vs its plain torch version on 4096 rays (GR, GR+POL, flat at
   a = 0.3 and 0.9);
3. the march's main path, 131072 rays at a = 0.9 to r = 500, through
   raytrace_prepare -> raytrace_kernel -> raytrace_error, with the
   reference's Carter-drift gates and the kernel's launch count;
4. the f64 torch engine on 16384 rays of the same workload, same gates;
5. ray-steps/s of the kernel and of its plain version at 131072 rays;
6. the transfer variants vs their plain version on the volume seed of
   64^2 pixels (example 11's torus, thin and thick);
7. the volume path's main path: volume_image(engine="kernel") at 512^2
   for alpha0 = 0 and 1, with the launch counts and the image gates;
8. the kernel route against the f64 loop engine at 128^2;
9. the transfer variants' time at 512^2, and their plain version's.

Then one JSON line on the kernels, the card's name and power limit, and
the result as the last line.  Any failed check exits non-zero.  The script
needs a CUDA device and imports nothing of JAX.
"""

import contextlib
import json
import math
import re
import subprocess
import sys
import time

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

# The least time of a march (bound_ms): FP32 operations per trial step,
# counted from csrc/march.cu for the GR, no-polarization instance, a
# multiply-add as two, each division, sqrtf, cosf and expf as one (so the
# bound is a lower one): 4 connection evaluations of 159 (each with one
# sqrtf and 7 divisions), 5 cosf, 4 contractions -Gamma k k of 52, the step
# size 26, the RK4 stage updates and combination 98, the error check 48,
# accept/reject and termination 14.
OPS_TRIAL = 4 * 159 + 5 + 4 * 52 + 26 + 98 + 48 + 14
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


def ptxas_summary(build_dir):
    """'GR=.. POL=.. RT=..: N regs, spills' per kernel instance, from the
    compiler's -Xptxas -v report kept beside the library."""
    log = build_dir / "march.log"
    if not log.exists():
        return "no report (library was cached)"
    out, kernel, spill = [], None, ""
    for ln in log.read_text().splitlines():
        # mangled march_f32<GR, POL, RT>
        entry = re.search(r"Compiling entry function.*march_f32ILb([01])"
                          r"ELb([01])ELi([0-9])E", ln)
        regs = re.search(r"Used (\d+) registers", ln)
        if entry:
            kernel = f"GR={entry[1]} POL={entry[2]} RT={entry[3]}"
        elif "spill" in ln and kernel:
            spill = ln.strip()
        elif regs and kernel:
            out.append(f"{kernel}: {regs[1]} regs, {spill}")
            kernel = None
    return "; ".join(out)


def march_bound(n, ray_steps, rt):
    """(bound_ms, bound_by) of a march of n rays that made `ray_steps`
    trial steps in all, with transfer variant `rt`: the larger of its
    operations over the FP32 peak and its bytes over the memory rate."""
    t_ops = ray_steps * (OPS_TRIAL + OPS_RT[rt]) / H100_FP32
    t_bytes = n * (BYTES_RAY + (4 if rt else 0)) / H100_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def warp_efficiency(steps):
    """Share of the lanes' trips that did work: sum of steps over the sum,
    over warps of 32 consecutive rays, of 32 x the warp's longest march."""
    s = steps.long().cpu().numpy()
    s = np.concatenate([s, np.zeros(-len(s) % 32, s.dtype)]).reshape(-1, 32)
    return float(s.sum() / (32 * s.max(1)).sum())


def phase_device():
    from sim5_tpu_torch._build import BUILDS, BUILD_DIR
    from sim5_tpu_torch.march import kernel_march
    name = card()
    kernel_march._lib()
    b = BUILDS["march"]
    print(f"phase 1 device: {name} | torch {torch.__version__} cuda "
          f"{torch.version.cuda} | march build {b['seconds']:.2f} s "
          f"cached={b['cached']} | ptxas: {ptxas_summary(BUILD_DIR)}",
          flush=True)
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
    launches = kernel_march.LAUNCHES["march_f32"]
    check(launches >= 1, "main path launched the march kernel 0 times")
    g = drift_gates("main path", st, act, MAIN["r_max"], raytrace_error)
    steps = int(st.steps.long().sum())
    print(f"phase 3 main path ({N_MAIN} rays f32, a=0.9, r_max 500, 4000 "
          f"steps): LAUNCHES={launches} nan_frac={g['nan_frac']} finished="
          f"{g['finished']:.5f} escaped={g['escaped']:.5f} drift median="
          f"{g['drift_median']:.3e} p99={g['drift_p99']:.3e} ray-steps="
          f"{steps} mean steps={steps / N_MAIN:.1f} max steps="
          f"{int(st.steps.max())} warp efficiency="
          f"{warp_efficiency(st.steps):.4f} wall={secs:.3f} s", flush=True)
    return launches, g


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


def phase_timing(dev, name):
    """ms per march and ray-steps/s of the kernel (min of 3 after one
    warm-up) and of its plain version (once: it is host-launch-bound and
    takes tens of seconds) on the main path's packed inputs, timed with
    CUDA events.  Also holds the two results against each other."""
    from sim5_tpu_torch.march import raytrace_prepare, kernel_march
    x, k, _ = zamo_rays(N_MAIN, MAIN["a"], SEED_MAIN, torch.float32, dev,
                        outward=1.0)
    st0 = raytrace_prepare(MAIN["a"], x, k, precision=MAIN["precision"])
    tensors, scalars = kernel_march._pack(st0, MAIN["r_max"],
                                          MAIN["max_steps"], 1e-2, None)
    ms_k, out_k = timed(kernel_march._march_cuda, tensors, scalars, 3)
    ms_p, out_p = timed(kernel_march.march_reference, tensors, scalars, 1)
    steps_k = int(out_k[5].long().sum())
    steps_p = int(out_p[5].long().sum())
    st_k, _ = kernel_march._unpack(st0, out_k)
    st_p, _ = kernel_march._unpack(st0, out_p)
    eq, rel, dth, _, dr = compare(st_k, st_p, False)
    check(eq > 0.9, f"main shape: equal steps on only {eq:.4f} of rays")
    check(rel < 1e-3, f"main shape: relative dr {rel:.3e} >= 1e-3")
    rate_k = steps_k / (ms_k * 1e-3)
    rate_p = steps_p / (ms_p * 1e-3)
    bound_ms, bound_by = march_bound(N_MAIN, steps_k, 0)
    print(f"phase 5 timing ({N_MAIN} rays f32, a=0.9, r_max 500; {name}): "
          f"kernel {ms_k:.3f} ms {rate_k:.4e} ray-steps/s | plain "
          f"{ms_p:.3f} ms {rate_p:.4e} ray-steps/s | speedup "
          f"{ms_p / ms_k:.2f}x | bound {bound_ms:.3f} ms ({bound_by}) | "
          f"kernel vs plain: equal steps {eq:.4f} rel dr {rel:.3e} max |dr| "
          f"{dr:.3e}", flush=True)
    return dict(ms=ms_k, plain_ms=ms_p, max_abs_err=dr, bound_ms=bound_ms,
                bound_by=bound_by)


def timed(fn, tensors, scalars, reps):
    """(ms, outputs) of fn(*tensors, **scalars) by CUDA events: the min of
    `reps` runs after one warm-up, or the one run when reps is 1."""
    if reps > 1:
        fn(*tensors, **scalars)                 # warm-up
    best = float("inf")
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        outs = fn(*tensors, **scalars)
        e1.record()
        torch.cuda.synchronize()
        best = min(best, e0.elapsed_time(e1))
    return best, outs


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
    """The transfer variants at 512^2: the kernel's min of 3 after a
    warm-up and its plain version once, both by CUDA events, on the packed
    inputs of the main path; warp efficiency from the step counts."""
    from sim5_tpu_torch.march import kernel_march
    st0, ok = volume_seed_f32(N_VOL_PIX, dev)
    tensors, scalars = kernel_march._pack(
        st0, 1.2 * VOL["r_start"], VOL["max_steps"], 1e-2, ok)
    n = N_VOL_PIX * N_VOL_PIX
    out, parts = {}, []
    for alpha0 in ALPHA0:
        rt = 1 if alpha0 == 0.0 else 2
        kw = dict(scalars, emissivity=torus(), absorption=torus(alpha0))
        ms_k, out_k = timed(kernel_march._march_cuda, tensors, kw, 3)
        ms_p, out_p = timed(kernel_march.march_reference, tensors, kw, 1)
        eq, rel, dI, peak = compare_transfer(out_k, out_p, st0)
        check(eq > 0.9, f"512^2 alpha0={alpha0}: equal steps {eq:.4f}")
        check(dI <= 1e-3 * peak, f"512^2 alpha0={alpha0}: |dI| {dI:.3e} > "
              f"1e-3 of peak {peak:.4e}")
        steps = out_k[5]
        ray_steps = int(steps.long().sum())
        bound_ms, bound_by = march_bound(n, ray_steps, rt)
        out[kernel_march.VARIANTS[rt]] = dict(
            ms=ms_k, plain_ms=ms_p, max_abs_err=dI, bound_ms=bound_ms,
            bound_by=bound_by)
        parts.append(
            f"alpha0={alpha0}: kernel {ms_k:.3f} ms, plain {ms_p:.3f} ms "
            f"({ms_p / ms_k:.1f}x), bound {bound_ms:.3f} ms ({bound_by}), "
            f"ray-steps {ray_steps} (mean {ray_steps / n:.1f}, max "
            f"{int(steps.max())}) {ray_steps / (ms_k * 1e-3):.4e} "
            f"ray-steps/s, warp efficiency {warp_efficiency(steps):.4f}, "
            f"kernel vs plain: equal steps {eq:.4f} |dI| {dI:.3e}")
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
    rows = [("march_f32", launches, t)] + [
        (v, vol_launches[v], vol_t[v]) for v in vol_t]
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
