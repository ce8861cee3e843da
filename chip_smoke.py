#!/usr/bin/env python3
"""Drive the PyTorch / CUDA port's stepwise Kerr ray march on one GPU.

Run from the repository root on a machine with an NVIDIA H100:

    python3 chip_smoke.py

The march kernel (`sim5_tpu_torch/csrc/march.cu`) is built into `build/` on
first use.  Phases, one line each:

1. device: the card's name and power limit, and the kernel build;
2. kernel vs its plain torch version on 4096 rays (GR, GR+POL, flat at
   a = 0.3 and 0.9);
3. the main path, 131072 rays at a = 0.9 to r = 500, through
   raytrace_prepare -> raytrace_kernel -> raytrace_error, with the
   reference's Carter-drift gates and the kernel's launch count;
4. the f64 torch engine on 16384 rays of the same workload, same gates;
5. ray-steps/s of the kernel and of its plain version at 131072 rays.

Then one JSON line on the kernels, the card's name and power limit, and
the result as the last line.  Any failed check exits non-zero.  The script
needs a CUDA device and imports nothing of JAX.
"""

import json
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
    """'GR=.. POL=..: N regs, spills' per kernel instance, from the
    compiler's -Xptxas -v report kept beside the library."""
    log = build_dir / "march.log"
    if not log.exists():
        return "no report (library was cached)"
    out, kernel, spill = [], None, ""
    for ln in log.read_text().splitlines():
        entry = re.search(r"Compiling entry function.*march_f32ILb([01])"
                          r"ELb([01])E", ln)    # mangled march_f32<GR, POL>
        regs = re.search(r"Used (\d+) registers", ln)
        if entry:
            kernel = f"GR={entry[1]} POL={entry[2]}"
        elif "spill" in ln and kernel:
            spill = ln.strip()
        elif regs and kernel:
            out.append(f"{kernel}: {regs[1]} regs, {spill}")
            kernel = None
    return "; ".join(out)


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
    kernel_march.LAUNCHES = 0
    t0 = time.perf_counter()
    st, act = main_path(N_MAIN, torch.float32, dev, raytrace_kernel)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = kernel_march.LAUNCHES
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
    """ms per march and ray-steps/s of the kernel and its plain version
    on the main path's packed inputs: min of 3 after one warm-up, timed
    with CUDA events.  Also holds the two results against each other."""
    from sim5_tpu_torch.march import raytrace_prepare, kernel_march
    x, k, _ = zamo_rays(N_MAIN, MAIN["a"], SEED_MAIN, torch.float32, dev,
                        outward=1.0)
    st0 = raytrace_prepare(MAIN["a"], x, k, precision=MAIN["precision"])
    tensors, scalars = kernel_march._pack(st0, MAIN["r_max"],
                                          MAIN["max_steps"], 1e-2, None)

    def timed(fn):
        outs = fn(*tensors, **scalars)          # warm-up
        best = float("inf")
        for _ in range(3):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            outs = fn(*tensors, **scalars)
            e1.record()
            torch.cuda.synchronize()
            best = min(best, e0.elapsed_time(e1))
        return best, outs

    ms_k, out_k = timed(kernel_march._march_cuda)
    ms_p, out_p = timed(kernel_march.march_reference)
    steps_k = int(out_k[5].long().sum())
    steps_p = int(out_p[5].long().sum())
    st_k, _ = kernel_march._unpack(st0, out_k)
    st_p, _ = kernel_march._unpack(st0, out_p)
    eq, rel, dth, _, dr = compare(st_k, st_p, False)
    check(eq > 0.9, f"main shape: equal steps on only {eq:.4f} of rays")
    check(rel < 1e-3, f"main shape: relative dr {rel:.3e} >= 1e-3")
    rate_k = steps_k / (ms_k * 1e-3)
    rate_p = steps_p / (ms_p * 1e-3)
    print(f"phase 5 timing ({N_MAIN} rays f32, a=0.9, r_max 500; {name}): "
          f"kernel {ms_k:.3f} ms {rate_k:.4e} ray-steps/s | plain "
          f"{ms_p:.3f} ms {rate_p:.4e} ray-steps/s | speedup "
          f"{ms_p / ms_k:.2f}x | kernel vs plain: equal steps {eq:.4f} "
          f"rel dr {rel:.3e} max |dr| {dr:.3e}", flush=True)
    return dict(ms=ms_k, plain_ms=ms_p, max_abs_err=dr)


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "runs only on a CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
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
    except PhaseFailed as e:
        print(f"FAILED: {e}", file=sys.stderr)
        return 1
    print(json.dumps({"kernels": [{
        "name": "march_f32", "route": "cuda",
        "source": "sim5_tpu_torch/csrc/march.cu",
        "replaces": "sim5_tpu/march/pallas_march.py:296",
        "launches": launches, "max_abs_err": t["max_abs_err"],
        "ms": t["ms"], "plain_ms": t["plain_ms"]}]}))
    print(card())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
