"""Spin sweeps of the Novikov-Thorne disk image: each call is `nt_setup`
over the mix's `frames` spins a0 - spin_step k (a0 drawn a call), then one
`render_disk_image` of all of them.

The judge renders the sampled frames again with the plain reference in
f64 (its own `nt_setup` from the same M, a, mdot, alpha and inclination)
and compares image_f (its largest distance over the peak on the pixels
both light, `image_err`; the share of pixels lit in one and dark in the
other, `footprint`) and image_g on the pixels both light (`g_err`).  The
control is that reference in the configuration's `control_dtype`.
"""

import math

import torch

from bench_port import compare
from bench_port.reference import nt_image

DTYPES = {"float64": torch.float64, "float32": torch.float32,
          "bfloat16": torch.bfloat16}


def setup(cfg, mix, dev):
    from sim5_tpu_torch.disk import nt_setup
    from sim5_tpu_torch.render import render_disk_image
    n, dt = int(mix["frames"]), DTYPES[cfg["dtype"]]

    def full(v):
        return torch.full((n,), float(v), dtype=dt, device=dev)

    return dict(nt_setup=nt_setup, render=render_disk_image, dt=dt, mix=mix,
                M=full(cfg["M"]), mdot=full(cfg["mdot"]),
                alpha=full(cfg["alpha"]), npix=int(cfg["npix"]),
                incl=math.radians(cfg["incl_deg"]),
                step=float(mix["spin_step"]) * torch.arange(
                    n, dtype=torch.float64, device=dev))


def call(state, p, span):
    a = (p["a0"] - state["step"]).to(state["dt"])
    with span("nt_setup"):
        disk = state["nt_setup"](state["M"], a, state["mdot"],
                                 state["alpha"])
    with span("render_disk_image"):
        f, g = state["render"](disk, state["incl"], state["npix"],
                               state["npix"])
    return dict(a=a, f=f, g=g)


def rays(cfg, mix):
    return int(mix["frames"]) * int(cfg["npix"]) ** 2


def pick(mix, rng):
    """The sampled frames of a call."""
    return sorted(int(i) for i in rng.choice(
        int(mix["frames"]), int(mix["sample"]["frames"]), replace=False))


def spins(cfg, mix, p, idx):
    """The spins of frames `idx` as the call makes them, on the CPU."""
    step = float(mix["spin_step"]) * torch.arange(int(mix["frames"]),
                                                  dtype=torch.float64)
    return (p["a0"] - step[idx]).to(DTYPES[cfg["dtype"]]).double().tolist()


def keep(state, p, out, rng):
    idx = pick(state["mix"], rng)
    return dict(a=out["a"][idx].double().cpu().tolist(),
                f=out["f"][idx].cpu(), g=out["g"][idx].cpu())


def frames(cfg, a, dtype, dev):
    return nt_image.frames_image(cfg["M"], a, cfg["mdot"], cfg["alpha"],
                                 math.radians(cfg["incl_deg"]),
                                 int(cfg["npix"]), dtype, dev)


def control(cfg, mix, p, rng, dev):
    a = spins(cfg, mix, p, pick(mix, rng))
    f, g = frames(cfg, a, DTYPES[cfg["control_dtype"]], dev)
    return dict(a=a, f=f.cpu(), g=g.cpu())


def judge(cfg, mix, kept, dev):
    out = dict(image_err=0.0, footprint=0.0, g_err=0.0)
    for k in kept:
        f, g = frames(cfg, k["a"], torch.float64, dev)
        f, g = f.cpu(), g.cpu()
        for name, v in (("image_err", compare.image_err(k["f"], f)),
                        ("footprint", compare.footprint(k["f"], f)),
                        ("g_err", compare.g_err(k["f"], k["g"], f, g))):
            out[name] = max(out[name], v) if math.isfinite(v) else v
    return out
