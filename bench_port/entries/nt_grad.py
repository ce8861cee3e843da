"""The value and gradient of an NT image fit's loss over a spin sweep:
each call builds leaves a (the mix's `frames` spins a0 - spin_step k, a0
drawn a call), incl and mdot (one value a frame) that require grad, runs
`nt_setup` and `render_disk_image`, and back-propagates loss =
image_f.sum() * `scale` (the tangent kernel's backward).

The judge works each sampled frame's value (its image_f.sum() * scale)
and gradient in (a, incl, mdot) out again by autograd through the plain
reference in f64 and compares the values (`value_err`) and each column
of the gradient (`a_grad_err`, `incl_grad_err`, `mdot_grad_err`; the
backward's sums over the frame, through the tangent and reduction
kernels), each relative, frame by frame.  The control is that reference
in the configuration's `control_dtype`.
"""

import math
import sys

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
                M=full(cfg["M"]), alpha=full(cfg["alpha"]), full=full,
                mdot=float(cfg["mdot"]), npix=int(cfg["npix"]),
                incl=math.radians(cfg["incl_deg"]), scale=float(mix["scale"]),
                step=float(mix["spin_step"]) * torch.arange(
                    n, dtype=torch.float64, device=dev))


def call(state, p, span):
    a = (p["a0"] - state["step"]).to(state["dt"]).requires_grad_(True)
    incl = state["full"](state["incl"]).requires_grad_(True)
    mdot = state["full"](state["mdot"]).requires_grad_(True)
    with span("nt_setup"):
        disk = state["nt_setup"](state["M"], a, mdot, state["alpha"])
    with span("render_disk_image"):
        f, _ = state["render"](disk, incl, state["npix"], state["npix"])
    with span("backward"):
        loss = f.sum() * state["scale"]
        loss.backward()
    return dict(a=a.detach(), incl=incl.detach(), mdot=mdot.detach(),
                f=f.detach(), loss=loss.detach(),
                grads=(a.grad, incl.grad, mdot.grad))


def rays(cfg, mix):
    return int(mix["frames"]) * int(cfg["npix"]) ** 2


def pick(mix, rng):
    """The sampled frames of a call."""
    return sorted(int(i) for i in rng.choice(
        int(mix["frames"]), int(mix["sample"]["frames"]), replace=False))


def keep(state, p, out, rng):
    idx = pick(state["mix"], rng)
    values = out["f"][idx].sum((1, 2)) * state["scale"]
    return dict(a=out["a"][idx].double().cpu().tolist(),
                incl=out["incl"][idx].double().cpu().tolist(),
                mdot=out["mdot"][idx].double().cpu().tolist(),
                value=values.double().cpu().tolist(),
                grad=torch.stack([g[idx] for g in out["grads"]], 1)
                .double().cpu())


def inputs(cfg, mix, p, idx):
    """The leaves of frames `idx` as the call makes them, on the CPU."""
    dt = DTYPES[cfg["dtype"]]
    step = float(mix["spin_step"]) * torch.arange(int(mix["frames"]),
                                                  dtype=torch.float64)
    a = (p["a0"] - step[idx]).to(dt).double().tolist()

    def f(v):
        return [float(torch.tensor(float(v), dtype=dt))] * len(idx)

    return a, f(math.radians(cfg["incl_deg"])), f(cfg["mdot"])


def frame_grads(cfg, mix, a, incl, mdot, dtype, dev):
    """(values, (n, 3) gradients) of the frames by the plain reference."""
    rows = [nt_image.frame_grad(cfg["M"], a_, md, cfg["alpha"], inc,
                                int(cfg["npix"]), float(mix["scale"]),
                                dtype, dev)
            for a_, inc, md in zip(a, incl, mdot)]
    return ([r[0] for r in rows],
            torch.tensor([r[1:] for r in rows], dtype=torch.float64))


def control(cfg, mix, p, rng, dev):
    a, incl, mdot = inputs(cfg, mix, p, pick(mix, rng))
    values, grad = frame_grads(cfg, mix, a, incl, mdot,
                               DTYPES[cfg["control_dtype"]], dev)
    return dict(a=a, incl=incl, mdot=mdot, value=values, grad=grad)


def judge(cfg, mix, kept, dev):
    got_v, want_v, got_g, want_g = [], [], [], []
    for k in kept:
        values, grad = frame_grads(cfg, mix, k["a"], k["incl"], k["mdot"],
                                   torch.float64, dev)
        got_v += k["value"]
        want_v += values
        got_g.append(k["grad"])
        want_g.append(grad)
    got_g, want_g = torch.cat(got_g), torch.cat(want_g)
    out = dict(value_err=compare.rel_err(got_v, want_v))
    for j, col in enumerate(("a", "incl", "mdot")):
        out[f"{col}_grad_err"] = compare.rel_err(got_g[:, j], want_g[:, j])
    spins = [a for k in kept for a in k["a"]]
    print("frames (a, and each column's relative gap): " + "; ".join(
        f"{a:.9f} " + " ".join(f"{float(e):.3g}" for e in row)
        for a, row in zip(spins, ((got_g - want_g).abs() / want_g.abs())
                          .tolist())), file=sys.stderr)
    return out
