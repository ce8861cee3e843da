"""Volume images of an orbiting hot spot through the march kernel: each
call is one `volume_image(engine="kernel")` of the configuration's spot
(a `GaussianSource` orbiting at the Keplerian rate of its radius, thin)
at t0 = phase x one orbital period, the phase drawn a call, with the
f64 seed and its azimuth stage (`volume_lightcurve`'s loop body).

The judge seeds and marches the sampled pixels' rays again with the plain
reference (the seed's chain, the torch-loop RK4 march with the transfer
step, the source's formula) in f64 and compares the intensities: the
largest distance over the sample's peak (`ray_err`) and the sample's
total (`flux_err`).  The control is that reference with the seed in f32
and the march in bfloat16 (one precision below each of the
configuration's).
"""

import math

import torch

from bench_port import compare
from bench_port.reference import volume

DTYPES = {"float64": torch.float64, "float32": torch.float32,
          "bfloat16": torch.bfloat16}


def omega(cfg):
    """The spot's Keplerian angular velocity 1 / (r^1.5 + a) (prograde),
    computed here and handed to both sides."""
    return 1.0 / (cfg["r_spot"] ** 1.5 + cfg["a"])


def t0(cfg, p):
    return p["phase"] * 2.0 * math.pi / omega(cfg)


def source_args(cfg):
    w = 1.0 / cfg["spot_size"]
    return dict(amp=1.0, center=cfg["r_spot"], inv_width=w, inv_height=w,
                cylindrical=True, omega=omega(cfg), inv_arc=w)


def setup(cfg, mix, dev):
    from sim5_tpu_torch.march.emission import GaussianSource
    from sim5_tpu_torch.render import volume_image
    return dict(cfg=cfg, mix=mix, dev=dev, volume_image=volume_image,
                source=GaussianSource(**source_args(cfg)))


def call(state, p, span):
    cfg = state["cfg"]
    with span("volume_image"):
        return state["volume_image"](
            cfg["a"], math.radians(cfg["incl_deg"]), state["source"],
            npix=int(cfg["npix"]), rmax=cfg["rmax"], r_start=cfg["r_start"],
            max_steps=int(cfg["max_steps"]), precision=cfg["precision"],
            engine="kernel", t0=t0(cfg, p),
            dtype=DTYPES[cfg["seed_dtype"]], device=state["dev"])


def rays(cfg, mix):
    return int(cfg["npix"]) ** 2


def counters(state):
    """The last march's lane-trips and warp-trips (the port's counter)."""
    from sim5_tpu_torch.march.kernel_march import march_counters
    lane, warp, _ = march_counters()
    return dict(lane_trips=lane, warp_trips=warp)


def pick(cfg, mix, rng):
    """The sampled pixels (flat indices) of a call."""
    return sorted(int(i) for i in rng.choice(
        int(cfg["npix"]) ** 2, int(mix["sample"]["rays"]), replace=False))


def keep(state, p, out, rng):
    idx = pick(state["cfg"], state["mix"], rng)
    sel = torch.as_tensor(idx, device=out.device)
    return dict(p=p, idx=idx, I=out.reshape(-1)[sel].double().cpu())


def image(cfg, p, idx, seed_dtype, march_dtype, dev):
    return volume.pixels_image(
        cfg["a"], math.radians(cfg["incl_deg"]), t0(cfg, p),
        int(cfg["npix"]), cfg["rmax"], cfg["r_start"], int(cfg["max_steps"]),
        cfg["precision"], volume.gaussian_source(**source_args(cfg)), idx,
        seed_dtype, march_dtype, dev)


def control(cfg, mix, p, rng, dev):
    idx = pick(cfg, mix, rng)
    return dict(p=p, idx=idx, I=image(
        cfg, p, idx, DTYPES[cfg["control_seed_dtype"]],
        DTYPES[cfg["control_march_dtype"]], dev))


def judge(cfg, mix, kept, dev):
    out = dict(ray_err=0.0, flux_err=0.0)
    for k in kept:
        want = image(cfg, k["p"], k["idx"], torch.float64, torch.float64,
                     dev)
        for name, v in (("ray_err", compare.peak_err(k["I"], want)),
                        ("flux_err", compare.sum_err(k["I"], want))):
            out[name] = max(out[name], v) if math.isfinite(v) else v
    return out
