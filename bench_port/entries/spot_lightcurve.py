"""Light curves of an orbiting hot spot through the crossing-map kernels:
each call is one `hotspot_lightcurve` of the configuration's spot, its
image orders and its observer times (n_t samples over `periods` orbital
periods), with the spin and the inclination drawn a call, as a light-curve
fit tries models.

The judge works the sampled calls' curves out again with the plain
reference (every pixel's crossing map of every order, computed in blocks
of rows, anchored, then the spot's flux) in f64 and compares them: the
largest distance over the peak (`curve_err`).  The control is that
reference in the configuration's `control_dtype`.
"""

import math

import numpy as np
import torch

from bench_port import compare
from bench_port.reference import crossing

DTYPES = {"float64": torch.float64, "float32": torch.float32}


def t_obs(cfg, a):
    """The observer times: n_t samples over `periods` Keplerian periods of
    the spot's radius at spin a."""
    period = 2.0 * math.pi * (cfg["r_spot"] ** 1.5 + a)
    return (np.arange(int(cfg["n_t"])) / int(cfg["n_t"])
            * float(cfg["periods"]) * period)


def setup(cfg, mix, dev):
    from sim5_tpu_torch.render import hotspot_lightcurve
    return dict(cfg=cfg, dev=dev, lightcurve=hotspot_lightcurve)


def call(state, p, span):
    cfg = state["cfg"]
    with span("hotspot_lightcurve"):
        return state["lightcurve"](
            p["a"], math.radians(p["incl_deg"]), cfg["r_spot"],
            cfg["spot_size"], t_obs(cfg, p["a"]), npix=int(cfg["npix"]),
            rmax=cfg["rmax"], n_orders=int(cfg["n_orders"]),
            device=state["dev"])


def rays(cfg, mix):
    return int(cfg["npix"]) ** 2 * int(cfg["n_orders"])


def keep(state, p, out, rng):
    return dict(p=p, F=out.double().cpu())


def curve(cfg, p, dtype, dev):
    return crossing.lightcurve(
        p["a"], math.radians(p["incl_deg"]), cfg["r_spot"], cfg["spot_size"],
        t_obs(cfg, p["a"]).tolist(), int(cfg["npix"]), cfg["rmax"],
        int(cfg["n_orders"]), dtype, dev, rows=int(cfg["reference_rows"]))


def control(cfg, mix, p, rng, dev):
    return dict(p=p, F=curve(cfg, p, DTYPES[cfg["control_dtype"]], dev))


def judge(cfg, mix, kept, dev):
    err = 0.0
    for k in kept:
        v = compare.peak_err(k["F"], curve(cfg, k["p"], torch.float64, dev))
        err = max(err, v) if math.isfinite(v) else v
    return dict(curve_err=err)
