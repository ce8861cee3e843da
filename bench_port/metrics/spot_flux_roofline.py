"""spot_flux_roofline: the share of their roofline of the device
operations that follow the crossing-map kernels in each traced call (the
maps' anchor, a masked minimum an order, and `spot_flux`'s eager ops over
(n_t, orders, pixels)), against the flux's own work: its arithmetic over
(n_t, orders, pixels) and the maps read once and the curve written once
(work/spot_flux.json), over the profiler's time of those operations."""

import re

from bench_port import readers


def work(run):
    w = run.work("spot_flux")
    po = (readers.calls(run) * int(run.cfg["npix"]) ** 2
          * int(run.cfg["n_orders"]))
    n_t = int(run.cfg["n_t"])
    ops = (w["ops_per_time_pixel_order"] * n_t + w["ops_per_pixel_order"]) \
        * po
    nbytes = (w["bytes_per_pixel_order"] * po
              + w["bytes_per_time"] * n_t * readers.calls(run))
    return {w["precision"]: ops}, nbytes


def seconds(run):
    """Device seconds of the operations after each call's last crossing-map
    kernel, inside the call."""
    rx = re.compile(readers.CROSSING)
    total = 0.0
    for lo, hi in run.trace.calls():
        ops = [(n, s, e) for n, s, e in run.trace.ops() if lo <= s < hi]
        ends = [e for n, s, e in ops if rx.search(n)]
        if ends:
            total += sum(e - s for n, s, e in ops if s >= max(ends))
    return total * 1e-6


def read(run):
    if not readers.traced(run):
        return None
    from bench_port import roofline
    ops, nbytes = work(run)
    return roofline.share_pct(ops, nbytes, seconds(run))
