"""crossing_map_roofline: the crossing-map kernels' (crossing_classify +
crossing_hits, every order in one launch of each) share of their
roofline: the least time of the frozen work a pixel and order
(work/crossing_map_f64.json) over the profiler's time of those kernels."""

from bench_port import readers


def work(run):
    w = run.work("crossing_map_f64")
    units = (readers.calls(run) * int(run.cfg["npix"]) ** 2
             * int(run.cfg["n_orders"]))
    return ({p: n * units for p, n in w["ops_per_pixel_order"].items()},
            w["bytes_per_pixel_order"] * units)


def read(run):
    return readers.share(run, readers.CROSSING, work)
