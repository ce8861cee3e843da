"""seed_ms: the volume seed kernels' (seed_geometry + seed_azimuth) device
time a call, from the profiler, in ms."""

from bench_port import readers


def work(run):
    w = run.work("volume_seed_f64")
    px = readers.calls(run) * int(run.cfg["npix"]) ** 2
    return ({p: n * px for p, n in w["ops_per_pixel"].items()},
            w["bytes_per_pixel"] * px)


def read(run):
    if not readers.traced(run):
        return None
    t = readers.kernel_seconds(run, readers.SEED)
    return 1e3 * t / readers.calls(run) if t > 0 else None
