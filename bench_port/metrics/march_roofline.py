"""march_roofline: the march kernel's (march_f32, every segment) share of
its roofline: the least time of the frozen work a ray-step
(work/march_f32_emission.json) times the steps the port's counter gives
(lane-trips, the sum of every ray's trial steps, read after each traced
call), plus each ray's state read and written once, over the profiler's
time of the kernel."""

from bench_port import readers


def work(run):
    w = run.work("march_f32_emission")
    steps = sum(c["lane_trips"] for c in run.counters)
    rays = readers.calls(run) * int(run.cfg["npix"]) ** 2
    return ({w["precision"]: w["ops_per_step"] * steps},
            w["bytes_per_ray"] * rays)


def read(run):
    if not run.counters:
        return None
    return readers.share(run, readers.MARCH, work)
