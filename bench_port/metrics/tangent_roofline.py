"""tangent_roofline: the tangent kernels' (nt_frames_jvp + nt_image_jvp +
nt_reduce, the backward) share of their roofline: the least time of the
frozen work a pixel (work/disk_image_jvp_<f32|f64>.json, the
configuration's precision) over the profiler's time of those kernels."""

from bench_port import readers


def work(run):
    w = run.work(f"disk_image_jvp_{readers.precision(run)}")
    px = readers.frames_pixels(run)
    frames = readers.calls(run) * int(run.mix["frames"])
    return ({w["precision"]: w["ops_per_pixel"] * px},
            w["bytes_per_pixel"] * px + w["bytes_per_frame"] * frames)


def read(run):
    return readers.share(run, readers.TANGENT, work)
