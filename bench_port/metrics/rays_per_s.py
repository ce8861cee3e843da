"""rays_per_s: the image-plane rays whose results the window's calls
returned, over the whole window (its first call's start to its last
call's end, host clock)."""

from bench_port import stats


def read(run):
    if not run.times or run.trace is not None:
        return None
    return stats.rate(run.rays, run.times[0][0], run.times[-1][1])
