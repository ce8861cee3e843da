"""device_idle_pct: the share of the traced window (first call's start to
last call's end) in which no device operation runs, in percent."""

from bench_port import readers, stats


def read(run):
    if not readers.traced(run):
        return None
    lo, hi = run.trace.window()
    return 100.0 * stats.idle_share([(s, e) for _, s, e in run.trace.ops()],
                                    lo, hi)
