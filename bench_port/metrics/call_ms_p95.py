"""call_ms_p95: the 95th percentile (nearest rank) of the wall time of
every call of the window, from its start to its synchronised result (host
clock), in ms."""

from bench_port import stats


def read(run):
    if not run.times or run.trace is not None:
        return None
    return 1e3 * stats.percentile([e - s for s, e in run.times], 95)
