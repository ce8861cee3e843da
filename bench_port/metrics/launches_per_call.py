"""launches_per_call: the kernels the trace holds inside the traced calls,
over the calls."""

from bench_port import readers


def read(run):
    if not readers.traced(run):
        return None
    calls = run.trace.calls()
    n = sum(1 for _, s, e in run.trace.kernels()
            if any(lo <= s < hi for lo, hi in calls))
    return n / len(calls)
