"""host_ms_per_call: each traced call's wall time less the union of the
device operations inside it, the mean over the traced calls, in ms: the
time the call kept the device waiting on the host (entry and launch
layers)."""

from bench_port import readers, stats


def read(run):
    if not readers.traced(run):
        return None
    return 1e-3 * stats.host_time_per_call(
        run.trace.calls(), [(s, e) for _, s, e in run.trace.ops()])
