"""Helpers of the metric readers (`metrics/<name>.py`).

A reader is a module with `read(run)`, where `run` is the harness's `Run`:
the window's calls on the host clock, and in a traced run the profiler's
trace (`run.trace`) and the entry's counters after each call
(`run.counters`).  A reader returns the metric's value, or None where it
finds nothing to read; then the metric is left out of the line.  A
roofline reader also has `work(run)`: ({precision: operations}, bytes) of
its kernel over the traced calls, counted by the benchmark's own frozen
work (`work/<kernel>.json`), which `call_mfu` sums.
"""

from . import roofline

# kernel names, demangled ("(anonymous namespace)::nt_image<float, ...")
# or mangled ("..._18nt_imageIfLb0E...")
IMAGE = r"(?<![A-Za-z_])nt_(frames|image)(<|I)"
TANGENT = r"(?<![A-Za-z_])nt_(frames_jvp|image_jvp|reduce)(<|I)"
MARCH = r"(?<![A-Za-z_])march_f32(<|I)"
SEED = r"(?<![A-Za-z_])seed_(geometry|azimuth)(<|I)"
CROSSING = r"(?<![A-Za-z_])crossing_(classify|hits)(<|I)"


def precision(run):
    """"f32" or "f64": the configuration's precision, as the frozen work
    files name it (work/disk_image_f32.json)."""
    return {"float32": "f32", "float64": "f64"}[run.cfg["dtype"]]


def traced(run):
    """Whether the run holds a trace with at least one call."""
    return run.trace is not None and bool(run.trace.calls())


def kernel_seconds(run, pattern):
    """Seconds of the traced window's kernels whose names match."""
    return sum(e - s for _, s, e in run.trace.kernels(pattern)) * 1e-6


def calls(run):
    return len(run.trace.calls())


def call_seconds(run):
    """The traced calls' wall time, summed (host spans, seconds)."""
    return sum(e - s for s, e in run.trace.calls()) * 1e-6


def share(run, pattern, work):
    """The roofline share (%) of the kernels matching `pattern`, with the
    work `work(run)`; None where the trace holds none of them."""
    if not traced(run):
        return None
    t = kernel_seconds(run, pattern)
    if t <= 0:
        return None
    ops, nbytes = work(run)
    return roofline.share_pct(ops, nbytes, t)


def frames_pixels(run):
    """Pixels of the image kernels over the traced calls: the mix's frames
    times the configuration's npix^2, a call."""
    return calls(run) * int(run.mix["frames"]) * int(run.cfg["npix"]) ** 2
