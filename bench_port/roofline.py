"""Published peaks of one NVIDIA H100 SXM (data sheet, dense, outside the
tensor cores, at its 700 W limit) and the least time of a piece of work.

A kernel's share of its roofline is the least time the chip could take
for the work (the larger of its operations over the peak rate of their
precision and its bytes over the memory rate) over the time the kernel
took.  The work is the benchmark's own count (`work/`), never the
program's.
"""

PEAK_FLOPS = {"f64": 34e12, "f32": 67e12}
PEAK_BYTES = 3.35e12


def least_time(ops, nbytes):
    """Seconds the chip needs at least for `ops` ({precision: operations})
    and `nbytes` bytes read or written once: (seconds, "operations" or
    "bytes", whichever bounds it)."""
    t_ops = sum(n / PEAK_FLOPS[p] for p, n in ops.items())
    t_bytes = nbytes / PEAK_BYTES
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def share_pct(ops, nbytes, seconds):
    """The roofline share in percent of work that took `seconds`; None
    without a time to divide by."""
    if not seconds or seconds <= 0:
        return None
    return 100.0 * least_time(ops, nbytes)[0] / seconds
