"""The arithmetic of the benchmark's metrics, on plain numbers.

Times are in any one unit (seconds on the host clock, microseconds in a
profiler trace); each function says what it returns.  Nothing here reads
a clock or a device, so the tests can hold it against synthetic windows.
"""

import math


def rate(work, t_start, t_end):
    """Work completed a unit of time over the whole window [t_start,
    t_end]: the window's work over its length, never a median of parts."""
    if t_end <= t_start:
        raise ValueError(f"an empty window [{t_start}, {t_end}]")
    return work / (t_end - t_start)


def percentile(values, q):
    """The q-th percentile (0 < q <= 100) of all `values` by nearest rank:
    the smallest value with at least q% of the values at or below it."""
    if not values:
        raise ValueError("no values")
    s = sorted(values)
    k = max(1, math.ceil(q / 100.0 * len(s)))
    return s[k - 1]


def union(intervals):
    """The intervals (start, end) merged: a sorted list of disjoint
    (start, end)."""
    out = []
    for s, e in sorted(intervals):
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


def covered(intervals, lo, hi):
    """The length of [lo, hi] that the intervals cover (overlaps counted
    once)."""
    return sum(max(0.0, min(e, hi) - max(s, lo))
               for s, e in union(intervals))


def idle_share(device_intervals, lo, hi):
    """The share (0-1) of the window [lo, hi] in which no device interval
    runs."""
    if hi <= lo:
        raise ValueError(f"an empty window [{lo}, {hi}]")
    return 1.0 - covered(device_intervals, lo, hi) / (hi - lo)


def host_time_per_call(calls, device_intervals):
    """The mean over `calls` ((start, end) each) of the call's wall time
    less the union of the device intervals inside it: the time in which
    the call kept the device waiting on the host."""
    if not calls:
        raise ValueError("no calls")
    return sum((e - s) - covered(device_intervals, s, e)
               for s, e in calls) / len(calls)


def gaps(device_intervals, lo, hi):
    """The idle gaps (start, end) of the window [lo, hi] between the
    device intervals, longest first."""
    out, t = [], lo
    for s, e in union(device_intervals):
        if e <= lo or s >= hi:
            continue
        if s > t:
            out.append((t, s))
        t = max(t, e)
    if hi > t:
        out.append((t, hi))
    return sorted(out, key=lambda g: g[0] - g[1])

