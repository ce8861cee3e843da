"""The traced run's reading of the profiler: device operations, the calls'
spans and the host's activity, from torch.profiler's Chrome trace.

`Trace.parse` takes the trace's JSON (times in microseconds on one
timeline) and keeps three lists: the device's operations (kernels,
copies, memsets) as (name, start, end), the benchmark's own spans
(`record_function` ranges, whose names start with "bench:") as (name,
start, end), and the host's operations (cpu_op and user annotations) for
naming idle gaps.  `missing` is the guard: the expected kernels that no
device operation of the trace matches.
"""

import json
import re

from . import stats

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation")
CALL = "bench:call"


class Trace:
    def __init__(self, device, spans, host):
        self.device = sorted(device, key=lambda d: d[1])
        self.spans = sorted(spans, key=lambda s: s[1])
        self.host = host

    @classmethod
    def parse(cls, events):
        """From the Chrome trace's event list (or its {"traceEvents": ...}
        object)."""
        if isinstance(events, dict):
            events = events.get("traceEvents", [])
        device, spans, host = [], [], []
        for e in events:
            if e.get("ph") != "X" or "dur" not in e:
                continue
            cat = str(e.get("cat", "")).lower()
            item = (str(e.get("name", "")), float(e["ts"]),
                    float(e["ts"]) + float(e["dur"]))
            if cat in DEVICE_CATS:
                device.append(item + (cat,))
            elif cat in HOST_CATS:
                host.append(item)
                if cat == "user_annotation" and item[0].startswith("bench:"):
                    spans.append(item)
        return cls(device, spans, host)

    @classmethod
    def load(cls, path):
        with open(path) as f:
            return cls.parse(json.load(f))

    def calls(self):
        """(start, end) of each traced call, in order."""
        return [(s, e) for n, s, e in self.spans if n == CALL]

    def window(self):
        """(start, end) of the traced window: the first call's start to
        the last call's end."""
        c = self.calls()
        return c[0][0], c[-1][1]

    def kernels(self, pattern=None):
        """The kernels (name, start, end) inside the window, those whose
        name matches the regex `pattern` if given."""
        lo, hi = self.window()
        rx = re.compile(pattern) if pattern else None
        return [(n, s, e) for n, s, e, cat in self.device
                if cat == "kernel" and s >= lo and e <= hi
                and (rx is None or rx.search(n))]

    def ops(self):
        """Every device operation (name, start, end) that overlaps the
        window, clipped to it."""
        lo, hi = self.window()
        return [(n, max(s, lo), min(e, hi)) for n, s, e, _ in self.device
                if e > lo and s < hi]

    def busy_us(self):
        lo, hi = self.window()
        return stats.covered([(s, e) for _, s, e in self.ops()], lo, hi)

    def missing(self, patterns):
        """The patterns of `patterns` that no device operation matches."""
        names = [d[0] for d in self.device]
        return [p for p in patterns
                if not any(re.search(p, n) for n in names)]

    def device_top(self, k=10):
        """[[name, seconds]] of the k device operations that took the most
        time in the window, summed by name."""
        tot = {}
        for n, s, e in self.ops():
            tot[n] = tot.get(n, 0.0) + (e - s) * 1e-6
        return [[n, t] for n, t in sorted(tot.items(),
                                          key=lambda kv: -kv[1])[:k]]

    def idle_top(self, k=10):
        """[[what the host was doing, seconds]] of the k longest idle gaps
        of the device in the window: each gap named by the shortest host
        operation that covers its middle ("host" if none)."""
        lo, hi = self.window()
        out = []
        for s, e in stats.gaps([(a, b) for _, a, b in self.ops()], lo,
                               hi)[:k]:
            mid = 0.5 * (s + e)
            cover = [h for h in self.host if h[1] <= mid <= h[2]]
            name = (min(cover, key=lambda h: h[2] - h[1])[0] if cover
                    else "host")
            out.append([name, (e - s) * 1e-6])
        return out
