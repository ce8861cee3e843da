"""Run one cell of the benchmark and print its result line.

    python3 bench_port/run.py --workload <name> --seed <n> --seconds <s>
        --trace <0|1>

The cell's configuration, traffic mix and cell file are found by name
(`registry.py`).  Set-up builds the entry's state on the card and warms
up the cell's shapes with the mix's warm-up calls (the port builds its
kernels at their first use, here); `setup_s` runs from the process's start
to the window's.  The window is closed-loop: one caller issues a call,
waits for its synchronised result, and issues the next, for `--seconds`
seconds (and at least until every sampled call has run).  With `--trace
0` the end-to-end metrics come from the window's host clock; with
`--trace 1` the window runs under torch.profiler (at most the mix's
`trace_calls` calls) and the per-layer metrics come from its trace, which
must hold the cell's expected kernels (the guard profiles again up to
TRACE_TRIES times, then fails the run).  After the window: the peak of
device memory, the check that no JAX module was loaded, the entry's state
freed, and then the judge: the plain reference worked out again for the
sampled calls' answers, each compared number printed beside its limit on
standard error and in the result line, whose last key holds them.

`--control` runs the cell's control instead of a window: the reference in
the precision below the configuration's, in the program's place, for the
sampled calls only, judged as a run is.  The benchmark's own runs never
run it.
"""

import argparse
import contextlib
import gc
import json
import math
import os
import pathlib
import subprocess
import sys
import tempfile
import time

from . import traffic
from .registry import Registry
from .trace import Trace

FORBIDDEN = ("jax", "jaxlib", "flax", "sim5_tpu")
TRACE_TRIES = 3


class Fail(Exception):
    """A run that prints no result: its message goes to standard error and
    the process exits with `code`."""

    def __init__(self, msg, code=1):
        super().__init__(msg)
        self.code = code


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--control", action="store_true",
                   help="judge the control (the reference one precision "
                        "below the configuration's) in the program's place")
    return p.parse_args(argv)


def cache_dirs(root):
    """Fix every build and kernel cache the process may use inside the
    checkout (the port's own libraries go to build/sim5_tpu_torch/), at
    paths that do not move from run to run."""
    base = pathlib.Path(root) / "build" / "bench_port"
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "cuda_cache")):
        os.environ[var] = str(base / sub)


def forbidden_modules():
    """The loaded modules whose whole top-level name is one of FORBIDDEN."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def power_limit():
    """The card's power limit in W (`nvidia-smi`), or None."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits", "-i", "0"],
            capture_output=True, text=True, timeout=30)
        return float(out.stdout.strip().splitlines()[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        return None


class Run:
    """What the window measured, for the metric readers: the calls'
    (start, end) on the host clock, their rays, set-up seconds; in a
    traced run the trace and the counters read after each call."""

    def __init__(self, cfg, mix, cell, registry, setup_s):
        self.cfg, self.mix, self.cell = cfg, mix, cell
        self.registry = registry
        self.setup_s = setup_s
        self.times = []
        self.rays = 0
        self.trace = None
        self.counters = []

    def work(self, name):
        return self.registry.work(name)


def _spans(tracing):
    import torch

    def span(name):
        if not tracing:
            return contextlib.nullcontext()
        return torch.profiler.record_function(f"bench:{name}")
    return span


def window(entry, state, run, calls, seconds, sample, seed, sync, span,
           max_calls=None, counters=False):
    """The closed-loop window: calls from the iterator `calls` until
    `seconds` have passed and every index of `sample` has run (or
    `max_calls` calls); returns the kept answers of the sampled calls."""
    kept = []
    last = max(sample) if sample else -1
    t_start = time.perf_counter()
    i = 0
    while True:
        p = next(calls)
        t0 = time.perf_counter()
        with span("call"):
            out = entry.call(state, p, span)
            sync()
        t1 = time.perf_counter()
        run.times.append((t0, t1))
        run.rays += entry.rays(run.cfg, run.mix)
        if counters:
            run.counters.append(entry.counters(state))
        if i in sample:
            kept.append(entry.keep(state, p, out,
                                   traffic.rng(seed, 2, i)))
        del out
        i += 1
        if max_calls is not None and i >= max_calls and i > last:
            break
        if t1 - t_start >= seconds and i > last:
            break
    return kept


def traced_window(entry, state, run, calls, seconds, sample, seed, sync,
                  expected):
    """The window under torch.profiler, at most the mix's `trace_calls`
    calls; profiled again (more calls of the same mix) up to TRACE_TRIES
    times while an expected kernel is missing from the trace."""
    from torch.profiler import ProfilerActivity, profile
    n_max = int(run.mix.get("trace_calls", 32))
    span = _spans(True)
    kept = None
    for attempt in range(TRACE_TRIES):
        run.times, run.rays, run.counters = [], 0, []
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            got = window(entry, state, run, calls, seconds,
                         sample if kept is None else [], seed, sync, span,
                         max_calls=n_max,
                         counters=hasattr(entry, "counters"))
            sync()
        kept = got if kept is None else kept
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            prof.export_chrome_trace(path)
            run.trace = Trace.load(path)
        finally:
            os.unlink(path)
        missing = run.trace.missing(expected)
        if not missing and run.trace.calls():
            return kept
        print(f"trace {attempt + 1}: the profiler's trace holds no kernel "
              f"matching {missing} (or no call span)", file=sys.stderr)
    raise Fail(f"the traced window lacks the kernels {missing} after "
               f"{TRACE_TRIES} profiles", code=4)


def judge(entry, cfg, mix, cell, kept, dev):
    """{name: (value, limit)} of every number compared, and whether each
    is within its limit (a NaN is not)."""
    values = entry.judge(cfg, mix, kept, dev)
    limits = cell["limits"]
    if set(values) != set(limits):
        raise Fail(f"the judge compared {sorted(values)}, the cell limits "
                   f"{sorted(limits)}")
    checks = {k: (float(values[k]), float(limits[k])) for k in sorted(values)}
    ok = {k: v <= lim for k, (v, lim) in checks.items()}
    return checks, ok


def main(argv=None, root=None, t_process=None, require_card=True):
    """Run the cell; returns the process's exit code, 0 with a result line
    printed last on standard output."""
    t_process = time.perf_counter() if t_process is None else t_process
    args = parse(argv)
    root = pathlib.Path(root or pathlib.Path(__file__).resolve().parent.parent)
    try:
        return _main(args, root, t_process, require_card)
    except Fail as e:
        print(f"bench_port: {e}", file=sys.stderr)
        return e.code


def _main(args, root, t_process, require_card):
    cache_dirs(root)
    reg = Registry.load(root)
    wl = reg.workload(args.workload)
    _, cfg = reg.config(wl["config"])
    mix = reg.traffic(wl["traffic"])
    cell = reg.cell(wl["name"])
    import torch
    if require_card:
        if not torch.cuda.is_available():
            raise Fail("no CUDA device: torch.cuda.is_available() is false",
                       code=2)
        if torch.cuda.device_count() < wl["chips"]:
            raise Fail(f"{torch.cuda.device_count()} CUDA devices, the cell "
                       f"asks for {wl['chips']}", code=2)
        dev = torch.device("cuda", 0)
    else:
        dev = torch.device("cpu")
    on_card = dev.type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize(dev)

    entry = reg.entry(mix["entry"])
    sample = traffic.sampled(mix, args.seed)
    if args.control:
        return control(entry, cfg, mix, cell, sample, args.seed, dev)

    marks = [("imports", time.perf_counter() - t_process)]
    state = entry.setup(cfg, mix, dev)
    sync()
    marks.append(("entry set-up", time.perf_counter() - t_process))
    warm = traffic.calls(mix, args.seed, stream=1)
    span = _spans(False)
    for k in range(int(mix.get("warmup_calls", 2))):
        p = next(warm)
        out = entry.call(state, p, span)
        sync()
        if k == 0:
            # what keeps a sampled answer runs once here too, so that the
            # window's first sampled call loads nothing
            entry.keep(state, p, out, traffic.rng(args.seed, 3))
        del out
        marks.append((f"warm-up call {k + 1}",
                      time.perf_counter() - t_process))
    # where set-up goes (seconds since the process started), and what the
    # port built or loaded
    print("set-up: " + ", ".join(f"{n} {t:.3f}" for n, t in marks),
          file=sys.stderr)
    builds = sys.modules.get("sim5_tpu_torch._build")
    if builds is not None:
        print("libraries: " + ", ".join(
            f"{k} {'cached' if v['cached'] else 'built'} {v['seconds']:.3f} s"
            for k, v in builds.BUILDS.items()), file=sys.stderr)
    run = Run(cfg, mix, cell, reg, time.perf_counter() - t_process)
    calls = traffic.calls(mix, args.seed)
    if args.trace:
        kept = traced_window(entry, state, run, calls, args.seconds, sample,
                             args.seed, sync, cell["kernels"])
    else:
        kept = window(entry, state, run, calls, args.seconds, sample,
                      args.seed, sync, span)
    memory_peak = torch.cuda.max_memory_allocated(dev) if on_card else 0
    found = forbidden_modules()
    if found:
        raise Fail(f"sys.modules holds {found} once the window has closed",
                   code=3)
    metrics = {}
    names = reg.per_layer(wl["name"]) if args.trace else reg.end_to_end(
        wl["name"])
    for m in names:
        value = reg.metric(m["name"]).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    limit_w = power_limit() if on_card else None
    device = {"platform": "gpu" if on_card else "cpu",
              "kind": torch.cuda.get_device_name(dev) if on_card else "cpu",
              "count": wl["chips"], "memory_peak_bytes": int(memory_peak),
              "power_limit_w": limit_w}
    breakdown = None
    if args.trace:
        lo, hi = run.trace.window()
        device["busy_s"] = run.trace.busy_us() * 1e-6
        device["window_s"] = (hi - lo) * 1e-6
        breakdown = {"device_ops": run.trace.device_top(),
                     "idle_gaps": run.trace.idle_top()}
    attempted = len(run.times)
    del state, run
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    t_judge = time.perf_counter()
    checks, ok = judge(entry, cfg, mix, cell, kept, dev)
    print(f"judge: {len(kept)} sampled calls in "
          f"{time.perf_counter() - t_judge:.3f} s", file=sys.stderr)
    return report(checks, ok, attempted, metrics, device, breakdown)


def control(entry, cfg, mix, cell, sample, seed, dev):
    """The control in the program's place on the sampled calls, judged."""
    import torch
    calls = traffic.calls(mix, seed)
    kept = []
    for i in range(max(sample) + 1):
        p = next(calls)
        if i in sample:
            kept.append(entry.control(cfg, mix, p, traffic.rng(seed, 2, i),
                                      dev))
    checks, ok = judge(entry, cfg, mix, cell, kept, dev)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    device = {"platform": "gpu" if dev.type == "cuda" else "cpu",
              "kind": name, "count": 1, "memory_peak_bytes": 0}
    return report(checks, ok, len(sample), {}, device, None)


def report(checks, ok, attempted, metrics, device, breakdown):
    """Print each number compared beside its limit as the last lines of
    standard error, then the result line as the last of standard output;
    returns 0."""
    failed = sum(not v for v in ok.values())
    for k, (v, lim) in checks.items():
        print(f"check {k} {v!r} limit {lim!r} "
              f"{'ok' if ok[k] else 'FAILED'}", file=sys.stderr, flush=True)
    line = {"correct": failed == 0 and all(math.isfinite(v)
                                           for v, _ in checks.values()),
            "attempted": attempted, "failed": failed,
            "metrics": metrics, "device": device}
    if breakdown is not None:
        line["breakdown"] = breakdown
    # a number that is not finite is written as null: JSON has no NaN
    line["checks"] = {k: {"value": v if math.isfinite(v) else None,
                          "limit": lim} for k, (v, lim) in checks.items()}
    print(json.dumps(line), flush=True)
    return 0
