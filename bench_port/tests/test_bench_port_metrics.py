"""The benchmark's metric arithmetic on synthetic windows and traces, its
roofline functions and frozen work, and finding its pieces by name.

A stall in a synthetic window must move every metric that depends on it;
the readers must take a synthetic profiler trace as the harness hands it
to them; and a cell, a configuration, a traffic mix and a per-layer
metric placed as new files (and new entries of BENCHMARK.json) in a copy
of the benchmark must be found by name with no existing file edited.

Run: python -m pytest bench_port/tests -q
"""

import json
import math
import pathlib
import shutil
import sys

import pytest
import torch

BENCH = pathlib.Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
sys.path.insert(0, str(ROOT))

from bench_port import compare, roofline, stats, traffic  # noqa: E402
from bench_port.harness import Run  # noqa: E402
from bench_port.registry import Registry  # noqa: E402
from bench_port.trace import Trace  # noqa: E402


def steady(n=100, call=10.0, gap=1.0, kernel=8.0):
    """n calls of `call` us one after another, `gap` us apart, each with
    one kernel of `kernel` us at its end."""
    calls, kernels, t = [], [], 0.0
    for _ in range(n):
        calls.append((t, t + call))
        kernels.append((t + call - kernel, t + call))
        t += call + gap
    return calls, kernels


def stall(calls, kernels, at=50, extra=500.0):
    """The same window with the host stalled `extra` us inside call `at`."""
    c2, k2 = [], []
    for i, ((s, e), (ks, ke)) in enumerate(zip(calls, kernels)):
        shift = extra if i > at else 0.0
        c2.append((s + shift, e + shift + (extra if i == at else 0.0)))
        k2.append((ks + shift + (extra if i == at else 0.0),
                   ke + shift + (extra if i == at else 0.0)))
    return c2, k2


def metrics(calls, kernels, rays_per_call=1000):
    lo, hi = calls[0][0], calls[-1][1]
    return dict(
        rate=stats.rate(rays_per_call * len(calls), lo, hi),
        p95=stats.percentile([e - s for s, e in calls], 95),
        p100=max(e - s for s, e in calls),
        idle=stats.idle_share(kernels, lo, hi),
        host=stats.host_time_per_call(calls, kernels))


def test_window_arithmetic():
    calls, kernels = steady()
    m = metrics(calls, kernels)
    assert m["rate"] == pytest.approx(1000 * 100 / (100 * 11 - 1))
    assert m["p95"] == 10.0
    assert m["idle"] == pytest.approx(1 - 800 / 1099)
    assert m["host"] == pytest.approx(2.0)


def test_a_stall_moves_every_metric():
    calls, kernels = steady()
    base = metrics(calls, kernels)
    # six stalled calls of 100: the 95th percentile (nearest rank) sees them
    c, k = calls, kernels
    for at in (10, 25, 40, 55, 70, 85):
        c, k = stall(c, k, at=at)
    moved = metrics(c, k)
    assert moved["rate"] < base["rate"]
    assert moved["p95"] > base["p95"]
    assert moved["idle"] > base["idle"]
    assert moved["host"] > base["host"]


def test_percentile_is_of_all_calls():
    values = list(range(1, 101))
    assert stats.percentile(values, 95) == 95
    assert stats.percentile([5.0], 95) == 5.0
    assert stats.percentile(values + [1000], 95) == 96


def test_union_and_gaps():
    iv = [(0, 2), (1, 3), (5, 6), (6, 7), (9, 9)]
    assert stats.union(iv) == [(0, 3), (5, 7)]
    assert stats.covered(iv, 0, 10) == 5
    assert stats.gaps(iv, 0, 10) == [(7, 10), (3, 5)]


def chrome(calls, kernels, names=None):
    """A Chrome trace of the calls' spans and their kernels."""
    ev = [{"ph": "X", "cat": "user_annotation", "name": "bench:call",
           "ts": s, "dur": e - s} for s, e in calls]
    for i, (s, e) in enumerate(kernels):
        name = (names or ["void (anonymous namespace)::nt_image<float, "
                          "false>(float const*)"])[i % len(names or [0])]
        ev.append({"ph": "X", "cat": "kernel", "name": name, "ts": s,
                   "dur": e - s})
    ev.append({"ph": "X", "cat": "cpu_op", "name": "aten::add", "ts": 0.5,
               "dur": 1.0})
    return {"traceEvents": ev}


def fake_run(tmp_path, calls, kernels, names=None, counters=()):
    reg = Registry.load(ROOT)
    _, cfg = reg.config("nt_disk_m10")
    mix = reg.traffic("spin_sweep_256")
    run = Run(cfg, mix, reg.cell("nt_sweep_f32"), reg, 1.0)
    run.trace = Trace.parse(chrome(calls, kernels, names))
    run.counters = list(counters)
    return reg, run


def test_readers_on_a_synthetic_trace(tmp_path):
    calls, kernels = steady(n=10, call=10_000.0, gap=1_000.0,
                            kernel=8_000.0)
    reg, run = fake_run(tmp_path, calls, kernels)
    assert reg.metric("launches_per_call").read(run) == 1.0
    assert reg.metric("host_ms_per_call").read(run) == pytest.approx(2.0)
    assert reg.metric("device_idle_pct").read(run) == pytest.approx(
        100 * (1 - 80_000 / 109_000))
    share = reg.metric("image_roofline").read(run)
    ops, nbytes = reg.metric("image_roofline").work(run)
    want = roofline.least_time(ops, nbytes)[0] / 0.080 * 100
    assert share == pytest.approx(want)
    # a kernel the reader does not price leaves it silent, never 0
    reg2, run2 = fake_run(tmp_path, calls, kernels, names=["void other()"])
    assert reg2.metric("image_roofline").read(run2) is None
    assert reg2.metric("march_lane_use_pct").read(run2) is None
    assert run.trace.missing([r"nt_image(<|I)", r"march_f32"]) == [
        r"march_f32"]
    assert run.trace.idle_top(1)[0][1] == pytest.approx(1e-3 * 3)


def test_stall_in_a_trace_moves_the_readers(tmp_path):
    calls, kernels = steady(n=20, call=10_000.0, gap=1_000.0,
                            kernel=8_000.0)
    reg, base = fake_run(tmp_path, calls, kernels)
    c, k = stall(calls, kernels, at=5, extra=50_000.0)
    _, moved = fake_run(tmp_path, c, k)
    for name in ("device_idle_pct", "host_ms_per_call"):
        assert reg.metric(name).read(moved) > reg.metric(name).read(base)
    assert reg.metric("call_mfu").read(moved) < reg.metric(
        "call_mfu").read(base)


def test_g_err_takes_the_pixels_both_images_light():
    """A pixel lit in one image only is the footprint's, whatever its g;
    a pixel lit in both counts."""
    want_f = torch.tensor([[[1.0, 1.0, 0.0]]])
    want_g = torch.tensor([[[0.5, 0.7, 0.6]]])
    got_f = torch.tensor([[[1.0, 1.0, 2.0]]])
    got_g = torch.tensor([[[0.5, 0.7, 0.1]]])
    assert compare.g_err(got_f, got_g, want_f, want_g) == 0.0
    assert compare.footprint(got_f, want_f) == pytest.approx(1 / 3)
    got_g[0, 0, 1] = 0.9
    assert compare.g_err(got_f, got_g, want_f, want_g) == pytest.approx(0.2)
    got_g[0, 0, 0] = float("nan")
    assert math.isnan(compare.g_err(got_f, got_g, want_f, want_g))


def test_least_time_and_share():
    t, by = roofline.least_time({"f32": 67e12}, 0)
    assert (t, by) == (1.0, "operations")
    t, by = roofline.least_time({"f64": 1.0}, 3.35e12)
    assert (t, by) == (1.0, "bytes")
    assert roofline.least_time({"f64": 34e12, "f32": 67e12}, 0)[0] == 2.0
    assert roofline.share_pct({"f32": 67e12}, 0, 4.0) == 25.0
    assert roofline.share_pct({"f32": 1.0}, 0, 0.0) is None


@pytest.mark.parametrize("name", sorted(p.stem for p in (BENCH / "work")
                                        .glob("*.json")))
def test_work_files_say_where_they_come_from(name):
    w = json.loads((BENCH / "work" / f"{name}.json").read_text())
    assert w["commit"] and w["chip_call"] and w["how"]
    numbers = [v for k, v in w.items() if k.startswith(("ops", "bytes"))]
    flat = [x for v in numbers for x in (v.values() if isinstance(v, dict)
                                         else [v])]
    assert all(x >= 0 for x in flat) and sum(x > 0 for x in flat) >= 2


def test_rooflines_from_shapes(tmp_path):
    """Each roofline reader's work at the cell's shapes, by hand."""
    calls, kernels = steady(n=3)
    reg, run = fake_run(tmp_path, calls, kernels)
    w = reg.work("disk_image_f32")
    px = 3 * 256 * 512 * 512
    ops, nbytes = reg.metric("image_roofline").work(run)
    assert ops == {"f32": w["ops_per_pixel"] * px}
    assert nbytes == 8 * px + 24 * 3 * 256
    run.cfg, run.mix = reg.config("nt_disk_m10_f64")[1], reg.traffic(
        "grad_sweep_64")
    px = 3 * 64 * 512 * 512
    for metric, work, per_frame in (("image_roofline", "disk_image_f64", 48),
                                    ("tangent_roofline",
                                     "disk_image_jvp_f64", 240)):
        ops, nbytes = reg.metric(metric).work(run)
        assert ops == {"f64": reg.work(work)["ops_per_pixel"] * px}
        assert nbytes == 16 * px + per_frame * 3 * 64
    run.cfg = json.loads((BENCH / "configs" / "hotspot_a05_r7.json")
                         .read_text())
    ops, nbytes = reg.metric("spot_flux_roofline").work(run)
    po = 3 * 512 * 512 * 2
    assert ops == {"f64": (17 * 96 + 4) * po}
    assert nbytes == 33 * po + 8 * 96 * 3


def test_traffic_is_the_same_work_in_another_order():
    mix = {"draws": {"a": [0.0, 1.0], "b": [10.0, 20.0]}, "strata": 8}

    def first(seed, n=8):
        g = traffic.calls(mix, seed)
        return [next(g) for _ in range(n)]

    one, two = first(1), first(2 ** 33 + 7)
    assert one == first(1)
    for key, (lo, hi) in mix["draws"].items():
        for calls in (one, two):
            strata = sorted(int((c[key] - lo) / (hi - lo) * 8)
                            for c in calls)
            assert strata == list(range(8))
    assert one != two


def test_new_pieces_are_found_by_name(tmp_path):
    """A new configuration, traffic mix, cell and per-layer metric as new
    files and new BENCHMARK.json entries, in a copy of the benchmark."""
    root = tmp_path / "checkout"
    shutil.copytree(BENCH, root / "bench_port",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    before = {p.relative_to(root): p.read_bytes()
              for p in (root / "bench_port").rglob("*") if p.is_file()}
    folder = root / "bench_port"
    (folder / "configs" / "nt_disk_m20.json").write_text(json.dumps(dict(
        json.loads((folder / "configs" / "nt_disk_m10.json").read_text()),
        M=20.0)))
    (folder / "traffic" / "spin_sweep_64.json").write_text(json.dumps(dict(
        json.loads((folder / "traffic" / "spin_sweep_256.json").read_text()),
        frames=64)))
    (folder / "cells" / "nt_sweep_m20.json").write_text(
        (folder / "cells" / "nt_sweep_f32.json").read_text())
    (folder / "metrics" / "frames_per_call.py").write_text(
        "def read(run):\n    return float(run.mix['frames'])\n")
    bench["configs"].append(dict(bench["configs"][0], name="nt_disk_m20",
                                 file="bench_port/configs/nt_disk_m20.json"))
    bench["workloads"].append(dict(bench["workloads"][0], name="nt_sweep_m20",
                                   config="nt_disk_m20",
                                   traffic="spin_sweep_64"))
    bench["per_layer"].append(dict(name="frames_per_call", unit="frames",
                                   better="higher", source="program_counter",
                                   layer="entry", moves="rays_per_s",
                                   workloads=["nt_sweep_m20"]))
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    reg = Registry.load(root)
    wl = reg.workload("nt_sweep_m20")
    assert reg.config(wl["config"])[1]["M"] == 20.0
    assert reg.traffic(wl["traffic"])["frames"] == 64
    assert reg.cell("nt_sweep_m20")["limits"]
    assert reg.entry(reg.traffic(wl["traffic"])["entry"]).rays(
        reg.config(wl["config"])[1], reg.traffic(wl["traffic"])) == \
        64 * 512 * 512
    names = [m["name"] for m in reg.per_layer("nt_sweep_m20")]
    assert "frames_per_call" in names
    run = Run(reg.config("nt_disk_m20")[1], reg.traffic("spin_sweep_64"),
              reg.cell("nt_sweep_m20"), reg, 0.0)
    assert reg.metric("frames_per_call").read(run) == 64.0
    after = {p.relative_to(root): p.read_bytes()
             for p in (root / "bench_port").rglob("*") if p.is_file()
             and "__pycache__" not in p.parts}
    assert all(after[p] == b for p, b in before.items()
               if "__pycache__" not in p.parts)
