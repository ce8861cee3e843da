"""Each cell's comparison fails where it must: the control (the reference
one precision below the configuration's, in the program's place) and a
run whose timed path is broken underneath both come out not correct.

The runs go through the harness on the CPU (its look for a card skipped),
at a size a test run holds: a copy of the benchmark whose configurations
and mixes are shrunk, with the cells' limits as committed.  The faults,
planted in the port's entry point as the entry holds it: an answer
altered where it is produced (scaled by 1.1), half of the batch left out
(half of the frames or rays dark; the light curve's second image order),
and, for the gradient, a backward whose a or incl column alone is
altered (scaled by 1.1, the forward untouched).  The held cells
(`held.json`) are run as well, their entries merged into the copy's
BENCHMARK.json.  On the card, the control runs at the cell's own size with
`python3 bench_port/run.py --workload <cell> --seed <n> --seconds 1
--trace 0 --control`.

Run: python -m pytest bench_port/tests -q
"""

import json
import pathlib
import shutil
import sys

import pytest
import torch

BENCH = pathlib.Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
sys.path.insert(0, str(ROOT))

from bench_port import harness  # noqa: E402
from bench_port.registry import Registry  # noqa: E402

SEED = 20260000017


def tiny(root):
    """A copy of the benchmark at `root`, its images npix 8-12, its sweeps
    4 frames, one sampled call among the first two."""
    shutil.copytree(BENCH, root / "bench_port",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    (root / "BENCHMARK.json").write_text(json.dumps(with_held()))
    for kind in ("configs", "traffic"):
        for f in (root / "bench_port" / kind).glob("*.json"):
            j = json.loads(f.read_text())
            if "npix" in j:
                j["npix"] = 12 if "r_spot" not in j else 8
            if "frames" in j:
                j["frames"] = 4
            if "reference_rows" in j:
                j["reference_rows"] = 4
            if "sample" in j:
                j["sample"].update(calls=1, among=2)
                if "frames" in j["sample"]:
                    j["sample"]["frames"] = 2
                if "rays" in j["sample"]:
                    j["sample"]["rays"] = 32
            if "warmup_calls" in j:
                j["warmup_calls"] = 1
            f.write_text(json.dumps(j))
    return root


def with_held():
    """BENCHMARK.json with the held cells' entries (held.json) added."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    held = json.loads((BENCH / "held.json").read_text())
    for key in ("configs", "workloads", "per_layer"):
        bench[key] += held[key]
    return bench


@pytest.fixture(scope="module")
def checkout(tmp_path_factory):
    return tiny(tmp_path_factory.mktemp("bench"))


def result(capsys, root, workload, *extra):
    rc = harness.main(["--workload", workload, "--seed", str(SEED),
                       "--seconds", "0.1", "--trace", "0", *extra],
                      root=root, require_card=False)
    out = capsys.readouterr().out.strip().splitlines()
    assert rc == 0
    return json.loads(out[-1])


WORKLOADS = tuple(w["name"] for w in with_held()["workloads"])


@pytest.mark.parametrize("workload", WORKLOADS)
def test_sound_run_is_correct(capsys, checkout, workload):
    line = result(capsys, checkout, workload)
    assert line["correct"], line["checks"]
    assert list(line)[-1] == "checks"


@pytest.mark.parametrize("workload", WORKLOADS)
def test_control_is_not_correct(capsys, checkout, workload):
    line = result(capsys, checkout, workload, "--control")
    assert not line["correct"], line["checks"]


def half_dark(out):
    """Half of the frames (or of the rays) left dark."""
    out = out.clone()
    flat = out.reshape(out.shape[0], -1) if out.dim() == 3 else out.reshape(
        1, -1)
    if out.dim() == 3:
        flat[1::2] = 0
    else:
        flat[:, 1::2] = 0
    return out


class _GradTimes(torch.autograd.Function):
    """The identity, whose backward multiplies the gradient by 1.1."""

    @staticmethod
    def forward(ctx, x):
        return x.clone()

    @staticmethod
    def backward(ctx, g):
        return g * 1.1


def scaled(x):
    return x * 1.1


NT_FAULTS = {
    "altered": {"render": lambda fn: lambda *a, **k: tuple(
        map(scaled, fn(*a, **k)))},
}

FAULTS = {
    # {fault: {the state's key of the port's function: its wrapper}}
    "nt_sweep_f32": dict(NT_FAULTS, half={
        "render": lambda fn: lambda *a, **k: tuple(
            half_dark(x) for x in fn(*a, **k))}),
    "nt_grad_f64": dict(NT_FAULTS, half={
        "render": lambda fn: lambda *a, **k: tuple(
            x * torch.tensor([1.0, 0.0] * (x.shape[0] // 2), dtype=x.dtype)
            [:, None, None] for x in fn(*a, **k))},
        grad_a={"nt_setup": lambda fn: lambda M, a, *r: fn(
            M, _GradTimes.apply(a), *r)},
        grad_incl={"render": lambda fn: lambda disk, incl, *r: fn(
            disk, _GradTimes.apply(incl), *r)}),
    "spot_volume_512": {
        "altered": {"volume_image": lambda fn: lambda *a, **k: scaled(
            fn(*a, **k))},
        "half": {"volume_image": lambda fn: lambda *a, **k: half_dark(
            fn(*a, **k))}},
    "spot_lightcurve_512": {
        "altered": {"lightcurve": lambda fn: lambda *a, **k: scaled(
            fn(*a, **k))},
        "half": {"lightcurve": lambda fn: lambda *a, **k: fn(
            *a, **dict(k, n_orders=1))}},
}


@pytest.mark.parametrize("workload,fault", [
    (w, f) for w in WORKLOADS for f in FAULTS[w]])
def test_broken_timed_path_is_not_correct(capsys, checkout, monkeypatch,
                                          workload, fault):
    reg = Registry.load(checkout)
    entry = reg.entry(reg.traffic(reg.workload(workload)["traffic"])
                      ["entry"])
    setup = entry.setup

    def broken(cfg, mix, dev):
        state = setup(cfg, mix, dev)
        for key, wrap in FAULTS[workload][fault].items():
            state[key] = wrap(state[key])
        return state

    monkeypatch.setattr(entry, "setup", broken)
    monkeypatch.setattr(harness, "Registry", _Same(reg))
    line = result(capsys, checkout, workload)
    assert not line["correct"], line["checks"]


class _Same:
    """Registry.load returning one registry, whose entry was patched."""

    def __init__(self, reg):
        self.reg = reg

    def load(self, root):
        return self.reg
