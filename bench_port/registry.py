"""Find a benchmark's pieces by name.

Everything that belongs to one configuration, traffic mix, cell, entry,
per-layer metric or kernel's work is a file of its own under the
benchmark's folder, named as `BENCHMARK.json` names it:

    configs/<config>.json     the configuration (the file BENCHMARK.json
                              gives)
    traffic/<traffic>.json    the mix, read by traffic.py
    cells/<workload>.json     the cell: its expected kernels, the sample
                              it judges and the limits of each number
    entries/<entry>.py        the calls into the port and their judge
    metrics/<metric>.py       a per-layer metric's reader
    work/<kernel>.json        a kernel's frozen work a unit

So a later change adds a cell, a mix, a metric or a configuration as new
files and new entries of BENCHMARK.json, and edits no file that is there.
"""

import importlib.util
import json
import pathlib
import sys

HERE = pathlib.Path(__file__).resolve().parent


class Registry:
    """The pieces of the benchmark whose description is `bench` (the
    parsed BENCHMARK.json) and whose files lie under `folder` (its first
    path, resolved)."""

    def __init__(self, bench, folder=HERE):
        self.bench = bench
        self.folder = pathlib.Path(folder)
        self._modules = {}

    @classmethod
    def load(cls, root):
        """The registry of the checkout at `root`."""
        root = pathlib.Path(root)
        bench = json.loads((root / "BENCHMARK.json").read_text())
        return cls(bench, root / bench["paths"][0])

    def _named(self, key, name):
        for item in self.bench[key]:
            if item["name"] == name:
                return item
        raise KeyError(f"no {key} entry named {name!r} in BENCHMARK.json")

    def workload(self, name):
        return self._named("workloads", name)

    def config(self, name):
        """The configuration's entry of BENCHMARK.json and its file."""
        entry = self._named("configs", name)
        path = self.folder.parent / entry["file"]
        return entry, json.loads(path.read_text())

    def json(self, kind, name):
        return json.loads((self.folder / kind / f"{name}.json").read_text())

    def traffic(self, name):
        return self.json("traffic", name)

    def cell(self, name):
        return self.json("cells", name)

    def work(self, name):
        return self.json("work", name)

    def module(self, kind, name):
        """The module `<kind>/<name>.py`, loaded once."""
        key = (kind, name)
        if key not in self._modules:
            path = self.folder / kind / f"{name}.py"
            mod_name = f"bench_port_{kind}_{name}".replace(".", "_")
            spec = importlib.util.spec_from_file_location(mod_name, path)
            if spec is None or not path.exists():
                raise KeyError(f"no {kind[:-1]} {name!r}: {path} is missing")
            mod = importlib.util.module_from_spec(spec)
            sys.modules[mod_name] = mod
            spec.loader.exec_module(mod)
            self._modules[key] = mod
        return self._modules[key]

    def entry(self, name):
        return self.module("entries", name)

    def metric(self, name):
        return self.module("metrics", name)

    def per_layer(self, workload):
        """The per-layer metrics of BENCHMARK.json that `workload` reports:
        those whose `workloads` list it, or that have no such list and move
        an end-to-end metric the workload reports."""
        reported = {m["name"] for m in self.end_to_end(workload)}
        return [m for m in self.bench["per_layer"]
                if (workload in m["workloads"] if "workloads" in m
                    else m["moves"] in reported)]

    def end_to_end(self, workload):
        return [m for m in self.bench["end_to_end"]
                if workload in m.get("workloads", [workload])]
