"""What the harness finds by name: the cell in ``BENCHMARK.json``, its
configuration (the entry's ``file``, under ``configs/``), its traffic
(``traffic/<traffic>.json``), its limits (``limits/<cell>.json``), each
metric's reader (``metrics/<metric>.py``) and the kernel or op names a
reader reads (``names/<metric>/*.txt``, one name per file). Adding any
of them is adding a file; nothing here lists them."""

from __future__ import annotations

import glob
import importlib.util
import json
import os

HERE = os.path.dirname(os.path.abspath(__file__))


class Spec:
    def __init__(self, root=None):
        self.root = root or os.path.dirname(HERE)
        self.here = os.path.join(self.root, "portbench")
        with open(os.path.join(self.root, "BENCHMARK.json")) as f:
            self.bench = json.load(f)

    def _json(self, *parts):
        with open(os.path.join(self.here, *parts)) as f:
            return json.load(f)

    def cell(self, name):
        for w in self.bench["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name):
        for c in self.bench["configs"]:
            if c["name"] == name:
                with open(os.path.join(self.root, c["file"])) as f:
                    out = json.load(f)
                out["name"] = name
                return out
        raise KeyError(f"no config {name!r} in BENCHMARK.json")

    def traffic(self, name):
        return self._json("traffic", f"{name}.json")

    def limits(self, cell):
        return self._json("limits", f"{cell}.json")

    def metrics(self, cell, trace):
        """The metric entries a run of ``cell`` reports: its end-to-end
        metrics untraced, its per-layer metrics traced; an entry with a
        ``workloads`` key only in the cells it lists."""
        group = self.bench["per_layer" if trace else "end_to_end"]
        return [m for m in group
                if "workloads" not in m or cell in m["workloads"]]

    def names(self, metric):
        out = []
        for path in sorted(glob.glob(os.path.join(self.here, "names", metric,
                                                  "*.txt"))):
            with open(path) as f:
                out.extend(line.strip() for line in f if line.strip())
        return out

    def reader(self, metric):
        path = os.path.join(self.here, "metrics", f"{metric}.py")
        spec = importlib.util.spec_from_file_location(
            f"portbench_metric_{metric.replace('.', '_')}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod.read

    def peaks(self):
        return self._json("peaks.json")
