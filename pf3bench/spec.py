"""The benchmark as data: `BENCHMARK.json` names the cells and metrics, and
the harness finds everything that belongs to one of them by its name:

- a configuration's file is `BENCHMARK.json`'s `file` (`configs/<name>.json`);
- an architecture is `architectures/<name>.py`, named by the configuration
  file's `architecture`, `pf3plat` when absent; it exports `build_program`
  (the port's config and model, before the seed's weights), `build_reference`
  (the plain float32 reference, from its own default initialisation) and
  `reference_precision` (the context the reference runs in);
- a traffic mix is `traffic/<traffic>.json`, data that names its loop
  (`kind`) and the loop's parameters;
- a loop is `loops/<kind>.py`, which exports `run` (set-up, the timed
  window and the profiled sub-window of one run), `gaps` (the numbers the
  check compares) and `work` (the FLOPs and attention calls of one request
  or step, counted over the reference);
- a cell's work counts and the limits of its check are `cells/<workload>.json`;
- a metric's reader is `metrics/<metric>.py`, whose `read(run)` returns the
  metric's value or None where the run has nothing for it to read.

A later cell, metric or model architecture is new files here and new
entries there.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
DEFAULT_ARCHITECTURE = "pf3plat"


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


class Benchmark:
    def __init__(self, root: Path = ROOT, here: Path = HERE):
        self.root, self.here = root, here
        self.data = load_json(root / "BENCHMARK.json")

    def cell(self, workload: str) -> dict:
        for c in self.data["workloads"]:
            if c["name"] == workload:
                return c
        raise KeyError(f"BENCHMARK.json has no workload {workload!r}")

    def config(self, name: str) -> dict:
        for c in self.data["configs"]:
            if c["name"] == name:
                return load_json(self.root / c["file"])
        raise KeyError(f"BENCHMARK.json has no config {name!r}")

    def architecture(self, config: str):
        """The architecture module that the configuration `config` names."""
        name = self.config(config).get("architecture", DEFAULT_ARCHITECTURE)
        return load_module(self.here / "architectures" / f"{name}.py", "pf3bench_architecture")

    def traffic(self, name: str) -> dict:
        return load_json(self.here / "traffic" / f"{name}.json")

    def work(self, workload: str) -> dict:
        path = self.here / "cells" / f"{workload}.json"
        return load_json(path) if path.exists() else {}

    def metrics(self, workload: str, trace: bool) -> list[dict]:
        """The metrics a run of `workload` reports: the end-to-end ones
        untraced, the per-layer ones traced; each where its `workloads`
        (if any) list the cell."""
        group = self.data["per_layer" if trace else "end_to_end"]
        return [m for m in group if "workloads" not in m or workload in m["workloads"]]

    def reader(self, metric: str):
        return load_module(self.here / "metrics" / f"{metric}.py", "pf3bench_metric").read

    def loop(self, kind: str):
        """The loop module of a traffic `kind`."""
        return load_module(self.here / "loops" / f"{kind}.py", "pf3bench_loop")


_LOADED: dict = {}


def load_module(path: Path, prefix: str):
    """The module in the file `path` (its name may hold dots), loaded once."""
    if not path.is_file():
        raise FileNotFoundError(f"pf3bench has no {path.parent.name[:-1]} {path.stem!r}: "
                                f"{path} is missing")
    if path not in _LOADED:
        spec = importlib.util.spec_from_file_location(f"{prefix}_{path.stem}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _LOADED[path] = mod
    return _LOADED[path]
