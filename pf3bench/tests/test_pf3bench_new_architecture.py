"""Adding a model architecture takes only new files: a throwaway
architecture, a configuration that names it, a traffic mix, a loop and a
metric reader dropped into a copy of the benchmark, with entries added to
its BENCHMARK.json, are run, checked and counted by the unchanged harness
without PF3plat being built; a configuration naming an architecture with
no file is refused. PF3plat's own path (no `architecture` key) builds the
same program, weights and cache entry as before the lookup existed."""

import hashlib
import json

import pytest
import torch
from pf3bench_tiny import TINY, write_tiny

from pf3bench import flops, harness, inputs
from pf3bench.run import run_cell
from pf3bench.spec import Benchmark

SEED = 2**31 + 77
CPU = torch.device("cpu")
WIDTHS = [12, 24, 6]
# PF3plat's tiny tree with the throwaway's widths beside it, so that both
# architectures can take their leaf statistics from the one tree
MLP_TREE = dict(TINY, mlp={"widths": WIDTHS})

MLP = '''"""`mlp`: a few linear layers; the program and the reference are the
same module."""
import contextlib

import torch


class MLP(torch.nn.Module):
    def __init__(self, widths):
        super().__init__()
        self.layers = torch.nn.ModuleList(
            torch.nn.Linear(a, b) for a, b in zip(widths, widths[1:]))

    def forward(self, x):
        for i, layer in enumerate(self.layers):
            x = layer(x) if i == 0 else layer(torch.relu(x))
        return x


def build_program(tree, device):
    return dict(tree), MLP(tree["mlp"]["widths"]).to(device)


def build_reference(tree, device):
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        return MLP(tree["mlp"]["widths"]).to(device)


def reference_precision():
    return contextlib.nullcontext()
'''

ROWS = '''"""`rows`: batches of seeded rows through the model, back to back;
`fault="answer"` alters each answer where it is produced."""
import math
import time
from pathlib import Path

import torch
from torch.utils.flop_counter import FlopCounterMode

from pf3bench import check, harness, inputs, spec


def batch(traffic, seed, i):
    gen = torch.Generator().manual_seed(inputs.torch_seed(seed, inputs.SCENES, i))
    return torch.randn(traffic["batch"], traffic["width"], generator=gen)


def run(prog, traffic, seed, seconds, trace_dir, data_dir, fault=None):
    checked = {}

    def one(i):
        x = batch(traffic, seed, i)
        with torch.no_grad():
            y = prog.model(x.to(prog.device))
        if fault == "answer":
            y = y + 0.01
        if i < traffic["check_batches"]:
            checked[i] = harness.host(y)

    setup_done = time.perf_counter()
    return dict(setup_done=setup_done, **harness.Window(prog.device).run(one, seconds),
                checked=checked)


def gaps(tree, rec, prog_stats, seed, device, traffic, subject="program", detail=None):
    arch = spec.load_module(Path(__file__).parents[1] / "architectures" / "mlp.py",
                            "pf3bench_architecture")
    ref = arch.build_reference(tree, device)
    inputs.load_weights(ref, inputs.make_weights(prog_stats, seed, device))
    worst = 0.0
    with torch.no_grad():
        for i, y in rec["checked"].items():
            worst = max(worst, check.rel(y, ref(batch(traffic, seed, i).to(device))))
    return {"output": worst if rec["checked"] else math.inf}


def work(ref, tree, traffic, device):
    with FlopCounterMode(display=False) as fc:
        ref(torch.zeros(traffic["batch"], traffic["width"], device=device))
    return {"model_flops": fc.get_total_flops()}
'''

ROW_US = '''"""row_us.mlp: the window's wall time a row."""


def read(run):
    rec = run["record"]
    return 1e6 * rec["window_s"] / rec["count"] / run["traffic"]["batch"]
'''


def add_mlp_cell(root, architecture="mlp"):
    """The throwaway cell `mlp.rows` in the benchmark copy at `root`, its
    configuration naming `architecture`; only new files and new entries."""
    here = root / "pf3bench"
    (here / "architectures" / "mlp.py").write_text(MLP)
    (here / "loops" / "rows.py").write_text(ROWS)
    (here / "metrics" / "row_us.mlp.py").write_text(ROW_US)
    (here / "configs" / "mlp.json").write_text(json.dumps(
        {"architecture": architecture, "config": MLP_TREE}))
    (here / "traffic" / "rows.json").write_text(json.dumps(
        {"kind": "rows", "batch": 16, "width": WIDTHS[0], "check_batches": 3}))
    (here / "cells" / "mlp.rows.json").write_text(json.dumps({"limits": {"output": 1e-6}}))
    data = json.loads((root / "BENCHMARK.json").read_text())
    data["configs"].append({"name": "mlp", "source": "https://arxiv.org/abs/1706.03762",
                            "file": "pf3bench/configs/mlp.json", "reduced": [],
                            "why": "test"})
    data["workloads"].append({"name": "mlp.rows", "config": "mlp", "traffic": "rows",
                              "chips": 1, "why": "test"})
    data["end_to_end"].append({"name": "row_us.mlp", "unit": "us", "better": "lower",
                               "bound": 0.25, "source": "host_clock",
                               "workloads": ["mlp.rows"]})
    (root / "BENCHMARK.json").write_text(json.dumps(data))
    return Benchmark(root, here)


def legacy_key(tree):
    """The leaf-statistics cache key of a configuration before it could
    name an architecture."""
    return hashlib.sha256(json.dumps(tree, sort_keys=True).encode()).hexdigest()[:16]


def test_new_files_make_a_new_architecture(tmp_path, monkeypatch):
    import pf3plat_tpu_torch.models.pf3plat as port

    import pf3bench.reference.models.pf3plat as reference

    def refuse(*args, **kwargs):
        raise AssertionError("PF3plat was built for another architecture")

    monkeypatch.setattr(port.PF3plat, "__init__", refuse)
    monkeypatch.setattr(reference.PF3plat, "__init__", refuse)
    bench = add_mlp_cell(write_tiny(tmp_path))
    out = tmp_path / "out"

    r = run_cell(bench, "mlp.rows", SEED, 0.3, False, CPU, out=out)
    assert r["correct"], r["checks"]
    assert set(r["checks"]) == {"output"} and r["checks"]["output"]["value"] < 1e-6
    assert set(r["metrics"]) == {"setup_s", "row_us.mlp"}
    assert r["metrics"]["row_us.mlp"]["value"] > 0 and r["attempted"] >= 1
    bad = run_cell(bench, "mlp.rows", SEED, 0.3, False, CPU, fault="answer", out=out)
    assert not bad["correct"], bad["checks"]

    got = flops.count(bench, "mlp.rows", CPU)
    assert got == {"model_flops": 2 * 16 * sum(a * b for a, b in zip(WIDTHS, WIDTHS[1:]))}

    mlp = bench.architecture("mlp")
    mlp_key = hashlib.sha256(json.dumps({"architecture": "mlp", "config": MLP_TREE},
                                        sort_keys=True).encode()).hexdigest()[:16]
    assert [p.name for p in (out / "stats").iterdir()] == [f"{mlp_key}.json"]
    monkeypatch.undo()
    pf3plat = harness.leaf_statistics(bench.architecture("tiny"), MLP_TREE, CPU, out / "stats")
    assert sorted(p.name for p in (out / "stats").iterdir()) == sorted(
        [f"{mlp_key}.json", f"{legacy_key(MLP_TREE)}.json"])
    assert harness.leaf_statistics(mlp, MLP_TREE, CPU, out / "stats").keys() != pf3plat.keys()


def test_an_architecture_without_a_file_is_refused(tmp_path):
    bench = add_mlp_cell(write_tiny(tmp_path), architecture="no_such_architecture")
    with pytest.raises(FileNotFoundError, match="no_such_architecture"):
        bench.architecture("mlp")
    with pytest.raises(FileNotFoundError, match="no_such_architecture"):
        run_cell(bench, "mlp.rows", SEED, 0.3, False, CPU, out=tmp_path / "out")


def test_pf3plat_program_is_unchanged(tiny, tmp_path):
    """The tiny configuration, which names no architecture: the program's
    parameters and the seed's weights, name for name and bit for bit, as
    the port's model built directly and loaded from the statistics of the
    reference, and the cache entry keyed by the tree alone."""
    from pf3plat_tpu_torch.main import model_config
    from pf3plat_tpu_torch.models.pf3plat import PF3plat
    from pf3plat_tpu_torch.utils.config import load_config

    from pf3bench.reference.models.pf3plat import PF3plat as Reference

    arch = tiny.architecture("tiny")
    prog = harness.Program(arch, TINY, CPU, SEED, tmp_path)
    direct = PF3plat(model_config(load_config(None, harness.overrides(TINY))), device=CPU)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        ref = Reference(arch.model_cfg(TINY), device=CPU)
    inputs.load_weights(direct, inputs.make_weights(inputs.leaf_statistics(ref), SEED, CPU))
    got, want = list(prog.model.named_parameters()), list(direct.named_parameters())
    assert [n for n, _ in got] == [n for n, _ in want]
    assert all(torch.equal(a, b) for (_, a), (_, b) in zip(got, want))
    assert type(prog.model) is PF3plat and prog.cfg.model.max_keypoints == 64
    assert [p.name for p in tmp_path.iterdir()] == [f"{legacy_key(TINY)}.json"]
