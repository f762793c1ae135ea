"""Adding a cell takes only new files: a throwaway configuration, traffic
mix, loop and metric reader dropped into a copy of the benchmark, and
entries added to its BENCHMARK.json, are listed and run by the unchanged
harness; a traffic kind with no loop file is refused. A cell added so to
a copy of the real benchmark, and listed in its existing metrics, leaves
every file there as it was and the CPU tests' tiny benchmark as it was."""

import json
import shutil

import pytest
from pf3bench_tiny import ROOT, TINY, TRAFFIC, write_tiny
from test_pf3bench_new_architecture import CPU, SEED, add_mlp_cell

from pf3bench.run import run_cell
from pf3bench.spec import Benchmark

# a new kind of loop: the encoder's poses alone, no view rendered
POSES_ONLY = '''"""`poses_only`: requests answered by the refined poses alone."""
from pf3bench import harness


def run(prog, traffic, seed, seconds, trace_dir, data_dir, fault=None):
    def respond(model, args, gen, clock):
        enc, _ = model(*args, 0, render_views=False, generator=gen, timer=clock)
        return enc, dict(refined_poses=enc.refined_poses.cpu().numpy())

    return harness.serve(prog, traffic, seed, seconds, trace_dir, respond)


def gaps(tree, rec, prog_stats, seed, device, traffic, subject="program", detail=None):
    return harness.serve_gaps(tree, rec, prog_stats, seed, device, subject,
                              lambda *a: {}, (None, None), detail)
'''


def _add_cell(data, name, config, traffic):
    data["workloads"].append({"name": name, "config": config, "traffic": traffic, "chips": 1,
                              "why": "test"})


def test_new_files_make_a_new_cell(tmp_path):
    root = write_tiny(tmp_path)
    here = root / "pf3bench"
    config = dict(TINY, model=dict(TINY["model"], max_matches=16))
    (here / "configs" / "throwaway.json").write_text(json.dumps({"config": config}))
    (here / "traffic" / "three_views.json").write_text(json.dumps(
        dict(TRAFFIC["tserve"], views=3, shift=3)))
    (here / "traffic" / "poses.json").write_text(json.dumps(
        dict(TRAFFIC["tserve"], kind="poses_only")))
    (here / "loops" / "poses_only.py").write_text(POSES_ONLY)
    (here / "metrics" / "views_seen.serve.py").write_text(
        '"""views_seen.serve: views a request carries (a count)."""\n\n\n'
        'def read(run):\n    return float(run["traffic"]["views"])\n')
    data = json.loads((root / "BENCHMARK.json").read_text())
    data["configs"].append({"name": "throwaway", "source": "https://arxiv.org/abs/2410.22128",
                            "file": "pf3bench/configs/throwaway.json", "reduced": [],
                            "why": "test"})
    _add_cell(data, "throwaway.three_views", "throwaway", "three_views")
    _add_cell(data, "throwaway.poses", "throwaway", "poses")
    data["per_layer"].append({"name": "views_seen.serve", "unit": "views", "better": "higher",
                              "source": "program_counter", "layer": "traffic",
                              "moves": "request_ms",
                              "workloads": ["throwaway.three_views", "throwaway.poses"]})
    (root / "BENCHMARK.json").write_text(json.dumps(data))

    bench = Benchmark(root, here)
    assert "views_seen.serve" in {m["name"] for m in bench.metrics("throwaway.three_views", True)}
    r = run_cell(bench, "throwaway.three_views", 7, 0.3, True, "cpu", out=tmp_path / "out")
    assert r["metrics"]["views_seen.serve"]["value"] == 3.0
    assert set(r["checks"]) == {"perceive", "keypoints", "lightglue", "means", "covariances",
                                "opacities", "harmonics", "color"}
    r = run_cell(bench, "throwaway.poses", 7, 0.3, True, "cpu", out=tmp_path / "out")
    assert r["metrics"]["views_seen.serve"]["value"] == 5.0
    assert "color" not in r["checks"] and "harmonics" in r["checks"]


def test_a_kind_without_a_loop_is_refused(tiny):
    with pytest.raises(FileNotFoundError, match="no_such_kind"):
        tiny.loop("no_such_kind")


def _files(here):
    return {p.relative_to(here): p.read_bytes() for p in sorted(here.rglob("*"))
            if p.is_file() and "__pycache__" not in p.parts}


def _listed(root):
    data = json.loads((root / "BENCHMARK.json").read_text())
    return {m["name"]: m.get("workloads") for m in data["end_to_end"] + data["per_layer"]}


def test_a_real_cell_is_new_files_and_entries(tmp_path):
    """The throwaway `mlp.rows` cell (a new architecture, loop kind, cell
    file and metric readers) added to a copy of the real benchmark, listed
    in `request_ms`, `request_ms_p90` and a new per-layer metric."""
    root = tmp_path / "checkout"
    shutil.copytree(ROOT / "pf3bench", root / "pf3bench",
                    ignore=shutil.ignore_patterns("__pycache__", "out"))
    shutil.copy(ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    repo = {k: v for k, v in _files(ROOT / "pf3bench").items() if k.parts[0] != "out"}
    add_mlp_cell(root)
    (root / "pf3bench" / "metrics" / "rows_a_request.mlp.py").write_text(
        '"""rows_a_request.mlp: rows a request carries (a count)."""\n\n\n'
        'def read(run):\n    return float(run["traffic"]["batch"])\n')
    data = json.loads((root / "BENCHMARK.json").read_text())
    for m in data["end_to_end"]:
        if m["name"] in ("request_ms", "request_ms_p90"):
            m["workloads"].append("mlp.rows")
    data["per_layer"].append({"name": "rows_a_request.mlp", "unit": "rows", "better": "higher",
                              "source": "program_counter", "layer": "traffic",
                              "moves": "request_ms", "workloads": ["mlp.rows"]})
    (root / "BENCHMARK.json").write_text(json.dumps(data))

    tiny = _listed(write_tiny(tmp_path / "tiny", source=root))
    assert tiny == dict(_listed(write_tiny(tmp_path / "base")), **{
        "row_us.mlp": [], "rows_a_request.mlp": []})
    assert tiny["request_ms"] == tiny["request_ms_p90"] == ["tiny.tserve"]

    bench = Benchmark(root, root / "pf3bench")
    out = tmp_path / "out"
    r = run_cell(bench, "mlp.rows", SEED, 0.3, False, CPU, out=out)
    assert r["correct"], r["checks"]
    assert set(r["metrics"]) == {"setup_s", "request_ms", "request_ms_p90", "row_us.mlp"}
    assert all(m["value"] > 0 for m in r["metrics"].values())
    r = run_cell(bench, "mlp.rows", SEED, 0.3, True, CPU, out=out)
    assert r["correct"], r["checks"]
    assert r["metrics"] == {"rows_a_request.mlp": {"value": 16.0, "unit": "rows"}}

    assert {k: v for k, v in _files(root / "pf3bench").items() if k in repo} == repo
