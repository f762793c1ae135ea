"""VGGT's serving cell on a tiny copy of the benchmark: its architecture,
loop and readers as the repository has them, run, checked, faulted and
counted by the unchanged harness at 3 frames of 28 x 42 on the CPU; the
reference is the same model as the program (its parameters load by name
both ways)."""

import json

import pytest
import torch
from pf3bench_tiny import K, ROOT, write_tiny

from pf3bench import flops, harness, inputs
from pf3bench.run import run_cell

SEED = 2**31 + 97
CPU = torch.device("cpu")
# the aggregator's LayerScale at 1.0, as `tests/test_torch_vggt.py` draws it
VGGT = {
    "mode": "test",
    "model": {"architecture": "vggt"},
    "vggt": {"img_size": 56, "embed_dim": 64, "patch_embed_depth": 2, "depth": 2,
             "num_heads": 4, "hooks": [0, 1, 1, 1], "camera_num_heads": 4,
             "dpt_features": 16, "dpt_out_channels": [8, 16, 32, 32], "frames_chunk_size": 2,
             "init_values": 1.0},
}
FRAMES, P = 3, 5 + 2 * 3
TRAFFIC = {"kind": "vggt_serve", "views": FRAMES, "image": [28, 42], "shift": 2, "intrinsics": K,
           "near": 1.0, "far": 100.0, "pool": 2, "warmup_requests": 1, "check_requests": 1,
           "profile_requests": 1}
CELL = "tvggt.t3"
# Far above what the sound tiny run reads (the port's CPU attention rounds
# to bf16: <= 1.5e-3 on the tokens, <= 1e-5 on the poses; its float32 heads
# read 0 on the maps, in units of the reference's own gap in bfloat16) and
# below what each planted fault and the control read (>= 0.058 on the
# tokens, >= 1.8e-3 on the poses, 1 on the maps by construction)
LIMITS = {"tokens": 1e-2, "poses": 1e-3, "depth": 0.5, "depth_conf": 0.5, "points": 0.5,
          "points_conf": 0.5}
NEW = ("patch_ms.vggt", "aggregator_ms.vggt", "camera_ms.vggt", "dpt_ms.vggt")


def add_vggt_cell(root):
    from pf3bench.spec import Benchmark

    here = root / "pf3bench"
    (here / "configs" / "tvggt.json").write_text(json.dumps(
        {"architecture": "vggt", "config": VGGT}))
    (here / "traffic" / "t3.json").write_text(json.dumps(TRAFFIC))
    (here / "cells" / f"{CELL}.json").write_text(json.dumps({"limits": LIMITS}))
    data = json.loads((root / "BENCHMARK.json").read_text())
    data["configs"].append({"name": "tvggt", "source": "https://arxiv.org/abs/2503.11651",
                            "file": "pf3bench/configs/tvggt.json", "reduced": [], "why": "tests"})
    data["workloads"].append({"name": CELL, "config": "tvggt", "traffic": "t3", "chips": 1,
                              "why": "tests"})
    real = json.loads((ROOT / "BENCHMARK.json").read_text())
    listed = {m["name"] for m in real["end_to_end"] + real["per_layer"]
              if "vggt-serve.v48" in m.get("workloads", [])}
    for m in data["end_to_end"] + data["per_layer"]:
        if m["name"] in listed:
            m["workloads"].append(CELL)
    (root / "BENCHMARK.json").write_text(json.dumps(data))
    return Benchmark(root, here)


@pytest.fixture(scope="module")
def vggt(tmp_path_factory):
    root = tmp_path_factory.mktemp("vggt")
    return add_vggt_cell(write_tiny(root)), root / "out"


def test_real_cell_lists_the_new_readers():
    real = json.loads((ROOT / "BENCHMARK.json").read_text())
    listed = {m["name"] for m in real["end_to_end"] + real["per_layer"]
              if "vggt-serve.v48" in m.get("workloads", [])}
    assert listed == {"request_ms", "request_ms_p90", "attn_roofline.serve", "idle_share.serve",
                      "mfu.serve", "peak_gb.serve", "host_syncs.serve", *NEW}


@pytest.mark.parametrize("trace", [False, True], ids=["untraced", "traced"])
def test_cell_runs_and_is_correct(vggt, trace):
    bench, out = vggt
    r = run_cell(bench, CELL, SEED, 0.2, trace, CPU, out=out)
    assert r["correct"], r["checks"]
    assert set(r["checks"]) == set(LIMITS)
    if trace:
        # every stage reader has a value (the span readers look for the trace
        # under the repository's own `pf3bench/out`, and read none here)
        assert set(NEW) <= set(r["metrics"]) and all(r["metrics"][k]["value"] > 0 for k in NEW)
    else:
        assert set(r["metrics"]) == {"setup_s", "request_ms", "request_ms_p90"}
    assert r["info"]["global_tokens"] == FRAMES * P and r["attempted"] >= 1


@pytest.mark.parametrize("fault", ["answer", "frame_only", "control"])
def test_faults_and_the_control_fail_the_check(vggt, fault):
    bench, out = vggt
    if fault == "control":
        r = run_cell(bench, CELL, SEED, 0.05, False, CPU, out=out, subjects=("control",))
        control = r["subjects"]["control"]
        assert any(control[k] > LIMITS[k] for k in control), control
    else:
        bad = run_cell(bench, CELL, SEED, 0.05, False, CPU, fault=fault, out=out)
        assert not bad["correct"], bad["checks"]


def test_flops_and_attention_calls(vggt):
    """A request: 2 patch-embedding blocks and 2 frame blocks over the 3
    frames, 2 global calls over all 3 frames' tokens, 4 x 4 camera trunk
    calls over the 3 camera tokens; the global calls whole, whatever the
    reference's blocks of query rows."""
    bench, _ = vggt
    got = flops.count(bench, CELL, CPU)
    assert got["model_flops"] > 0
    calls = {(c["b"], c["n"], c["m"], c["d"]): c["count"] for c in got["attention_calls"]}
    h = VGGT["vggt"]["num_heads"]
    assert calls == {(FRAMES * h, P, P, 16): 4, (h, FRAMES * P, FRAMES * P, 16): 2,
                     (h, FRAMES, FRAMES, 32): 16}


def test_global_calls_merge_from_row_blocks(vggt):
    bench, _ = vggt
    loop = bench.loop("vggt_serve")
    rows = [dict(b=16, h=1, n=4096, m=37536, d=64, count=9 * 24),
            dict(b=16, h=1, n=672, m=37536, d=64, count=24),
            dict(b=768, h=1, n=782, m=782, d=64, count=48)]
    assert loop.merge_row_blocks(rows) == [dict(b=16, h=1, n=37536, m=37536, d=64, count=24),
                                           rows[2]]


def test_program_is_the_reference_model(vggt, tmp_path):
    from pf3plat_tpu_torch.models.vggt import VGGT as PortVGGT

    bench, _ = vggt
    arch = bench.architecture("tvggt")
    prog = harness.Program(arch, VGGT, CPU, SEED, tmp_path)
    ref = arch.build_reference(VGGT, CPU)
    assert type(prog.model) is PortVGGT
    assert sorted((n, p.shape) for n, p in prog.model.named_parameters()) == \
        sorted((n, p.shape) for n, p in ref.named_parameters())
    inputs.load_weights(ref, dict(prog.model.named_parameters()))
