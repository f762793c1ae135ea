"""NoPoSplat's cell on a tiny copy of the benchmark: its architecture, loop
and readers as the repository has them, run, checked, faulted and counted by
the unchanged harness at 32 x 32 on the CPU; the reference is the same
model as the program (its parameters load by name both ways), and PF3plat's
tiny program still builds bit for bit beside it."""

import json

import pytest
import torch
from pf3bench_tiny import K, LIMITS, ROOT, TINY, write_tiny

from pf3bench import flops, harness, inputs
from pf3bench.run import run_cell
from pf3bench.spec import Benchmark

SEED = 2**31 + 91
CPU = torch.device("cpu")
NOPO = {
    "model": {"architecture": "noposplat"},
    "noposplat": {"enc_embed_dim": 64, "enc_depth": 2, "enc_num_heads": 4, "dec_embed_dim": 48,
                  "dec_depth": 2, "dec_num_heads": 4, "dpt_hooks": [1, 2, 2],
                  "dpt_layer_dims": [8, 16, 32, 64], "dpt_feature_dim": 32, "dpt_last_dim": 16,
                  "centre_prior_depth": 4.0, "gaussian_adapter": {"sh_degree": 1}},
    "dataset": {"roots": [], "image_shape": [32, 32], "original_image_shape": [72, 128]},
    "view_sampler": {"num_target_views": 4, "min_distance_between_context_views": 12,
                     "max_distance_between_context_views": 12},
    "loss": {"mse_weight": 1.0, "lpips_weight": 0.05},
}
TRAFFIC = {"kind": "nopo_train", "batch": 2, "views": 6, "chunks": 1, "scenes_per_chunk": 2,
           "frames": 16, "frame_shape": [72, 128], "shift": 2, "jpeg_quality": 90,
           "intrinsics": K, "pool": 2, "check_steps": 3, "profile_steps": 1}
CELL = "tnopo.tb2v6"
# the tiny training cells' limits (pf3bench_tiny.LIMITS): the sound run
# reads <= 1e-4 on the loss and <= 0.02 on any leaf here (the port's CPU
# attention rounds to bf16), each planted fault and the control above them
NOPO_LIMITS = {k: LIMITS[k] for k in ("loss", "grad", "update", "update_median")}


def add_nopo_cell(root):
    here = root / "pf3bench"
    (here / "configs" / "tnopo.json").write_text(json.dumps(
        {"architecture": "noposplat", "config": NOPO}))
    (here / "traffic" / "tb2v6.json").write_text(json.dumps(TRAFFIC))
    (here / "cells" / f"{CELL}.json").write_text(json.dumps({"limits": NOPO_LIMITS}))
    data = json.loads((root / "BENCHMARK.json").read_text())
    data["configs"].append({"name": "tnopo", "source": "https://arxiv.org/abs/2410.24207",
                            "file": "pf3bench/configs/tnopo.json", "reduced": [], "why": "tests"})
    data["workloads"].append({"name": CELL, "config": "tnopo", "traffic": "tb2v6", "chips": 1,
                              "why": "tests"})
    real = json.loads((ROOT / "BENCHMARK.json").read_text())
    listed = {m["name"] for m in real["end_to_end"] + real["per_layer"]
              if "noposplat-train.b14v6" in m.get("workloads", [])}
    for m in data["end_to_end"] + data["per_layer"]:
        if m["name"] in listed:
            m["workloads"].append(CELL)
    (root / "BENCHMARK.json").write_text(json.dumps(data))
    return Benchmark(root, here)


@pytest.fixture(scope="module")
def nopo(tmp_path_factory):
    root = tmp_path_factory.mktemp("nopo")
    return add_nopo_cell(write_tiny(root)), root / "out"


def test_cell_runs_and_is_correct(nopo):
    bench, out = nopo
    look = {}
    r = run_cell(bench, CELL, SEED, 0.2, False, CPU, out=out, subjects=("control",), look=look)
    assert r["correct"], r["checks"]
    assert set(r["checks"]) == {"loss", "grad", "update", "update_median"}
    assert r["metrics"].keys() == {"setup_s", "step_ms"}
    assert r["info"]["parameters"] == sum(
        n for n in look["program"]["leaves"]["numel"]) and r["attempted"] >= 1
    control = r["subjects"]["control"]
    assert any(control[k] > NOPO_LIMITS[k] for k in control), control


@pytest.mark.parametrize("fault", ["unchanged", "half_batch"])
def test_planted_faults_fail_the_check(nopo, fault):
    bench, out = nopo
    bad = run_cell(bench, CELL, SEED, 0.05, False, CPU, fault=fault, out=out)
    assert not bad["correct"], bad["checks"]


def test_flops_and_attention_calls(nopo):
    bench, _ = nopo
    got = flops.count(bench, CELL, CPU)
    assert got["model_flops"] > 0
    # a step's forward: 2 encoder blocks over 2b views, 2 x 2 decoder blocks
    # with a self- and a cross-attention each, at 2 x 2 + 1 tokens
    calls = got["attention_calls"]
    assert sum(c["count"] for c in calls) == 2 + 2 * 2 * 2
    assert {(c["n"], c["m"], c["d"]) for c in calls} == {(5, 5, 16), (5, 5, 12)}
    assert sum(c["b"] * c["count"] for c in calls if c["d"] == 16) == 2 * 2 * 2 * 4


def test_program_is_the_reference_model(nopo, tmp_path):
    """The program's parameters, names and shapes, are the reference's, and
    the seed's weights load into both; PF3plat's tiny program (a
    configuration that names no architecture) builds as before."""
    from pf3plat_tpu_torch.main import model_config
    from pf3plat_tpu_torch.models.noposplat import NoPoSplat
    from pf3plat_tpu_torch.models.pf3plat import PF3plat
    from pf3plat_tpu_torch.utils.config import load_config

    bench, _ = nopo
    arch = bench.architecture("tnopo")
    prog = harness.Program(arch, NOPO, CPU, SEED, tmp_path)
    ref = arch.build_reference(NOPO, CPU)
    assert type(prog.model) is NoPoSplat
    assert [(n, p.shape) for n, p in prog.model.named_parameters()] == \
        [(n, p.shape) for n, p in ref.named_parameters()]
    inputs.load_weights(ref, dict(prog.model.named_parameters()))

    tiny = bench.architecture("tiny")
    again = harness.Program(tiny, TINY, CPU, SEED, tmp_path)
    direct = PF3plat(model_config(load_config(None, harness.overrides(TINY))), device=CPU)
    inputs.load_weights(direct, inputs.make_weights(
        harness.leaf_statistics(tiny, TINY, CPU, tmp_path), SEED, CPU))
    assert all(torch.equal(a, b) for a, b in zip(again.model.parameters(),
                                                 direct.parameters()))


def test_reference_step_in_blocks_is_the_whole_batch_step(nopo, monkeypatch):
    """The reference runs its network in blocks of scenes around one
    whole-batch render: one scene a block gives the whole batch's loss and
    gradient to float32 rounding (each leaf's gap against the larger of its
    norm and the median leaf's, as the check measures it; 4e-4 at most
    here, 3e-5 on the median leaf)."""
    from pf3bench import check

    bench, _ = nopo
    loop = bench.loop("nopo_train")
    arch = bench.architecture("tnopo")
    steps = [{"batch": loop.random_batch(TRAFFIC, NOPO, 2, CPU)}]
    stats = inputs.leaf_statistics(arch.build_reference(NOPO, CPU))
    got = {}
    for block in (1, 2):
        monkeypatch.setattr(loop, "BLOCK", block)
        ref = arch.build_reference(NOPO, CPU)
        inputs.load_weights(ref, inputs.make_weights(stats, SEED, CPU))
        got[block] = loop.reference_steps(ref, steps, NOPO, CPU)
    one, whole = got[1], got[2]
    assert one["loss"] == pytest.approx(whole["loss"], rel=1e-5)
    gaps = [g for g, _ in check.leaf_gaps(one["raw_grad"], whole["raw_grad"])]
    # a block's products round differently from the batch's, ~1e-7 on the
    # Gaussians; the centres' gradients pass through the render's tile and
    # budget choices, which that rounding can flip for single Gaussians
    assert sorted(gaps)[len(gaps) // 2] < 1e-4 and max(gaps) < 1e-3, max(gaps)


def test_attention_roofline_reads_forward_kernels_only(nopo):
    """On the card SDPA runs cuDNN's fused kernels, whose forward and
    backward share the name prefix `attn_roofline.serve` reads: the
    training cell's reader counts the forward alone."""
    bench, _ = nopo
    calls = [{"b": 448, "h": 1, "n": 257, "m": 257, "d": 64, "count": 24}]
    ops = [["cudnn_generated_fort_native_sdpa_sm90_flash_fprop_wgmma_f16_knob_7", 0.002, 48],
           ["cudnn_generated_fort_native_sdpa_sm90_flash_bprop_wgmma_f16_knob_26", 0.005, 48],
           ["fmha_cutlassB_f16_aligned_64x64_k64", 0.004, 1], ["flash_bwd_dq_kernel", 0.004, 1]]
    run = {"work": {"attention_calls": calls}, "record": {"trace": {"ops": ops, "count": 2}}}
    from pf3bench.stats import attention_least_seconds

    want = 100.0 * attention_least_seconds(calls) * 2 / 0.002
    assert bench.reader("attn_roofline.nopo")(run) == pytest.approx(want)
