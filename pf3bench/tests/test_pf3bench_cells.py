"""Whole runs of each tiny cell on the CPU: the result's keys, a sound run
judged correct, and each fault a cell can have judged not correct."""

import math

import pytest

from pf3bench.run import run_cell

SEED = 2**31 + 99


def _run(tiny, workload, tmp_path, fault=None, trace=False):
    return run_cell(tiny, workload, SEED, 0.5, trace, "cpu", fault=fault, out=tmp_path)


@pytest.mark.parametrize("workload", ["tiny.tserve", "tiny.ttrain"])
def test_sound_run_is_correct(tiny, workload, tmp_path):
    r = _run(tiny, workload, tmp_path, trace=True)
    assert r["correct"], r["checks"]
    assert list(r)[-1] == "checks"
    assert r["attempted"] >= 1 and r["failed"] == 0
    names = {m["name"] for m in tiny.metrics(workload, True)}
    assert set(r["metrics"]) <= names
    kind = "train" if workload.endswith("train") else "serve"
    assert f"perceive_ms.{kind}" in r["metrics"]
    assert all(math.isfinite(m["value"]) for m in r["metrics"].values())
    assert r["device"]["window_s"] > 0 and "device_ops" in r["breakdown"]


def test_untraced_run_reports_end_to_end(tiny, tmp_path):
    r = _run(tiny, "tiny.tserve", tmp_path)
    assert {"setup_s", "request_ms", "request_ms_p90"} <= set(r["metrics"])
    assert "step_ms" not in r["metrics"]


@pytest.mark.parametrize("workload,fault", [("tiny.tserve", "answer"),
                                            ("tiny.ttrain", "unchanged"),
                                            ("tiny.ttrain", "half_batch")])
def test_fault_is_not_correct(tiny, workload, fault, tmp_path):
    r = _run(tiny, workload, tmp_path, fault=fault)
    assert not r["correct"], r["checks"]
