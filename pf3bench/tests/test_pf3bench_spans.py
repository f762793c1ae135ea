"""The readers of the program's spans and counters (`spans.py` and the
seven metrics that use it) on synthetic Chrome traces: device events,
runtime calls on two threads, `pf3.*` ranges and the counters' metadata."""

import json

import pytest

from pf3bench import spans, stats
from pf3bench.harness import PROFILED
from pf3bench.spec import Benchmark

SERVE = ("pose_ms.serve", "perceive_idle_share.serve", "host_syncs.serve",
         "raster_overflow.serve")
TRAIN = ("data_queue_ms.train", "host_syncs.train", "raster_overflow.train")


def _x(name, ts, dur, cat="user_annotation", tid=1):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": tid, "pid": 1}


def _common():
    """The profiled window 0-1000 us; kernels 120-150, 200-260 and 520-540;
    runtime calls: blocking at 260 and 300 (thread 1) and 700 (thread 3),
    one between the units at 450 and one after them at 900; an async copy
    and a launch, which do not block."""
    ev = [_x(PROFILED, 0, 1000)]
    ev += [_x(k, ts, d, cat="kernel", tid=7) for k, ts, d in
           (("k1", 120, 30), ("k2", 200, 60), ("k1", 520, 20))]
    ev += [_x(n, ts, 1, cat=c, tid=tid) for n, ts, c, tid in (
        ("cudaStreamSynchronize", 260, "cuda_runtime", 1),
        ("cudaMemcpy", 300, "cuda_runtime", 1),
        ("cudaMemcpyAsync", 310, "cuda_runtime", 1),
        ("cudaLaunchKernel", 320, "cuda_runtime", 1),
        ("cudaEventSynchronize", 700, "cuda_runtime", 3),
        ("cuStreamSynchronize", 450, "cuda_driver", 1),
        ("cudaDeviceSynchronize", 900, "cuda_runtime", 1))]
    return ev


def serve_trace():
    """Two requests (`pf3.forward` 100-400 and 500-800), perception at
    110-210 and 510-610, the pose stage 250-300 and 650-720 (with a range
    of that name reopened inside the second, which is not counted)."""
    ev = _common()
    ev += [_x("pf3.forward", 100, 300), _x("pf3.forward", 500, 300),
           _x("pf3.perceive", 110, 100), _x("pf3.perceive", 510, 100),
           _x("pf3.encoder.pose", 250, 50), _x("pf3.encoder.pose", 650, 70),
           _x("pf3.encoder.pose", 660, 20)]
    return {"traceEvents": ev,
            "pf3plat_counters": {"forwards": 2, "raster.pairs_wanted": 1000,
                                 "raster.pairs_written": 900, "raster.pairs_budget": 900}}


def train_trace():
    """Two steps (`pf3.train_step` 100-400 and 500-800), the data waits
    before them (20-60, 60-90, 420-480), and no overflow."""
    ev = _common()
    ev += [_x("pf3.train_step", 100, 300), _x("pf3.train_step", 500, 300),
           _x("pf3.forward", 110, 150),
           _x("pf3.data.wait", 20, 40), _x("pf3.data.wait", 60, 30),
           _x("pf3.data.wait", 420, 60)]
    return {"traceEvents": ev,
            "pf3plat_counters": {"train_steps": 2, "raster.pairs_wanted": 800,
                                 "raster.pairs_written": 800, "raster.pairs_budget": 900}}


WANT = {"pose_ms.serve": (50 + 70) / 1e3 / 2,
        "perceive_idle_share.serve": 100 * (1 - (30 + 10 + 20) / 200),
        "host_syncs.serve": 3 / 2, "raster_overflow.serve": 10.0,
        "data_queue_ms.train": (40 + 30 + 60) / 1e3 / 2,
        "host_syncs.train": 3 / 2, "raster_overflow.train": 0.0}


def _run(tmp_path, monkeypatch, cell, data, busy=None):
    """A run of `cell` whose trace file holds `data`; its record's busy and
    window seconds are the file's, or `busy`."""
    monkeypatch.setattr(spans, "TRACES", tmp_path / "traces")
    path = tmp_path / "traces" / cell / "trace.json"
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(data))
    b = busy or stats.device_busy(data["traceEvents"], PROFILED)
    return {"cell": {"name": cell},
            "record": {"trace": {"busy_s": b["busy_s"], "window_s": b["window_s"]}}}


@pytest.mark.parametrize("metric", SERVE + TRAIN)
def test_each_reading(tmp_path, monkeypatch, metric):
    serve = metric in SERVE
    run = _run(tmp_path, monkeypatch, "c.serve" if serve else "c.train",
               serve_trace() if serve else train_trace())
    assert Benchmark().reader(metric)(run) == pytest.approx(WANT[metric])


@pytest.mark.parametrize("metric", SERVE + TRAIN)
def test_a_trace_of_another_run_reads_none(tmp_path, monkeypatch, metric):
    data = serve_trace() if metric in SERVE else train_trace()
    b = stats.device_busy(data["traceEvents"], PROFILED)
    run = _run(tmp_path, monkeypatch, "c", data, dict(b, busy_s=b["busy_s"] * 1.01))
    assert Benchmark().reader(metric)(run) is None


@pytest.mark.parametrize("metric", SERVE + TRAIN)
def test_a_program_without_spans_reads_none(tmp_path, monkeypatch, metric):
    """The parent's program: no pf3.* range, no counters; and no trace."""
    data = {"traceEvents": _common()}
    assert Benchmark().reader(metric)(_run(tmp_path, monkeypatch, "c", data)) is None
    missing = {"cell": {"name": "absent"}, "record": {"trace": {"busy_s": 0, "window_s": 1}}}
    assert Benchmark().reader(metric)(missing) is None
    assert Benchmark().reader(metric)({"cell": {"name": "c"}, "record": {}}) is None
