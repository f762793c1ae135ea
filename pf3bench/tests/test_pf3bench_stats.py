"""The yardstick's arithmetic: percentiles, spreads, MFU and rooflines, and
the trace readings against the port's own `utils/profiling.py` on one
synthetic trace."""

import json
import math

import pytest

from pf3bench import stats

WINDOW = "w"


def synthetic_trace():
    """A user range 0-100 us on thread 1; kernels 10-20, 15-30 (overlapping)
    and 60-70; host ops on thread 1: `outer` 0-100 holding `inner` 35-55."""
    ev = [{"ph": "X", "cat": "user_annotation", "name": WINDOW, "ts": 0, "dur": 100, "tid": 1,
           "pid": 1},
          {"ph": "X", "cat": "cpu_op", "name": "outer", "ts": 0, "dur": 100, "tid": 1, "pid": 1},
          {"ph": "X", "cat": "cpu_op", "name": "inner", "ts": 35, "dur": 20, "tid": 1, "pid": 1},
          {"ph": "X", "cat": "cpu_op", "name": "other_thread", "ts": 30, "dur": 30, "tid": 2,
           "pid": 1}]
    for name, ts, dur in (("k1", 10, 10), ("k2", 15, 15), ("k1", 60, 10)):
        ev.append({"ph": "X", "cat": "kernel", "name": name, "ts": ts, "dur": dur, "tid": 7,
                   "pid": 2})
    return ev


def test_percentile_spread_mfu():
    assert stats.percentile(range(1, 11), 90) == pytest.approx(9.1)
    assert stats.spread([1, 2, 3, 4, 5, 6, 7]) == pytest.approx((6 - 2) / 4)
    assert stats.mfu(989e12, 2.0) == pytest.approx(50.0)


def test_attention_least_seconds():
    c = dict(b=2, h=3, n=4096, m=4096, d=64)
    flops = 4 * 2 * 3 * 4096 * 4096 * 64
    assert stats.attention_least_seconds([c]) == pytest.approx(flops / stats.PEAK_BF16_FLOPS)
    small = dict(b=1, h=1, n=1, m=1, d=64, count=3)
    moved = 2 * 64 * 4
    assert stats.attention_least_seconds([small]) == pytest.approx(
        3 * moved / stats.PEAK_HBM_BYTES)


def test_trace_readings(tmp_path):
    ev = synthetic_trace()
    busy = stats.device_busy(ev, WINDOW)
    assert busy["busy_s"] == pytest.approx(30e-6) and busy["window_s"] == pytest.approx(100e-6)
    ops = stats.op_breakdown(ev, WINDOW)
    assert ops[0][0] == "k1" and ops[0][1] == pytest.approx(20e-6) and ops[0][2] == 2
    gaps = dict(stats.idle_gaps(ev, WINDOW))
    # gaps 0-10, 30-60 (middle 45: inside `inner`), 70-100
    assert gaps["inner"] == pytest.approx(30e-6)
    assert gaps["outer"] == pytest.approx(40e-6)


def test_busy_matches_the_ports_profiling(tmp_path):
    from pf3plat_tpu_torch.utils import profiling

    ev = synthetic_trace()
    (tmp_path / "x.pt.trace.json").write_text(json.dumps({"traceEvents": ev}))
    theirs = profiling.device_busy(tmp_path, window=WINDOW)
    ours = stats.device_busy(ev, WINDOW)
    assert math.isclose(theirs["busy_us"] / 1e6, ours["busy_s"])
    assert math.isclose(theirs["wall_us"] / 1e6, ours["window_s"])
    rows = {r["name"]: r["total_us"] / 1e6 for r in
            profiling.device_op_breakdown(tmp_path, window=WINDOW)}
    assert rows == pytest.approx({n: s for n, s, _ in stats.op_breakdown(ev, WINDOW)})
