"""The yardstick's arithmetic: percentiles and spreads, the chip's peaks,
rooflines and model FLOP utilisation, and the reading of a profiler trace
(device busy time, operations by device time, idle gaps by what the host
was doing).

`device_busy` and `op_breakdown` are copies of the port's
`utils/profiling.py` (`device_busy`, `device_op_breakdown`) reading the
same Chrome trace: the union of the device's kernel, copy and memset
intervals inside a user range, and per-name device time.
"""

from __future__ import annotations

import json
import statistics
from collections import defaultdict
from pathlib import Path

import numpy as np

# NVIDIA H100 SXM, dense, at its 700 W limit (NVIDIA's data sheet).
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12

DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


def percentile(values, q: float) -> float:
    """The q-th percentile of all values, linear between order statistics."""
    return float(np.percentile(np.asarray(values, np.float64), q))


def spread(values) -> float:
    """(third quartile - first quartile) / median, by
    `statistics.quantiles(values, n=4)`."""
    q1, q2, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / q2


def mfu(flops: float, seconds: float) -> float:
    """Percent of the bf16 dense peak that `flops` in `seconds` reach."""
    return 100.0 * flops / seconds / PEAK_BF16_FLOPS


def attention_least_seconds(calls: list[dict], element_bytes: int = 2) -> float:
    """The least time of the attention calls `calls` ({b, h, n, m, d,
    count}): per call the larger of 4*b*h*n*m*d operations at the bf16 peak
    and q, k, v and o moved once each at the memory peak."""
    total = 0.0
    for c in calls:
        b, h, n, m, d = (c[k] for k in "bhnmd")
        flops = 4.0 * b * h * n * m * d
        moved = element_bytes * b * h * d * (2 * n + 2 * m)
        total += c.get("count", 1) * max(flops / PEAK_BF16_FLOPS, moved / PEAK_HBM_BYTES)
    return total


# ---- traces ------------------------------------------------------------------------


def load_trace(path: Path) -> list[dict]:
    with open(path) as f:
        return json.load(f).get("traceEvents", [])


def window_span(events: list[dict], window: str) -> tuple[float, float]:
    """(start, end) in microseconds of the user range `window`."""
    spans = [(float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in events
             if e.get("ph") == "X" and e.get("name") == window
             and e.get("cat") == "user_annotation"]
    if not spans:
        raise ValueError(f"trace holds no range named {window!r}")
    return min(s for s, _ in spans), max(e for _, e in spans)


def _clip(ev: dict, span) -> tuple[float, float] | None:
    start = float(ev["ts"])
    end = start + float(ev["dur"])
    start, end = max(start, span[0]), min(end, span[1])
    return (start, end) if end > start else None


def device_intervals(events: list[dict], span) -> list[tuple[float, float]]:
    """The device's activity intervals inside `span`, merged."""
    ivs = sorted(iv for e in events
                 if e.get("ph") == "X" and e.get("cat") in DEVICE_CATEGORIES
                 and (iv := _clip(e, span)) is not None)
    merged: list[list[float]] = []
    for s, e in ivs:
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return [(s, e) for s, e in merged]


def device_busy(events: list[dict], window: str) -> dict:
    """{busy_s, window_s, events}: the union of device activity against the
    wall time of the user range `window`."""
    span = window_span(events, window)
    merged = device_intervals(events, span)
    n = sum(1 for e in events if e.get("ph") == "X" and e.get("cat") in DEVICE_CATEGORIES
            and _clip(e, span) is not None)
    return {"busy_s": sum(e - s for s, e in merged) / 1e6,
            "window_s": (span[1] - span[0]) / 1e6, "events": n}


def op_breakdown(events: list[dict], window: str) -> list[tuple[str, float, int]]:
    """(device operation name, seconds, count) inside `window`, longest first."""
    span = window_span(events, window)
    totals: dict = defaultdict(lambda: [0.0, 0])
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in DEVICE_CATEGORIES:
            continue
        iv = _clip(e, span)
        if iv is not None:
            totals[e["name"]][0] += (iv[1] - iv[0]) / 1e6
            totals[e["name"]][1] += 1
    return sorted(((k, v[0], v[1]) for k, v in totals.items()), key=lambda r: -r[1])


def idle_gaps(events: list[dict], window: str) -> list[tuple[str, float]]:
    """The device's idle time inside `window`, summed by what the host
    thread that opened the window was doing: the innermost host operation
    or range open at each gap's middle ("host" where none is), longest
    first."""
    span = window_span(events, window)
    tid = next(e.get("tid") for e in events if e.get("ph") == "X"
               and e.get("name") == window and e.get("cat") == "user_annotation")
    merged = device_intervals(events, span)
    edges = [span[0]] + [x for iv in merged for x in iv] + [span[1]]
    gaps = [(s, e) for s, e in zip(edges[0::2], edges[1::2]) if e > s]
    host = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"])
                  for e in events if e.get("ph") == "X" and e.get("tid") == tid
                  and e.get("cat") in ("cpu_op", "user_annotation")
                  and e.get("name") != window)
    totals: dict = defaultdict(float)
    stack: list[tuple[float, float, str]] = []
    j = 0
    for s, e in gaps:  # in time order; the host ranges of one thread nest
        mid = 0.5 * (s + e)
        while j < len(host) and host[j][0] <= mid:
            while stack and stack[-1][1] < host[j][0]:
                stack.pop()
            stack.append(host[j])
            j += 1
        while stack and stack[-1][1] < mid:
            stack.pop()
        totals[stack[-1][2] if stack else "host"] += (e - s) / 1e6
    return sorted(totals.items(), key=lambda r: -r[1])


def stage_mean(stage_ms: list[dict], stage: str) -> float | None:
    """The mean over requests or steps of one stage's milliseconds."""
    values = [s[stage] for s in stage_ms if stage in s]
    return sum(values) / len(values) if values else None
