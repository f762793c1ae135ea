"""The program's own spans and counters, read from the profiled sub-window's
trace.

The port opens a named profiler range (`pf3.forward`, `pf3.perceive`,
`pf3.encoder.pose`, `pf3.data.wait`, ...) around each stage while a
profiler session records, so the ranges share the trace's clock with the
device's kernels and the CUDA runtime's calls; its counters (valid
matches, the rasterizer's pairs) are written into the trace's metadata as
one JSON object under `pf3plat_counters`. A program without them (an
older commit) gives a trace with neither, and every reading here is then
None.

A reader gets the run's record, not its trace path: `trace(run)` loads
`out/traces/<cell>/trace.json`, where `harness.profile` writes it under
`run.py`'s default output directory, and uses it only if its busy and
window seconds are the record's (not a stale file, nor another run's).
"""

from __future__ import annotations

import functools
import json
from pathlib import Path

from . import stats
from .harness import PROFILED

TRACES = Path(__file__).resolve().parent / "out" / "traces"
COUNTERS = "pf3plat_counters"
RUNTIME = ("cuda_runtime", "cuda_driver")
# CUDA runtime and driver calls that block the host until the device has
# done earlier work; besides these, every copy call without "Async"
BLOCKING = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize",
            "cuStreamSynchronize", "cuCtxSynchronize", "cuEventSynchronize")


@functools.lru_cache(maxsize=1)
def _load(path: str, mtime_ns: int, size: int) -> dict:
    """One trace file's JSON, parsed once while it is unchanged; callers
    must not modify it."""
    with open(path) as f:
        return json.load(f)


def trace(run: dict) -> dict | None:
    """The JSON of the trace of `run`'s profiled sub-window, or None where
    there is none or the file's busy and window seconds are not the
    record's."""
    t = run["record"].get("trace")
    path = TRACES / run["cell"]["name"] / "trace.json"
    if t is None or not path.is_file():
        return None
    st = path.stat()
    data = _load(str(path), st.st_mtime_ns, st.st_size)
    try:
        busy = stats.device_busy(data.get("traceEvents", []), PROFILED)
    except ValueError:
        return None
    if busy["busy_s"] != t["busy_s"] or busy["window_s"] != t["window_s"]:
        return None
    return data


def ranges(events: list[dict], name: str) -> list[tuple[float, float]]:
    """(start, end) in microseconds of every range `name` inside the
    profiled sub-window, in time order; a range enclosed by another of the
    same name on its thread (one reopened by a recompute) is left out."""
    window = stats.window_span(events, PROFILED)
    found = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]), e.get("tid"))
                   for e in events if e.get("ph") == "X" and e.get("name") == name
                   and e.get("cat") == "user_annotation")
    out: list[tuple[float, float]] = []
    last: dict = {}
    for s, e, tid in found:
        if s < window[0] or e > window[1] or (tid in last and e <= last[tid]):
            continue
        last[tid] = e
        out.append((s, e))
    return out


def span_ms_per(run: dict, name: str, per: str) -> float | None:
    """The summed milliseconds of the ranges `name` over the number of
    ranges `per` (`pf3.forward` for a request, `pf3.train_step` for a
    step)."""
    data = trace(run)
    if data is None:
        return None
    events = data.get("traceEvents", [])
    units = ranges(events, per)
    spans = ranges(events, name)
    if not units or not spans:
        return None
    return sum(e - s for s, e in spans) / 1e3 / len(units)


def _overlap(intervals: list[tuple[float, float]], s: float, e: float) -> float:
    return sum(max(0.0, min(b, e) - max(a, s)) for a, b in intervals)


def idle_share_in(run: dict, name: str) -> float | None:
    """100 x (1 - the device's busy time inside the ranges `name` over
    their summed duration), in percent."""
    data = trace(run)
    if data is None:
        return None
    events = data.get("traceEvents", [])
    spans = ranges(events, name)
    total = sum(e - s for s, e in spans)
    if total <= 0:
        return None
    busy = stats.device_intervals(events, stats.window_span(events, PROFILED))
    return 100.0 * (1.0 - sum(_overlap(busy, s, e) for s, e in spans) / total)


def blocking(event: dict) -> bool:
    """Whether a runtime or driver call blocks the host on the device."""
    if event.get("cat") not in RUNTIME:
        return False
    name = event.get("name", "")
    return name in BLOCKING or (name.startswith(("cudaMemcpy", "cuMemcpy"))
                                and "Async" not in name)


def syncs_per(run: dict, per: str) -> float | None:
    """The blocking runtime calls on any thread that start inside a range
    `per`, over the number of those ranges."""
    data = trace(run)
    if data is None:
        return None
    events = data.get("traceEvents", [])
    units = ranges(events, per)
    if not units:
        return None
    starts = [float(e["ts"]) for e in events if e.get("ph") == "X" and blocking(e)]
    return sum(1 for t in starts if any(s <= t <= e for s, e in units)) / len(units)


def counters(run: dict) -> dict | None:
    """The program's counters over the profiled sub-window."""
    data = trace(run)
    return None if data is None else data.get(COUNTERS)


def raster_overflow(run: dict) -> float | None:
    """100 x (pairs wanted - pairs written) / pairs wanted over the
    rasterizer's pair compaction (kernel B1), in percent: the share of
    the pairs that the budget dropped."""
    c = counters(run)
    if not c or not c.get("raster.pairs_wanted"):
        return None
    wanted = c["raster.pairs_wanted"]
    return 100.0 * (wanted - c["raster.pairs_written"]) / wanted
