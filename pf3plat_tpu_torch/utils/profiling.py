"""Device profiling: torch.profiler traces, the port's spans and counters,
per-op breakdown and busy share.

Port of `pf3plat_tpu/utils/profiling.py` on `torch.profiler`, with the
port's own instrumentation:

  * `trace(dir)` — context manager around `torch.profiler.profile` (CPU and,
    where there is a card, CUDA activity); the block runs inside a
    `record_function(window)` range and the Chrome trace is written to
    `dir/*.pt.trace.json` on exit;
  * `span(name)` / `stage(name, timer)` — named ranges of the port's stages
    (`pf3.forward`, `pf3.perceive.lightglue`, ...), recorded into the
    session's trace beside the kernels they launch while a profiler
    session records, and nothing but a flag check otherwise. `stage` also
    calls a stage `timer` callback as the stage ends;
  * `count(name, value)` — counters (valid matches, rasterizer pairs)
    summed on the device while a session records and written, as one JSON
    object, into the trace's metadata under `pf3plat_counters` after each
    outermost `pf3.forward` or `pf3.train_step` range closes;
  * `device_op_breakdown(dir)` — parse the newest trace in a directory into
    per-op device-time totals, longest first;
  * `device_busy(dir)` — the union of the device's kernel, copy and memset
    intervals (busy µs) against the window's wall µs: the idle share.
"""

from __future__ import annotations

import contextlib
import functools
import gzip
import json
import os
import threading
import time
from collections import Counter, defaultdict
from contextlib import contextmanager
from pathlib import Path
from typing import Optional

import torch
import torch.autograd.profiler as _autograd_profiler

# Chrome-trace categories of the device's own activity (Kineto).
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
WINDOW = "pf3plat_trace_window"
COUNTERS = "pf3plat_counters"  # the trace metadata key of the counters
# The ranges of one request or step: the counters are folded after the
# outermost of them closes on its thread.
OUTER = ("pf3.forward", "pf3.train_step")
NULL = contextlib.nullcontext()


def tracing() -> bool:
    """Whether a torch.profiler session records (a Python flag that torch
    sets as a session starts and clears as it stops). Call sites guard the
    work of a counter's value with it."""
    return _autograd_profiler._is_profiler_enabled


class _Tracer:
    """The counters' totals since the current profiler session started
    (device tensors or ints, summed without a host sync) and each thread's
    depth of `OUTER` ranges."""

    def __init__(self):
        self.lock = threading.Lock()
        self.local = threading.local()
        self.totals: dict = {}
        self.hooked = False

    def reset(self) -> None:
        with self.lock:
            self.totals = {}

    def _hook(self) -> None:
        """Wrap torch's hook as a profiler session starts so that it first
        zeroes the totals: they count that session alone. Installed with
        the first count, inside the first session that counts."""
        self.hooked = True
        start = getattr(_autograd_profiler, "_run_on_profiler_start", None)
        if start is None:
            return

        @functools.wraps(start)
        def on_start(*args, **kwargs):
            self.reset()
            return start(*args, **kwargs)

        _autograd_profiler._run_on_profiler_start = on_start

    def add(self, name: str, value) -> None:
        with self.lock:
            if not self.hooked:
                self._hook()
            prev = self.totals.get(name, 0)
            if isinstance(value, torch.Tensor):
                value = value.detach().to(torch.int64)
                if isinstance(prev, torch.Tensor) and prev.device != value.device:
                    value = value.to(prev.device, non_blocking=True)
            self.totals[name] = prev + value

    def fold(self) -> None:
        """Write the totals into the session's metadata: one transfer of
        every device total to the host."""
        with self.lock:
            totals = dict(self.totals)
        if not totals or not tracing():
            return
        names = sorted(totals)
        on_device = [k for k in names if isinstance(totals[k], torch.Tensor)]
        if on_device:
            home = totals[on_device[0]].device
            values = torch.stack([totals[k].to(home).reshape(()) for k in on_device]).tolist()
            totals.update(zip(on_device, values))
        torch.autograd._add_metadata_json(
            COUNTERS, json.dumps({k: int(totals[k]) for k in names}))


_TRACER = _Tracer()


class _Range:
    """The profiler range `name`, opened on entry. After the outermost
    `OUTER` range of a thread closes, the counters are folded, outside
    every range."""

    __slots__ = ("name", "range", "outer")

    def __init__(self, name: str):
        self.name = name
        self.range = None
        self.outer = name in OUTER

    def __enter__(self):
        if self.outer:
            local = _TRACER.local
            local.depth = getattr(local, "depth", 0) + 1
        self.range = torch.profiler.record_function(self.name)
        self.range.__enter__()
        return self

    def __exit__(self, *exc):
        self.range.__exit__(*exc)
        if self.outer:
            local = _TRACER.local
            local.depth -= 1
            if local.depth == 0 and exc[0] is None:
                _TRACER.fold()
        return False


def span(name: str):
    """The profiler range `name` while a profiler session records; the
    shared null context `NULL` otherwise, at the cost of a flag check."""
    if not _autograd_profiler._is_profiler_enabled:
        return NULL
    return _Range(name)


class _Stage:
    __slots__ = ("name", "span", "timer", "range")

    def __init__(self, name: str, timer, span: str):
        self.name, self.span, self.timer, self.range = name, span, timer, None

    def __enter__(self):
        if _autograd_profiler._is_profiler_enabled:
            self.range = _Range(self.span)
            self.range.__enter__()
        return self

    def __exit__(self, *exc):
        try:
            if exc[0] is None and self.timer:
                self.timer(self.name)
        finally:
            if self.range is not None:
                self.range.__exit__(*exc)
        return False


def stage(name: str, timer=None, prefix: str = "pf3."):
    """The span `<prefix><name>` of one of the stages a `timer` callback
    names ("perceive", "encoder", "decoder", "loss", "backward",
    "optimizer"; NoPoSplat's "vit", "crossview", "heads" under the prefix
    `pf3.nopo.`): its exit calls `timer(name)`, inside the range, where the
    stage ends. `NULL` without a timer while no session records."""
    if not timer and not _autograd_profiler._is_profiler_enabled:
        return NULL
    return _Stage(name, timer, prefix + name)


def count(name: str, value) -> None:
    """Add `value` (a device scalar or an int) to the counter `name` while
    a profiler session records; nothing otherwise. A value that takes work
    to compute is guarded by `tracing()` at its call site."""
    if _autograd_profiler._is_profiler_enabled:
        _TRACER.add(name, value)


@contextmanager
def trace(log_dir: Path | str, window: str = WINDOW):
    """Capture a torch.profiler trace of the block into `log_dir`; yields
    the profiler. The block is recorded as the user range `window`, which
    `device_busy` and `device_op_breakdown` can restrict themselves to; the
    port's spans inside it are recorded, and its counters are written into
    the trace's metadata (`COUNTERS`), at the latest as the block ends."""
    from torch.profiler import ProfilerActivity, profile, record_function

    log_dir = Path(log_dir)
    log_dir.mkdir(parents=True, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        with record_function(window):
            yield prof
            if torch.cuda.is_available():
                torch.cuda.synchronize()
        _TRACER.fold()
    name = f"{window}_{os.getpid()}_{time.time_ns()}.pt.trace.json"
    prof.export_chrome_trace(str(log_dir / name))


def _newest_trace_file(log_dir: Path) -> Optional[Path]:
    files = sorted(
        (p for pat in ("*.trace.json.gz", "*.trace.json")
         for p in Path(log_dir).rglob(pat)),
        key=lambda p: p.stat().st_mtime,
    )
    return files[-1] if files else None


def _load_events(log_dir: Path | str) -> list[dict]:
    path = _newest_trace_file(Path(log_dir))
    if path is None:
        raise FileNotFoundError(f"no *.trace.json(.gz) under {log_dir}")
    return _parse(path, path.stat().st_mtime_ns)


@functools.lru_cache(maxsize=1)
def _parse(path: Path, mtime_ns: int) -> list[dict]:
    """The events of one trace file. The last file parsed stays cached (by
    path and modification time), so a window's analyses parse it once;
    callers must not modify the list."""
    opener = gzip.open if path.suffix == ".gz" else open
    with opener(path, "rt") as f:
        return json.load(f).get("traceEvents", [])


def _window_span(events: list[dict], window: Optional[str]):
    """(start, end) in µs of the user range `window`, or None for the whole
    trace."""
    if window is None:
        return None
    spans = [(float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in events
             if e.get("ph") == "X" and e.get("name") == window
             and e.get("cat") == "user_annotation"]
    if not spans:
        raise ValueError(f"trace holds no range named {window!r}")
    return min(s for s, _ in spans), max(e for _, e in spans)


def _clip(ev: dict, span) -> Optional[tuple[float, float]]:
    start = float(ev["ts"])
    end = start + float(ev["dur"])
    if span is not None:
        start, end = max(start, span[0]), min(end, span[1])
    return (start, end) if end > start else None


def device_op_breakdown(
    log_dir: Path | str, top: int = 0, device_only: bool = True,
    window: Optional[str] = None,
) -> list[dict]:
    """Aggregate trace events into per-op totals, longest first.

    Returns [{"name", "total_us", "count", "pid_name", "launched_by"}].
    `device_only` keeps the device's kernels, copies and memsets, dropping
    host rows; a trace without device activity (the CPU) falls back to
    every duration event. `launched_by` is the host operation that launched
    a device op most often ("" for host rows). `window` keeps the time
    inside that user range.
    """
    events = _load_events(log_dir)
    span = _window_span(events, window)
    pid_names: dict = {}
    host_ops: dict = {}
    for ev in events:
        if ev.get("ph") == "M" and ev.get("name") == "process_name":
            pid_names[ev["pid"]] = ev.get("args", {}).get("name", "")
        elif ev.get("cat") == "cpu_op" and "External id" in ev.get("args", {}):
            host_ops[ev["args"]["External id"]] = ev["name"]

    def collect(filtered: bool) -> list[dict]:
        totals: dict = defaultdict(lambda: [0.0, 0, "", Counter()])
        for ev in events:
            if ev.get("ph") != "X" or "dur" not in ev:
                continue
            if filtered and ev.get("cat") not in DEVICE_CATEGORIES:
                continue
            iv = _clip(ev, span)
            if iv is None:
                continue
            t = totals[ev["name"]]
            t[0] += iv[1] - iv[0]
            t[1] += 1
            t[2] = str(pid_names.get(ev.get("pid"), ev.get("pid", "")))
            if filtered:
                t[3][host_ops.get(ev.get("args", {}).get("External id"), "")] += 1
        return [
            {"name": k, "total_us": v[0], "count": v[1], "pid_name": v[2],
             "launched_by": v[3].most_common(1)[0][0] if v[3] else ""}
            for k, v in totals.items()
        ]

    rows = collect(device_only)
    if not rows and device_only:
        rows = collect(False)
    rows.sort(key=lambda r: -r["total_us"])
    return rows[:top] if top else rows


def device_busy(log_dir: Path | str, window: Optional[str] = None) -> dict:
    """The union of the device's activity intervals (kernels, copies,
    memsets, on every stream) against the wall time of `window` (default:
    from the first to the last event of the trace).

    Returns {"busy_us", "wall_us", "idle_share", "device_events",
    "launch_lead_min_us", "negative_leads", "negative_lead_us"}: the least
    time from a launch call on the host to the start of its device activity
    (None without device activity), and the count and summed duration of
    the device events that start before their own launch call, which only
    a drift between the trace's two clocks produces."""
    events = _load_events(log_dir)
    span = _window_span(events, window)
    if span is None:
        timed = [e for e in events if e.get("ph") == "X" and "dur" in e]
        span = (min(float(e["ts"]) for e in timed),
                max(float(e["ts"]) + float(e["dur"]) for e in timed))
    intervals = sorted(
        iv for e in events
        if e.get("ph") == "X" and e.get("cat") in DEVICE_CATEGORIES
        and (iv := _clip(e, span)) is not None
    )
    busy, cur_start, cur_end = 0.0, None, None
    for start, end in intervals:
        if cur_end is None or start > cur_end:
            if cur_end is not None:
                busy += cur_end - cur_start
            cur_start, cur_end = start, end
        else:
            cur_end = max(cur_end, end)
    if cur_end is not None:
        busy += cur_end - cur_start
    wall = span[1] - span[0]
    calls = {e["args"]["correlation"]: float(e["ts"]) for e in events
             if e.get("cat") in ("cuda_runtime", "cuda_driver")
             and "correlation" in e.get("args", {})}
    leads = [(float(e["ts"]) - calls[c], float(e["dur"])) for e in events
             if e.get("ph") == "X" and e.get("cat") in DEVICE_CATEGORIES
             and (c := e.get("args", {}).get("correlation")) in calls]
    negative = [d for lead, d in leads if lead < 0]
    return {"busy_us": busy, "wall_us": wall,
            "idle_share": 1.0 - busy / wall if wall > 0 else 0.0,
            "device_events": len(intervals),
            "launch_lead_min_us": min(lead for lead, _ in leads) if leads else None,
            "negative_leads": len(negative), "negative_lead_us": sum(negative)}
