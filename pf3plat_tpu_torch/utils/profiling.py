"""Device profiling: torch.profiler traces + per-op breakdown + busy share.

Port of `pf3plat_tpu/utils/profiling.py` on `torch.profiler`:

  * `trace(dir)` — context manager around `torch.profiler.profile` (CPU and,
    where there is a card, CUDA activity); the block runs inside a
    `record_function(window)` range and the Chrome trace is written to
    `dir/*.pt.trace.json` on exit;
  * `device_op_breakdown(dir)` — parse the newest trace in a directory into
    per-op device-time totals, longest first;
  * `device_busy(dir)` — the union of the device's kernel, copy and memset
    intervals (busy µs) against the window's wall µs: the idle share;
  * `raster_traffic_model(...)` — analytic bytes/ray accounting for the
    rasterizer pipeline, the roofline sanity check for kernel work.
"""

from __future__ import annotations

import dataclasses
import functools
import gzip
import json
import os
import time
from collections import Counter, defaultdict
from contextlib import contextmanager
from pathlib import Path
from typing import Optional

# Chrome-trace categories of the device's own activity (Kineto).
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
WINDOW = "pf3plat_trace_window"


@contextmanager
def trace(log_dir: Path | str, window: str = WINDOW):
    """Capture a torch.profiler trace of the block into `log_dir`; yields
    the profiler. The block is recorded as the user range `window`, which
    `device_busy` and `device_op_breakdown` can restrict themselves to."""
    import torch
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


def format_breakdown(rows: list[dict], top: int = 25) -> str:
    total = sum(r["total_us"] for r in rows) or 1.0
    lines = [f"{'us':>12} {'%':>6} {'n':>6}  name"]
    for r in rows[:top]:
        lines.append(
            f"{r['total_us']:12.1f} {100 * r['total_us'] / total:6.2f} "
            f"{r['count']:6d}  {r['name'][:90]}"
        )
    return "\n".join(lines)


@dataclasses.dataclass(frozen=True)
class RasterTraffic:
    """Per-stage device-memory byte estimates for one fwd+bwd rasterizer
    step."""

    sort_bytes: int
    gather_bytes: int
    kernel_fwd_bytes: int
    kernel_bwd_bytes: int
    scatter_bytes: int
    rays: int

    @property
    def total_bytes(self) -> int:
        return (
            self.sort_bytes + self.gather_bytes + self.kernel_fwd_bytes
            + self.kernel_bwd_bytes + self.scatter_bytes
        )

    @property
    def bytes_per_ray(self) -> float:
        return self.total_bytes / max(self.rays, 1)

    def roofline_ms(self, hbm_gbps: float = 3350.0) -> float:
        """Bandwidth-bound lower bound for the step (H100 SXM: 3.35 TB/s)."""
        return self.total_bytes / (hbm_gbps * 1e9) * 1e3

    def as_dict(self) -> dict:
        return {
            "sort_bytes": self.sort_bytes,
            "gather_bytes": self.gather_bytes,
            "kernel_fwd_bytes": self.kernel_fwd_bytes,
            "kernel_bwd_bytes": self.kernel_bwd_bytes,
            "scatter_bytes": self.scatter_bytes,
            "total_bytes": self.total_bytes,
            "bytes_per_ray": self.bytes_per_ray,
            "roofline_ms_at_3350GBps": self.roofline_ms(),
        }


def raster_traffic_model(
    config,
    image_shape: tuple[int, int],
    cameras: int,
    gaussians_per_camera: int,
    channels: int = 3,
    sort_passes: int = 10,
) -> RasterTraffic:
    """Analytic device-memory traffic of the binned table pipeline
    (fwd+bwd), the JAX package's model.

    `sort_passes`: round trips a comparison sort makes over the (key, value)
    pairs — log2(n)-ish. Use this model to sanity-check measured stage
    times against the bandwidth bound, not as a precise simulator.
    """
    h, w = image_shape
    ts = config.tile_size
    tiles = -(-h // ts) * (-(-w // ts))
    rows = cameras * tiles
    cap = config.tile_capacity
    p = ts * ts
    f_dim = 6 + channels
    pairs = cameras * gaussians_per_camera * config.max_dup
    keys = 1 if config.fused_sort_key else 2

    sort_bytes = pairs * 4 * (keys + 1) * 2 * sort_passes  # rd+wr per pass
    gather_bytes = rows * cap * f_dim * 4 * 2  # read src + write table
    # fwd: table in, image + t_final + per-chunk T checkpoints out
    n_chunks = cap // config.chunk
    kernel_fwd = rows * (f_dim * cap + (channels + 1 + n_chunks) * p) * 4
    # bwd: table + checkpoints + cotangents in, dtable out
    kernel_bwd = rows * (
        f_dim * cap + (n_chunks + channels + 2) * p + f_dim * cap
    ) * 4
    scatter_bytes = rows * cap * f_dim * 4 * 3  # read grads, rd+wr dest
    return RasterTraffic(
        sort_bytes=sort_bytes,
        gather_bytes=gather_bytes,
        kernel_fwd_bytes=kernel_fwd,
        kernel_bwd_bytes=kernel_bwd,
        scatter_bytes=scatter_bytes,
        rays=cameras * h * w,
    )
