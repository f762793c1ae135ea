"""What every loop shares: the program on the card (`Program`), the timed
window (`Window`), the stage clock, the profiled sub-window, the sample of
requests the check reads (`Reservoir`), and the serving loop (`serve`) that the serving
mixes' loops drive with their own request.

A loop is `loops/<kind>.py`, found by its traffic file's `kind`; it warms
up the cell's own shapes (counted in set-up), times a window of `seconds`,
optionally profiles a short sub-window after it, keeps what the check
compares, and judges it (`gaps`). Only this file, the loops and the
architectures (`architectures/<name>.py`) import the program.
"""

from __future__ import annotations

import gc
import hashlib
import json
import time
from pathlib import Path

import numpy as np
import torch

from . import check, inputs, spec, stats

PROFILED = "pf3bench_profiled"


class StageClock:
    """A `timer` callback: a CUDA event at the end of each stage (a host
    clock reading off the card). Stages named more than once add up."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.marks: list = []

    def _now(self):
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            return ev
        return time.perf_counter()

    def start(self) -> "StageClock":
        self.marks = [("start", self._now())]
        return self

    def __call__(self, stage: str) -> None:
        self.marks.append((stage, self._now()))

    def stage_ms(self) -> dict:
        out: dict = {}
        for (_, a), (name, b) in zip(self.marks, self.marks[1:]):
            ms = a.elapsed_time(b) if self.cuda else (b - a) * 1e3
            out[name] = out.get(name, 0.0) + ms
        return out


def overrides(tree: dict) -> list[str]:
    """A configuration tree as the program's `key=value` overrides."""
    return [f"{k}={json.dumps(v)}" for k, v in tree.items()]


def synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def host(x):
    """A tensor, or a (nested) tuple or list of them, on the host."""
    if isinstance(x, (tuple, list)):
        return tuple(host(t) for t in x)
    return x.detach().to("cpu", copy=True)


def leaf_statistics(architecture, tree: dict, device: torch.device, cache: Path | None) -> dict:
    """The per-leaf initialisation statistics of `architecture`'s reference
    for the configuration `tree`, kept under `cache` (a fixed directory of
    the checkout) after the first run: they depend on the two alone. The
    default architecture's entry is keyed by the tree alone."""
    name = Path(architecture.__file__).stem
    keyed = tree if name == spec.DEFAULT_ARCHITECTURE else {"architecture": name, "config": tree}
    key = hashlib.sha256(json.dumps(keyed, sort_keys=True).encode()).hexdigest()[:16]
    path = None if cache is None else cache / f"{key}.json"
    if path is not None and path.exists():
        return {k: (tuple(v[0]), v[1], v[2]) for k, v in json.loads(path.read_text()).items()}
    ref = architecture.build_reference(tree, device)
    leaf = inputs.leaf_statistics(ref)
    del ref
    if path is not None:
        path.parent.mkdir(parents=True, exist_ok=True)
        tmp = path.with_suffix(".tmp")
        tmp.write_text(json.dumps(leaf))
        tmp.replace(path)
    return leaf


class Program:
    """The port on `device`: the configuration's model, as its
    `architecture` (`architectures/<name>.py`) builds it, with the seed's
    weights, under the port's precision policy (`precision.apply_policy`,
    as every entry point sets it)."""

    def __init__(self, architecture, tree: dict, device: torch.device, seed: int,
                 cache: Path | None = None):
        from pf3plat_tpu_torch import precision

        precision.apply_policy(device)
        self.device = device
        self.stats = leaf_statistics(architecture, tree, device, cache)
        self.cfg, self.model = architecture.build_program(tree, device)
        inputs.load_weights(self.model, inputs.make_weights(self.stats, seed, device))

    def close(self) -> None:
        self.model = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()


def profile(device: torch.device, out_dir: Path, fn) -> dict:
    """Run `fn` under torch.profiler inside the user range `PROFILED`; the
    trace's busy and window seconds, operations and idle gaps."""
    from torch.profiler import ProfilerActivity, record_function

    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    out_dir.mkdir(parents=True, exist_ok=True)
    path = out_dir / "trace.json"
    with torch.profiler.profile(activities=activities) as prof:
        with record_function(PROFILED):
            count = fn()
            synchronize(device)
    prof.export_chrome_trace(str(path))
    events = stats.load_trace(path)
    busy = stats.device_busy(events, PROFILED)
    ops = stats.op_breakdown(events, PROFILED)
    (out_dir / "ops.json").write_text(json.dumps(ops))
    return dict(busy, count=count, ops=ops, gaps=stats.idle_gaps(events, PROFILED))


class Window:
    """Runs `one(i)` back to back from i = 0 until `seconds` have passed
    since the first started; the window ends with the last completed."""

    def __init__(self, device: torch.device):
        self.device = device

    def run(self, one, seconds: float) -> dict:
        synchronize(self.device)
        if self.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(self.device)
        t0 = time.perf_counter()
        wall, i = [], 0
        while True:
            a = time.perf_counter()
            one(i)
            b = time.perf_counter()
            wall.append((b - a) * 1e3)
            i += 1
            if b - t0 >= seconds:
                break
        peak = torch.cuda.max_memory_allocated(self.device) if self.device.type == "cuda" \
            else None
        return dict(window_s=b - t0, wall_ms=wall, count=i, peak_bytes=peak)


class Reservoir:
    """A uniform sample of `k` of the window's requests, however many it
    completes, decided from the seed as each request starts (reservoir
    sampling): `take(i)` says whether request i is kept; a request it
    displaces leaves `records`."""

    def __init__(self, k: int, seed: int, records: dict):
        self.k, self.slots, self.records = k, [], records
        self.rng = inputs.rng(seed, inputs.SCENES, 2**31)

    def take(self, i: int) -> bool:
        if len(self.slots) < self.k:
            self.slots.append(i)
            return True
        j = int(self.rng.integers(0, i + 1))
        if j >= self.k:
            return False
        self.records.pop(self.slots[j], None)
        self.slots[j] = i
        return True


def serve(prog: Program, traffic: dict, seed: int, seconds: float, trace_dir: Path | None,
          respond) -> dict:
    """The serving loop: one client sends the mix's requests back to back
    (a closed loop), each a new scene of the seed's pool from host arrays.
    `respond(model, args, generator, clock)` serves one request and returns
    (the encoder's output, the answer as host arrays). The check's sample
    keeps its answer, its scene and what perception returned."""
    dev, model = prog.device, prog.model
    pool = [inputs.serve_scene(traffic, seed, i) for i in range(traffic["pool"])]
    recorder = check.Recorder(model, matching=True)
    records, clocks = {}, []
    sample = Reservoir(traffic["check_requests"], seed, records)

    def request(i: int, clock: StageClock | None, keep: bool):
        sc = pool[i % len(pool)]
        gen = torch.Generator(device=dev).manual_seed(inputs.ransac_seed(seed, i))
        args = [torch.from_numpy(sc[k]) for k in ("images", "intrinsics", "near", "far")]
        recorder.on = keep
        with torch.no_grad():
            enc, answer = respond(model, args, gen, clock)
        recorder.on = False
        if keep:  # device tensors, copied to the host once the window has closed
            answer.update(sc, ransac_seed=inputs.ransac_seed(seed, i), **recorder.take(),
                          depths=enc.depths, gaussians=tuple(enc.gaussians))
            records[i] = answer

    for i in range(traffic["warmup_requests"]):
        request(traffic["pool"] + i, None, False)
    synchronize(dev)
    setup_done = time.perf_counter()

    def one(i):
        clock = StageClock(dev).start()
        request(i, clock, sample.take(i))
        clocks.append(clock)

    win = Window(dev).run(one, seconds)
    device_fields = ("frozen", "corr", "keypoints", "matches", "descriptors", "depths",
                     "gaussians")
    for k in records.values():
        k.update({f: host(k[f]) for f in device_fields})
    views = traffic["views"]
    pairs = views * (views - 1) // 2
    matches = [int(k["corr"][3].sum()) for k in records.values()]
    rec = dict(setup_done=setup_done, **win, stage_ms=[c.stage_ms() for c in clocks],
               info={"valid_matches_a_pair": sum(matches) / len(matches) / pairs})
    if trace_dir is not None:
        def profiled():
            n = traffic["profile_requests"]
            for j in range(n):
                request(10**6 + j, None, False)
            return n
        rec["trace"] = profile(dev, trace_dir, profiled)
    recorder.close()
    rec["checked"] = records
    return rec


def serve_gaps(tree: dict, rec: dict, prog_stats: dict, seed: int, device, subject: str,
               answer, control_precisions, detail: dict | None = None) -> dict:
    """The worst gap of each number over the checked requests of a serving
    loop. `answer(model, gaussians, poses, req, device)` is the loop's
    answer worked out by the reference; `subject` "control" puts the
    control in the program's place at `control_precisions`."""
    ref = check.build_reference(tree, device)
    inputs.load_weights(ref, inputs.make_weights(prog_stats, seed, device))
    worst: dict = {}
    for req in rec["checked"].values():
        if subject == "control":
            req = check.control_record(ref, req, answer, device, *control_precisions)
        elif subject != "program":
            raise ValueError(f"a serving check has no subject {subject!r}")
        fields = None if detail is None else {}
        if detail is not None:
            detail.setdefault("requests", []).append(fields)
        for k, v in check.serve_gaps(ref, req, answer, device, fields).items():
            worst[k] = max(worst.get(k, 0.0), v)
    del ref
    return worst


def wall_quartiles(wall_ms: list[float]) -> list[float]:
    return [float(x) for x in np.percentile(wall_ms, [0, 25, 50, 75, 100])]
