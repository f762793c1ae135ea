"""One run of one benchmark cell on the card:

    python3 -m pf3bench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

Set-up builds the port's model of the cell's configuration as the
architecture that the configuration names builds it (`architectures/`),
with weights made on the device from the seed, and warms up the cell's
shapes; the window then runs the cell's traffic for `--seconds` through the
loop its traffic file names (`loops/<kind>.py`); with `--trace 1` a short
profiled sub-window follows. The program's state is freed and the plain
reference (`check.py`) judges what the window produced. The last line of
standard output is the result as one JSON object; the numbers compared are
the last lines of standard error and the result's last key.

Without CUDA, or with fewer cards than the cell asks for, the run prints no
result and exits with 2. It exits with 3 and no result if a module of JAX or
of the JAX package is loaded once the window has closed.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402


FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "pf3plat_tpu")
OUT = Path(__file__).resolve().parent / "out"


def forbidden_modules(names=None) -> list[str]:
    """The loaded modules whose top-level name (before the first dot) is,
    whole, one of `FORBIDDEN`."""
    names = sys.modules if names is None else names
    return sorted({n.split(".")[0] for n in names} & set(FORBIDDEN))


def prepare_environment() -> None:
    """Kernel caches at fixed paths inside the checkout; no library loads
    JAX on its own."""
    os.environ["TRITON_CACHE_DIR"] = str(OUT / "cache" / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(OUT / "cache" / "torch_extensions")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def power_limit() -> str | None:
    try:
        got = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return got.stdout.strip().splitlines()[0] if got.returncode == 0 and got.stdout else None


def run_cell(bench, workload: str, seed: int, seconds: float, trace: bool, device,
             fault: str | None = None, t0: float = T0, out: Path = OUT,
             subjects: tuple[str, ...] = (), look: dict | None = None) -> dict:
    """One run of `workload`; the result object (without the device keys
    that only a card gives). The cell's traffic names its loop
    (`loops/<kind>.py`). `fault` plants one of the loop's faults; each of
    `subjects` (the loop's "control", ...) is judged as well, after the
    program, under `result["subjects"]`; `look` receives what the check
    saw."""
    import torch

    from . import harness

    device = torch.device(device)
    cell = bench.cell(workload)
    tree = bench.config(cell["config"])["config"]
    traffic = bench.traffic(cell["traffic"])
    loop = bench.loop(traffic["kind"])
    work = bench.work(workload)
    prog = harness.Program(bench.architecture(cell["config"]), tree, device, seed, out / "stats")
    trace_dir = out / "traces" / workload if trace else None
    rec = loop.run(prog, traffic, seed, seconds, trace_dir, out / "data" / cell["traffic"], fault)
    setup_s = rec["setup_done"] - t0
    t_check = time.perf_counter()
    leaf_stats = prog.stats
    prog.close()
    look = {} if look is None else look
    gaps = loop.gaps(tree, rec, leaf_stats, seed, device, traffic, detail=look.setdefault(
        "program", {}))
    check_s = time.perf_counter() - t_check
    others = {s: loop.gaps(tree, rec, leaf_stats, seed, device, traffic, subject=s,
                           detail=look.setdefault(s, {})) for s in subjects}
    run = dict(cell=cell, traffic=traffic, work=work, record=rec, setup_s=setup_s)
    metrics = {}
    for m in bench.metrics(workload, trace):
        value = bench.reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    limits = work.get("limits", {})
    checks = {k: {"value": v, "limit": limits.get(k)} for k, v in sorted(gaps.items())}
    correct = all(c["limit"] is not None and math.isfinite(c["value"])
                  and c["value"] <= c["limit"] for c in checks.values())
    result = {"correct": correct, "attempted": rec["count"], "failed": 0, "metrics": metrics,
              "device": {"platform": "gpu" if device.type == "cuda" else device.type,
                         "count": 1, "memory_peak_bytes": rec["peak_bytes"]}}
    if "trace" in rec:
        t = rec["trace"]
        result["device"].update(busy_s=t["busy_s"], window_s=t["window_s"])
        result["breakdown"] = {"device_ops": [[n, s] for n, s, _ in t["ops"][:10]],
                               "idle_gaps": [[n, s] for n, s in t["gaps"][:10]]}
    result["info"] = dict(rec.get("info", {}), setup_s=setup_s, check_s=check_s,
                          wall_ms_quartiles=harness.wall_quartiles(rec["wall_ms"]),
                          look={k: v for k, v in look["program"].items() if k != "leaves"})
    if subjects:
        result["subjects"] = others
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    prepare_environment()

    import torch

    from .spec import Benchmark

    bench = Benchmark()
    chips = bench.cell(args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"pf3bench: the cell needs {chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available",
              file=sys.stderr)
        return 2
    result = run_cell(bench, args.workload, args.seed, args.seconds, bool(args.trace), "cuda")
    result["device"].update(kind=torch.cuda.get_device_name(0), count=chips,
                            power_limit=power_limit())
    bad = forbidden_modules()
    if bad:
        print(f"pf3bench: modules of JAX or the JAX package are loaded: {bad}", file=sys.stderr)
        return 3
    print(json.dumps({"info": result.pop("info")}), flush=True)
    checks = result.pop("checks")
    result["checks"] = checks
    print(json.dumps(result), flush=True)
    for name, c in checks.items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
