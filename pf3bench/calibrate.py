"""The readings that the limits of a cell's check are set from, on the card
at the cell's own size, in one process:

    python3 -m pf3bench.calibrate --workload <name> --seeds 11,12,13 --seconds 4 \
        [--subjects control[,tf32]] [--fault <fault>] [--float32] [--out <file>]

For each seed: a run of the cell by the benchmark's own `run_cell` with a
short window at the cell's own load, and the numbers its check compares;
with `--subjects` also those of the loop's other subjects judged in the
program's place (`control`: the reference one precision step down;
`tf32`, in training: the reference with its products' operands rounded to
TF32); with `--fault` the program with that fault planted; with
`--float32` the program with TF32 off for its products (a witness).
One JSON line a seed on standard output, and with `--out` each seed's
whole look (in training every leaf's norms) as a line of that file.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import torch

from .run import prepare_environment, run_cell
from .spec import Benchmark


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--seconds", type=float, default=4.0)
    ap.add_argument("--subjects", default="", help="comma-separated")
    ap.add_argument("--fault", default=None)
    ap.add_argument("--float32", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    prepare_environment()
    if args.float32:
        from pf3plat_tpu_torch import precision

        precision.TF32 = False
    bench = Benchmark()
    subjects = tuple(s for s in args.subjects.split(",") if s)
    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.perf_counter()
        look: dict = {}
        got = run_cell(bench, args.workload, seed, args.seconds, False, torch.device("cuda"),
                       fault=args.fault, t0=t, subjects=subjects, look=look)
        line = {"seed": seed, "fault": args.fault, "float32": args.float32,
                "program": {k: c["value"] for k, c in got["checks"].items()},
                **got.get("subjects", {}), "count": got["attempted"],
                "seconds": time.perf_counter() - t}
        print(json.dumps(line), flush=True)
        if args.out:
            with open(Path(args.out), "a") as f:
                f.write(json.dumps(dict(line, look=look)) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
