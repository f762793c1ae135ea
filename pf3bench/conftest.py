"""Loaded by pytest before `tests/conftest.py`: registers with the tiny
benchmark of the CPU tests (`tests/pf3bench_tiny.py`, whose `TINY_OF` names
the tiny cells that stand for each real cell) the cells that have no tiny
stand-in in that table, so that `write_tiny` maps their metrics to none.
NoPoSplat's cell has its own tiny copy in `tests/test_pf3bench_noposplat.py`."""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent / "tests"))

import pf3bench_tiny  # noqa: E402

pf3bench_tiny.TINY_OF.setdefault("noposplat-train.b14v6", [])
