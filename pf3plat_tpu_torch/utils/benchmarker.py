"""Wall-clock + device benchmarking utilities.

Port of `pf3plat_tpu/utils/benchmarker.py` (the reference's `Benchmarker`,
`src/misc/benchmarker.py:15-41`): tagged context-manager timing with warmup
skipping, JSON dumps, and peak device memory. On the card each timed block
ends in `torch.cuda.synchronize(device)`, and memory comes from
`torch.cuda` (`memory_allocated`, `max_memory_allocated`, the device's
total memory), as the reference reads `torch.cuda.memory_stats`. Without a
CUDA device there is nothing to wait for, and `dump_memory` writes the
JAX package's CPU result: the three keys with null values.
"""

from __future__ import annotations

import json
import time
from collections import defaultdict
from contextlib import contextmanager
from pathlib import Path

import numpy as np
import torch


def sync(device=None) -> None:
    """Wait for the work queued on `device` (a CUDA device; otherwise there
    is nothing to wait for)."""
    if device is not None and torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


class Benchmarker:
    def __init__(self, skip_first: int = 0, device=None):
        self.execution_times: dict[str, list[float]] = defaultdict(list)
        self.skip_first = skip_first
        self.device = None if device is None else torch.device(device)

    @contextmanager
    def time(self, tag: str, num_calls: int = 1):
        start = time.perf_counter()
        try:
            yield
        finally:
            sync(self.device)
            elapsed = time.perf_counter() - start
            for _ in range(num_calls):
                self.execution_times[tag].append(elapsed / num_calls)

    def summarize(self) -> dict:
        out = {}
        for tag, times in self.execution_times.items():
            kept = times[self.skip_first:] or times
            out[tag] = {
                "mean_s": float(np.mean(kept)),
                "median_s": float(np.median(kept)),
                "count": len(kept),
            }
        return out

    def dump(self, path: Path) -> None:
        path = Path(path)
        path.parent.mkdir(exist_ok=True, parents=True)
        path.write_text(json.dumps(self.summarize(), indent=2))

    def dump_memory(self, path: Path) -> None:
        path = Path(path)
        path.parent.mkdir(exist_ok=True, parents=True)
        stats = {"bytes_in_use": None, "peak_bytes_in_use": None, "bytes_limit": None}
        if self.device is not None and self.device.type == "cuda":
            stats = {
                "bytes_in_use": torch.cuda.memory_allocated(self.device),
                "peak_bytes_in_use": torch.cuda.max_memory_allocated(self.device),
                "bytes_limit": torch.cuda.get_device_properties(self.device).total_memory,
            }
        path.write_text(json.dumps(stats, indent=2))

    def clear_history(self) -> None:
        self.execution_times = defaultdict(list)
