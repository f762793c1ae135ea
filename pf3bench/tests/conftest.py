"""Fixtures of the benchmark's CPU tests."""

from __future__ import annotations

import pytest
import torch
from pf3bench_tiny import write_tiny


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    from pf3bench.spec import Benchmark

    torch.set_num_threads(2)
    root = write_tiny(tmp_path_factory.mktemp("tiny"))
    return Benchmark(root, root / "pf3bench")


@pytest.fixture
def cuda():
    """Skips a test without a CUDA device, decided when the test runs."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
