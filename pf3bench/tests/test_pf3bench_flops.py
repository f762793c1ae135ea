"""The FLOP-count tool at the tiny configuration."""

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from pf3bench import flops


def test_counts_a_linear_layer():
    lin = torch.nn.Linear(16, 8)
    with FlopCounterMode(display=False) as fc:
        lin(torch.ones(4, 16))
    assert fc.get_total_flops() == 2 * 4 * 16 * 8


@pytest.mark.parametrize("workload", ["tiny.tserve", "tiny.ttrain"])
def test_tiny_counts(tiny, workload):
    got = flops.count(tiny, workload, torch.device("cpu"))
    assert got["model_flops"] > 1e8
    if workload != "tiny.ttrain":
        calls = got["attention_calls"]
        assert calls and all(c["count"] >= 1 and min(c["n"], c["m"], c["d"]) >= 1 for c in calls)


def test_attention_calls_record_shapes():
    rec = flops.AttentionCalls()
    q = torch.zeros(2, 3, 5, 8)
    k = torch.zeros(2, 3, 7, 8)
    with rec:
        torch.nn.functional.scaled_dot_product_attention(q, k, k)
        torch.nn.functional.scaled_dot_product_attention(q, k, k)
    assert rec.as_list() == [dict(b=6, h=1, n=5, m=7, d=8, count=2)]
