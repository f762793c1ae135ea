"""The control of each check, the reference one precision step down in
the program's place, reads above the program, at a test size on the CPU
(on the card at the cells' own sizes: `pf3bench.calibrate --subjects
control`). The card-only case runs the control at the eval cell's size."""

import pytest
import torch

from pf3bench.run import run_cell
from pf3bench.spec import Benchmark

SEED = 2**31 + 5


def _readings(bench, workload, device, seconds, out):
    r = run_cell(bench, workload, SEED, seconds, False, device, out=out, subjects=("control",))
    return {k: c["value"] for k, c in r["checks"].items()}, r["subjects"]["control"]


def test_serve_control_reads_above_the_program(tiny, tmp_path):
    program, control = _readings(tiny, "tiny.tserve", torch.device("cpu"), 1.0, tmp_path)
    for k in ("perceive", "keypoints", "lightglue", "harmonics"):
        assert control[k] > 3 * program[k], k
    assert control["color"] > program["color"]


def test_train_control_reads_above_the_program(tiny, tmp_path):
    program, control = _readings(tiny, "tiny.ttrain", torch.device("cpu"), 0.5, tmp_path)
    assert all(control[k] > 3 * program[k] for k in program), (program, control)


@pytest.mark.cuda
def test_control_at_the_eval_cells_size(cuda, tmp_path):
    program, control = _readings(Benchmark(), "re10k-serve.eval", torch.device("cuda"), 3.0,
                                 tmp_path)
    assert max(control[k] / max(program[k], 1e-12) for k in program) >= 3
