"""No run loads JAX or the JAX package, and the reference loads nothing of
the program: the top-level name of every module, compared whole."""

import json
import subprocess
import sys
from pathlib import Path

from pf3bench.run import FORBIDDEN, forbidden_modules

ROOT = Path(__file__).resolve().parents[2]


def loaded_after(code: str) -> list[str]:
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys, json; print(json.dumps(sorted(sys.modules)))"],
        cwd=ROOT, capture_output=True, text=True, timeout=300, check=True)
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_top_level_names_compared_whole():
    assert forbidden_modules(["pf3plat_tpu_torch", "pf3plat_tpu_torch.models.encoder",
                              "numpy", "jaxtyping", "flaxen"]) == []
    assert forbidden_modules(["pf3plat_tpu", "pf3plat_tpu.models"]) == ["pf3plat_tpu"]
    assert forbidden_modules(["jax.numpy", "jaxlib.xla_client", "flax.linen", "optax",
                              "orbax.checkpoint"]) == sorted(FORBIDDEN[:-1])


def test_harness_import_path_loads_no_jax():
    names = loaded_after(
        "import pf3bench.run, pf3bench.harness, pf3bench.check, pf3bench.flops, "
        "pf3bench.calibrate\n"
        "from pf3bench.spec import Benchmark\n"
        "for kind in ('serve', 'train'):\n"
        "    Benchmark().loop(kind)\n"
        "import pf3plat_tpu_torch.main, pf3plat_tpu_torch.models.pf3plat, "
        "pf3plat_tpu_torch.training.train\n"
        "from pf3plat_tpu_torch.utils.config import load_config")
    assert "pf3plat_tpu_torch" in {n.split(".")[0] for n in names}
    assert forbidden_modules(names) == []


def test_reference_imports_nothing_of_the_program():
    names = loaded_after("import pf3bench.check, pf3bench.flops")
    tops = {n.split(".")[0] for n in names}
    assert "pf3plat_tpu_torch" not in tops and not (tops & set(FORBIDDEN))
