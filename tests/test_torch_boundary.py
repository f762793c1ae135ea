"""Package boundary of the PyTorch port: it imports torch, numpy and scipy,
never jax, flax or anything of the JAX package; GPU-only checks of its
kernels carry the `cuda` marker and skip without a card."""

from __future__ import annotations

import ast
import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "pf3plat_tpu_torch"
FORBIDDEN = ("jax", "flax", "pf3plat_tpu")


def _port_files():
    return sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: str(p.relative_to(REPO)))
def test_no_forbidden_imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        names = []
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        for name in names:
            root = name.split(".")[0]
            assert root not in FORBIDDEN, f"{path.name} imports {name}"


def test_imports_with_jax_blocked():
    """Every port module imports in a fresh interpreter where importing
    jax, flax or pf3plat_tpu fails."""
    code = (
        "import sys, pkgutil, importlib\n"
        "for m in ('jax', 'flax', 'pf3plat_tpu'):\n"
        "    sys.modules[m] = None\n"
        "import pf3plat_tpu_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages(pf3plat_tpu_torch.__path__, "
        "'pf3plat_tpu_torch.')]\n"
        "for m in mods:\n"
        "    importlib.import_module(m)\n"
        "assert not any(k == 'jax' or k.startswith(('jax.', 'flax')) for k in sys.modules "
        "if sys.modules[k] is not None)\n"
        "print(len(mods))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 20


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; chip_smoke.py runs these checks on the card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_kernels_match_plain_on_card(card):
    """B1 bit-exact and B2 within 1e-5 of their plain versions on a random
    scene (the full-size checks are chip_smoke.py's)."""
    import numpy as np

    from pf3plat_tpu_torch.ops.rasterizer import RasterizeConfig, compact, streamed
    from pf3plat_tpu_torch.ops.rasterizer.project import make_camera, project_gaussians
    from test_torch_helpers import make_scene_np

    cfg = RasterizeConfig(pairs_budget_factor=0.6, compact_min_pairs=0, compact_window=512)
    scene = {k: torch.as_tensor(v, device=card)
             for k, v in make_scene_np(np.random.default_rng(0), n=2000, b=2).items()}
    cam = make_camera(scene["extrinsics"], scene["intrinsics"], (64, 96))
    screen = project_gaussians(cam, scene["means"], scene["covariances"], scene["opacities"],
                               scene["sh"], 4, cfg)
    cand = compact.build_candidates(screen, (64, 96), cfg)
    budget = compact.pairs_budget(cfg, 2, 2000)
    got = compact.compact_candidates_cuda(cand, budget, 512)
    ref = compact.compact_candidates_plain(cand, budget, 512)
    for key in ("tile", "dkey", "ids", "counts"):
        assert torch.equal(got[key], ref[key]), key
    assert torch.equal(got["feats"].view(torch.int32), ref["feats"].view(torch.int32))
    args, _ = streamed.prepare_streamed(screen, (64, 96), scene["background"], cfg)
    for a, r in zip(streamed.composite_fwd_cuda(**args), streamed.composite_fwd_plain(**args)):
        assert float((a - r).abs().max()) <= 1e-5


def test_model_entry_point_needs_device_off_card():
    """PF3plat defaults to cuda; without a card it raises unless the caller
    passes device="cpu"."""
    from pf3plat_tpu_torch.models.pf3plat import PF3plat, PF3platCfg

    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PF3plat(PF3platCfg())
