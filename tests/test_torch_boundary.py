"""Package boundary of the PyTorch port: it imports torch, numpy, scipy, PIL
and yaml, never jax, flax, optax or anything of the JAX package; GPU-only
checks of its kernels carry the `cuda` marker and skip without a card."""

from __future__ import annotations

import ast
import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "pf3plat_tpu_torch"
FORBIDDEN = ("jax", "flax", "optax", "pf3plat_tpu")


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
    jax, flax, optax or pf3plat_tpu fails."""
    code = (
        "import sys, pkgutil, importlib\n"
        "for m in ('jax', 'flax', 'optax', 'pf3plat_tpu'):\n"
        "    sys.modules[m] = None\n"
        "import pf3plat_tpu_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages(pf3plat_tpu_torch.__path__, "
        "'pf3plat_tpu_torch.')]\n"
        "for m in mods:\n"
        "    importlib.import_module(m)\n"
        "assert not any(k == 'jax' or k.startswith(('jax.', 'flax', 'optax')) for k in sys.modules "
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
    """B1 and B4 bit-exact, B2 within 1e-5 and B3 within 1e-4 of the
    largest value per channel, against their plain versions on a random
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
    args, extra = streamed.prepare_streamed(screen, (64, 96), scene["background"], cfg)
    fwd = streamed.composite_fwd_cuda(**args)
    for a, r in zip(fwd, streamed.composite_fwd_plain(**args)):
        assert float((a - r).abs().max()) <= 1e-5
    _, tfin, tchk = fwd
    rows = args["base"].shape[0]
    g_tiles = torch.as_tensor(np.random.default_rng(1).standard_normal((rows, 3, 256)),
                              dtype=torch.float32, device=card)
    bwd = [args["featP"], args["base"], args["off"], args["counts"], args["tile_ids"],
           streamed.n_processed(tchk), args["bg_rows"], tfin, tchk, g_tiles, args["tiles_x"], 3,
           cfg]
    got = streamed.composite_bwd_cuda(*bwd)
    ref = streamed.composite_bwd_plain(*bwd)
    for k in range(9):
        assert float((got[0][k] - ref[0][k]).abs().max()) <= 1e-4 * float(ref[0][k].abs().max())
    assert float((got[1] - ref[1]).abs().max()) <= 1e-4 * float(ref[1].abs().max())
    ids_u, perm = torch.sort(extra["ids_sorted"])
    grads = got[0][:, : ids_u.numel()][:, perm].contiguous()
    red = compact.dup_reduce_cuda(grads, ids_u.contiguous(), 4000, cfg.max_dup)
    ref = compact.dup_reduce_plain(grads, ids_u.contiguous(), 4000, cfg.max_dup)
    assert torch.equal(red.view(torch.int32), ref.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("window", [512, 4096, 4224, 8192])
def test_b1_edges_match_plain_on_card(card, window):
    """B1 bit for bit against its plain version, and two runs equal, at the
    edges of its window rule: windows of one 4,096-row slice and of several
    (4,224 and 8,192); a candidate count no multiple of the window;
    none, some and all rows valid; the budget at which window k is just
    appended (`budget_fit`) and 128 rows less, at which it and every later
    window are dropped (the full-size sweep is chip_smoke.py's)."""
    import numpy as np

    from pf3plat_tpu_torch.ops.rasterizer import compact

    n_cand = 9 * window + 200
    rng = np.random.default_rng(3)
    cand = dict(
        tile=torch.as_tensor(rng.integers(0, 2**31 - 1, n_cand, dtype=np.int32), device=card),
        dkey=torch.as_tensor(rng.integers(0, 2**31 - 1, n_cand, dtype=np.int32), device=card),
        pid=torch.arange(n_cand, dtype=torch.int32, device=card),
        feats=torch.as_tensor(rng.standard_normal((9, n_cand), dtype=np.float32), device=card))
    for valid in (rng.random(n_cand) < 0.6, np.zeros(n_cand, bool), np.ones(n_cand, bool)):
        c = dict(cand, valid=torch.as_tensor(valid, device=card))
        cnt = np.bincount(np.arange(n_cand) // window, weights=valid, minlength=10)
        fit = (int(cnt[:4].sum()) // 128) * 128 + window + 128  # window 4 just appended
        for budget in (fit, fit - 128):
            got = compact.compact_candidates_cuda(c, budget, window)
            ref = compact.compact_candidates_plain(c, budget, window)
            again = compact.compact_candidates_cuda(c, budget, window)
            for out in (ref, again):
                for key in ("tile", "dkey", "ids", "counts"):
                    assert torch.equal(got[key], out[key]), (key, budget)
                assert torch.equal(got["feats"].view(torch.int32), out["feats"].view(torch.int32))
            written = int(got["counts"][0])
            if budget == fit:
                assert written >= int(cnt[:5].sum())
            else:
                assert written == int(cnt[:4].sum())


@pytest.mark.cuda
@pytest.mark.parametrize(
    "kw,channels",
    [(dict(), 3), (dict(tile_capacity=256, chunk=64), 3), (dict(tile_capacity=256), 1),
     (dict(tile_size=32), 3), (dict(tile_size=32, chunk=64), 3),
     (dict(tile_size=12, tile_capacity=256, chunk=64), 3)],
    ids=["cap1024-chunk128", "cap256-chunk64", "one-channel", "tile32-chunk128",
         "tile32-chunk64", "tile12-chunk64"],
)
def test_table_kernels_match_plain_on_card(card, kw, channels):
    """B6 within 1e-5 (image, final T, checkpoints) and B7 within 1e-4 of
    the largest value per table column, against their plain versions, with a
    cotangent on the final T too, and two runs of each bit-equal; tiles of
    32 x 32 pixels at chunk 128 and 64, walked in 4 parts, and of 12 x 12
    pixels (144 on 160 lanes: idle lanes) (the full-size checks are
    chip_smoke.py's)."""
    import numpy as np

    from pf3plat_tpu_torch.ops.rasterizer import RasterizeConfig, binning, pallas_impl
    from pf3plat_tpu_torch.ops.rasterizer.project import make_camera, project_gaussians
    from test_torch_helpers import make_scene_np

    cfg = RasterizeConfig(**kw)
    scene = {k: torch.as_tensor(v, device=card)
             for k, v in make_scene_np(np.random.default_rng(0), n=4000, b=2, spread=0.6).items()}
    cam = make_camera(scene["extrinsics"], scene["intrinsics"], (64, 96))
    sh = scene["sh"][:, :, :channels, :1] if channels == 1 else scene["sh"]
    screen = project_gaussians(cam, scene["means"], scene["covariances"], scene["opacities"],
                               sh, 4, cfg, use_sh=channels == 3)
    binned = binning.bin_gaussians_batched(screen, (64, 96), cfg)
    bg = torch.full((2, channels), 0.3, device=card)
    args = pallas_impl.prepare_tables(screen, binned, bg, cfg)
    assert int(args["counts"].max()) > cfg.chunk  # more than one chunk walked
    fwd = pallas_impl.composite_table_fwd_cuda(**args)
    for a, r in zip(fwd, pallas_impl.composite_table_fwd_plain(**args)):
        assert float((a - r).abs().max()) <= 1e-5
    again = pallas_impl.composite_table_fwd_cuda(**args)
    assert all(torch.equal(a, b) for a, b in zip(fwd, again))
    _, tfin, tchk = fwd
    rows, p = args["table"].shape[0], cfg.tile_size ** 2
    rng = np.random.default_rng(1)
    g_img = torch.as_tensor(rng.standard_normal((rows, channels, p)), dtype=torch.float32,
                            device=card)
    g_tfin = torch.as_tensor(rng.standard_normal((rows, 1, p)), dtype=torch.float32,
                             device=card)
    bwd = [args["table"], args["counts"], args["tile_ids"], args["bg_rows"], tfin, tchk, g_img,
           g_tfin, args["tiles_x"], channels, cfg]
    got = pallas_impl.composite_table_bwd_cuda(*bwd)
    ref = pallas_impl.composite_table_bwd_plain(*bwd)
    for a, r in zip(got, ref):
        for k in range(a.shape[-1]):
            assert float((a[..., k] - r[..., k]).abs().max()) <= 1e-4 * float(r[..., k].abs().max())
    again = pallas_impl.composite_table_bwd_cuda(*bwd)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.cuda
def test_mesh_and_attention_kernels_on_card(card):
    """B5 against its plain version and, merged, against B3; the attention
    kernels against their plain versions at a ragged size; and what the new
    wrappers refuse: a wrong dtype, a non-contiguous input, rows that do not
    divide by the shard count (the full-size checks are chip_smoke.py's)."""
    import numpy as np

    from pf3plat_tpu_torch.models import layers
    from pf3plat_tpu_torch.ops.rasterizer import RasterizeConfig, render, streamed
    from pf3plat_tpu_torch.ops.rasterizer.project import make_camera, project_gaussians
    from pf3plat_tpu_torch.parallel import MeshCfg, make_mesh
    from test_torch_helpers import make_scene_np

    cfg = RasterizeConfig()
    scene = {k: torch.as_tensor(v, device=card)
             for k, v in make_scene_np(np.random.default_rng(0), n=2000, b=2).items()}
    cam = make_camera(scene["extrinsics"], scene["intrinsics"], (64, 96))
    screen = project_gaussians(cam, scene["means"], scene["covariances"], scene["opacities"],
                               scene["sh"], 4, cfg)
    args, _ = streamed.prepare_streamed(screen, (64, 96), scene["background"], cfg)
    _, tfin, tchk = streamed.composite_fwd_cuda(**args)
    rows = args["base"].shape[0]
    g_tiles = torch.as_tensor(np.random.default_rng(1).standard_normal((rows, 3, 256)),
                              dtype=torch.float32, device=card)
    bwd = [args["featP"], args["base"], args["off"], args["counts"], args["tile_ids"],
           streamed.n_processed(tchk), args["bg_rows"], tfin, tchk, g_tiles, args["tiles_x"], 3,
           cfg]
    blk, dbg = streamed.composite_bwd_blocks_cuda(*bwd)
    ref_blk, ref_dbg = streamed.composite_bwd_blocks_plain(*bwd)
    for k in range(9):
        assert float((blk[:, :, k] - ref_blk[:, :, k]).abs().max()) \
            <= 1e-4 * float(ref_blk[:, :, k].abs().max())
    assert float((dbg - ref_dbg).abs().max()) <= 1e-4 * float(ref_dbg.abs().max())
    dP, _ = streamed.composite_bwd_cuda(*bwd)
    merged = streamed.merge_blocks(blk, args["base"], args["featP"].shape[1])
    assert float((merged - dP).abs().max()) <= 1e-6 * float(dP.abs().max())
    with pytest.raises(ValueError, match="float32"):
        streamed.composite_bwd_blocks_cuda(args["featP"].double(), *bwd[1:])
    with pytest.raises(ValueError, match="contiguous"):
        streamed.composite_bwd_blocks_cuda(*bwd[:9], g_tiles.transpose(1, 2).contiguous()
                                           .transpose(1, 2), *bwd[10:])
    ts = {k: v for k, v in scene.items()}
    with pytest.raises(ValueError, match="tile rows not divisible by mesh size 5"):
        render(**ts, image_shape=(64, 96), impl="streamed", config=cfg, device=card,
               mesh=make_mesh(MeshCfg(data_axis=5, tile_axis=1), device=card))

    rng = np.random.default_rng(2)
    q, k, v, g = (torch.as_tensor(rng.standard_normal((2, 3, nn, 64)), dtype=torch.float32,
                                  device=card).to(torch.bfloat16)
                  for nn in (2049, 2305, 2305, 2049))
    out, lse = layers.attention_fwd_cuda(q, k, v, 0.125)
    ref_out, ref_lse = layers.attention_fwd_plain(q, k, v, 0.125)
    assert float((out - ref_out).abs().max()) <= 1e-2 * float(ref_out.abs().max())
    assert float((lse - ref_lse).abs().max()) <= 1e-3
    grads = layers.attention_bwd_cuda(q, k, v, out, lse, g, 0.125)
    for a, r in zip(grads, layers.attention_bwd_plain(q, k, v, out, lse, g, 0.125)):
        assert float((a - r).abs().max()) <= 1e-2 * float(r.abs().max())
    with pytest.raises(ValueError, match="bfloat16"):
        layers.attention_fwd_cuda(q.float(), k, v, 0.125)
    with pytest.raises(ValueError, match="contiguous"):
        layers.attention_fwd_cuda(q, k.transpose(1, 2).contiguous().transpose(1, 2), v, 0.125)
    with pytest.raises(ValueError, match="head dim"):
        layers.attention_fwd_cuda(q[..., :48].contiguous(), k[..., :48].contiguous(),
                                  v[..., :48].contiguous(), 0.125)


def _saturating_screen(device):
    """One 32 x 48 view whose six 16 x 16 tiles hold 37-47 gaussians each,
    all covering their whole tile, depth-sorted as listed; the tiles take
    turns among fronts of 0.995 (every pixel dead at the segment's second or
    third pair, mostly inside its first sub-block), 0.5 (dead near the 14th pair)
    and 0.04 (alive to the end)."""
    import numpy as np

    from pf3plat_tpu_torch.ops.rasterizer.types import ScreenGaussians

    rng = np.random.default_rng(3)
    parts = {k: [] for k in ("xy", "depth", "conic", "radius", "color", "opacity")}
    for t in range(6):
        k = 37 + 2 * t
        op = np.full(k, (0.04, 0.5, 0.04)[t % 3])
        if t % 3 == 0:
            op[:3] = 0.995
        cx, cy = (t % 3) * 16 + 8.0, (t // 3) * 16 + 8.0
        parts["xy"].append(np.stack([cx + rng.uniform(-0.5, 0.5, k),
                                     cy + rng.uniform(-0.5, 0.5, k)], -1))
        parts["depth"].append(1.0 + t + np.arange(k) * 1e-3)
        parts["conic"].append(np.tile([1e-4, 0.0, 1e-4], (k, 1)))
        parts["radius"].append(np.full(k, 7.5))
        parts["color"].append(rng.uniform(0, 1, (k, 3)))
        parts["opacity"].append(op)
    f = {k: torch.as_tensor(np.concatenate(v)[None], dtype=torch.float32, device=device)
         for k, v in parts.items()}
    return ScreenGaussians(valid=torch.ones_like(f["depth"], dtype=torch.bool), **f)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["saturating", "nproc_edges", "one_channel", "chunk64",
                                  "chunk4", "tile32_chunk32", "tile24_chunk64", "tile12",
                                  "tile20_chunk64"])
def test_composite_bwd_walk_edges_on_card(card, case):
    """B3 and B5 at the edges of their sub-block walk, against their plain
    versions (1e-4 of the largest value per feature row), merged B5 equal to
    B3, two runs bit-equal: tiles saturating inside their first sub-block;
    nproc 0 and n_chunks (chunks the forward never reached); one channel;
    chunk 64; chunk 4 (a sub-block padded past the chunk); tiles of 1024
    and 576 pixels (walked in 4 parts of 256 and 3 of 192); tiles of 144
    and 400 pixels, no multiple of 32 (idle lanes; 400 in 2 parts of 224).
    Then what the wrappers refuse: a tile of more than 1024 pixels (the
    full-size sweep is chip_smoke.py's)."""
    import dataclasses

    import numpy as np

    from pf3plat_tpu_torch.ops.rasterizer import RasterizeConfig, streamed
    from pf3plat_tpu_torch.ops.rasterizer.project import make_camera, project_gaussians
    from test_torch_helpers import make_scene_np

    ts, chunk = {"chunk64": (16, 64), "chunk4": (16, 4), "tile32_chunk32": (32, 32),
                 "tile24_chunk64": (24, 64), "tile12": (12, 128),
                 "tile20_chunk64": (20, 64)}.get(case, (16, 128))
    cfg = RasterizeConfig(tile_size=ts, tile_capacity=256, chunk=chunk)
    shape = (64, 96)
    if case == "saturating":
        screen, shape = _saturating_screen(card), (32, 48)
        bg = torch.full((1, 3), 0.3, device=card)
    else:
        scene = {k: torch.as_tensor(v, device=card)
                 for k, v in make_scene_np(np.random.default_rng(0), n=4000, b=2,
                                           spread=0.6).items()}
        cam = make_camera(scene["extrinsics"], scene["intrinsics"], shape)
        screen = project_gaussians(cam, scene["means"], scene["covariances"],
                                   scene["opacities"], scene["sh"], 4, cfg)
        bg = scene["background"]
        if case == "one_channel":
            screen = screen._replace(color=screen.color[..., :1].contiguous())
            bg = bg[:, :1].contiguous()
    args, _ = streamed.prepare_streamed(screen, shape, bg, cfg)
    _, tfin, tchk = streamed.composite_fwd_cuda(**args)
    rows, ch = args["base"].shape[0], args["channels"]
    n_chunks = cfg.tile_capacity // cfg.chunk + 1
    nproc = streamed.n_processed(tchk)
    if case == "nproc_edges":
        r = torch.arange(rows, device=card)
        nproc = torch.where(r % 3 == 0, 0, torch.where(r % 3 == 1, n_chunks, nproc))
        nproc = nproc.to(torch.int32).contiguous()
    g_tiles = torch.as_tensor(np.random.default_rng(1).standard_normal((rows, ch, ts * ts)),
                              dtype=torch.float32, device=card)
    bwd = [args["featP"], args["base"], args["off"], args["counts"], args["tile_ids"], nproc,
           args["bg_rows"], tfin, tchk, g_tiles, args["tiles_x"], ch, cfg]
    assert int((args["off"] % 8 != 0).sum()) > 0  # segments start mid-sub-block
    dP, dbg = streamed.composite_bwd_cuda(*bwd)
    blk, dbg5 = streamed.composite_bwd_blocks_cuda(*bwd)
    ref, ref_dbg = streamed.composite_bwd_plain(*bwd)
    for k in range(9):
        assert float((dP[k] - ref[k]).abs().max()) <= 1e-4 * float(ref[k].abs().max())
    assert float((dbg - ref_dbg).abs().max()) <= 1e-4 * float(ref_dbg.abs().max())
    assert torch.equal(streamed.merge_blocks(blk, args["base"], args["featP"].shape[1]), dP)
    assert torch.equal(dbg5, dbg)
    again = streamed.composite_bwd_cuda(*bwd)
    assert torch.equal(again[0], dP) and torch.equal(again[1], dbg)
    with pytest.raises(ValueError, match="up to 1024 pixels"):
        streamed.composite_bwd_cuda(*bwd[:-1], dataclasses.replace(cfg, tile_size=36))


@pytest.mark.cuda
def test_streamed_render_tile12_matches_cpu_on_card(card):
    """The `streamed` compositing of a render, forward and backward, in 12
    x 12 tiles (144 pixels: B2 and B3 with idle lanes) on the card against
    the same screen-space gaussians composited through the plain versions on
    the CPU: image within 1e-5, gradients within 1e-4 of each field's
    largest value. (Projected once, on the CPU: the two devices round the
    projection differently, which can reorder near-equal depth keys.)"""
    import numpy as np

    from pf3plat_tpu_torch.ops.rasterizer import RasterizeConfig
    from pf3plat_tpu_torch.ops.rasterizer.project import make_camera, project_gaussians
    from pf3plat_tpu_torch.ops.rasterizer.streamed import composite_streamed_batched
    from pf3plat_tpu_torch.ops.rasterizer.types import ScreenGaussians
    from test_torch_helpers import make_scene_np

    cfg = RasterizeConfig(tile_size=12, tile_capacity=256)
    shape = (60, 84)
    scene = {k: torch.as_tensor(v)
             for k, v in make_scene_np(np.random.default_rng(4), n=3000, b=2, spread=0.6).items()}
    cam = make_camera(scene["extrinsics"], scene["intrinsics"], shape)
    screen = project_gaussians(cam, scene["means"], scene["covariances"], scene["opacities"],
                               scene["sh"], 4, cfg)
    tgt = torch.as_tensor(np.random.default_rng(5).uniform(0, 1, (2, *shape, 3)),
                          dtype=torch.float32)
    fields = ("xy", "conic", "opacity", "color")
    out = {}
    for dev in ("cuda", "cpu"):
        scr = {f: getattr(screen, f).detach().to(dev).clone() for f in ScreenGaussians._fields}
        for f in fields:
            scr[f].requires_grad_(True)
        bg = scene["background"].to(dev).clone().requires_grad_(True)
        img = composite_streamed_batched(ScreenGaussians(**scr), shape, bg, cfg)
        ((img - tgt.to(dev)) ** 2).mean().backward()
        out[dev] = (img.detach().cpu(), [scr[f].grad.cpu() for f in fields] + [bg.grad.cpu()])
    assert float((out["cuda"][0] - out["cpu"][0]).abs().max()) <= 1e-5
    for name, got, ref in zip(fields + ("background",), out["cuda"][1], out["cpu"][1]):
        assert float(ref.abs().max()) > 0, name
        assert float((got - ref).abs().max()) <= 1e-4 * float(ref.abs().max()), name


@pytest.mark.parametrize(
    "module,names",
    [
        ("pf3plat_tpu_torch.ops.rasterizer",
         ["render", "render_depth", "render_orthographic", "DepthRenderingMode",
          "RasterizeConfig", "DEFAULT_CONFIG"]),
        ("pf3plat_tpu_torch.ops.rasterizer.binning",
         ["BinnedTiles", "bin_gaussians", "bin_gaussians_batched"]),
        ("pf3plat_tpu_torch.ops.rasterizer.compositing", ["gaussian_alpha", "composite_chunk"]),
        ("pf3plat_tpu_torch.ops.rasterizer.tiled",
         ["pack_features", "tile_pixel_coords", "composite_tables", "composite_tiles"]),
        ("pf3plat_tpu_torch.ops.rasterizer.pallas_impl",
         ["composite_tiles_pallas", "composite_tiles_pallas_batched", "CompositeTable",
          "composite_table_fwd_plain", "composite_table_bwd_plain"]),
        ("pf3plat_tpu_torch.training.metrics",
         ["compute_psnr", "compute_ssim", "pose_errors", "pose_auc"]),
        ("pf3plat_tpu_torch.geometry.transforms", ["geodesic_distance", "translation_angle"]),
        ("pf3plat_tpu_torch.parallel",
         ["MeshCfg", "make_mesh", "initialize_multihost", "shard_batch", "replicate",
          "shard_train_step"]),
        ("pf3plat_tpu_torch.ops.rasterizer.shard_local",
         ["shard_pairs_budget", "composite_shard_local"]),
        ("pf3plat_tpu_torch.entry", ["entry", "dryrun_multichip"]),
    ],
    ids=lambda x: x if isinstance(x, str) else "",
)
def test_public_names_of_the_table_slice(module, names):
    """The names the JAX package exports for this slice exist in the port
    under the same module paths, and its kernel sources are registered."""
    import importlib

    mod = importlib.import_module(module)
    missing = [name for name in names if not hasattr(mod, name)]
    assert not missing, f"{module} lacks {missing}"
    from pf3plat_tpu_torch import kernels

    for name in ("table_fwd", "table_bwd", "composite_bwd_blocks", "attention_fwd",
                 "attention_bwd"):
        assert (kernels.CSRC / kernels.SOURCES[name]).is_file()
        assert name in kernels.LAUNCHES


@pytest.mark.parametrize(
    "module,names",
    [
        ("pf3plat_tpu_torch.geometry.projection",
         ["project", "project_camera_space", "transform_cam2world", "transform_world2cam",
          "intersect_rays"]),
        ("pf3plat_tpu_torch.geometry.transforms", ["plucker_embedding"]),
        ("pf3plat_tpu_torch.geometry.epipolar", ["project_ray_samples", "view_overlap"]),
        ("pf3plat_tpu_torch.utils.benchmarker", ["Benchmarker", "sync"]),
        ("pf3plat_tpu_torch.evaluation.metric_computer", ["compute_metrics", "main"]),
        ("pf3plat_tpu_torch.evaluation.index_generator",
         ["IndexGeneratorCfg", "choose_pair", "generate_index", "main"]),
        ("pf3plat_tpu_torch.evaluation.evaluator", ["EvalCfg", "Evaluator", "overlap_bucket"]),
        ("pf3plat_tpu_torch.main", ["run_test", "run_train", "run_validation", "main"]),
        ("pf3plat_tpu_torch.training.train", ["make_optimizer", "make_train_step",
                                              "init_train_state", "make_model_train_step"]),
        ("pf3plat_tpu_torch.utils.ply_export", ["export_ply"]),
        ("pf3plat_tpu_torch.models.backbones.weight_convert",
         ["conv_w", "linear_w", "convert_superpoint", "convert_lightglue", "convert_dinov2",
          "convert_unidepth", "convert_lpips_vgg", "main"]),
    ],
    ids=lambda x: x if isinstance(x, str) else "",
)
def test_public_names_of_the_evaluation_slice(module, names):
    """The JAX package's names of the evaluation slice and its remainder
    exist in the port under the same module paths, and the module imports
    no JAX (its file is also a case of `test_no_forbidden_imports`)."""
    import importlib

    mod = importlib.import_module(module)
    missing = [name for name in names if not hasattr(mod, name)]
    assert not missing, f"{module} lacks {missing}"
    path = Path(mod.__file__)
    assert path in _port_files()


def test_model_entry_point_needs_device_off_card():
    """PF3plat defaults to cuda; without a card it raises unless the caller
    passes device="cpu"."""
    from pf3plat_tpu_torch.models.pf3plat import PF3plat, PF3platCfg

    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PF3plat(PF3platCfg())
