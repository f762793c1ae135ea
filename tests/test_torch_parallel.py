"""Parity of the port's mesh paths (pf3plat_tpu_torch.parallel, the sharded
rasterizer pipelines, kernel B5's plain version) with the JAX package, on
the CPU.

  * kernel B5's plain version against the JAX block-output backward kernel
    itself (interpret mode, all rows in one call, no `shard_map`), with
    tiles of one and of several chunks, chunks the forward never processed
    and windows clamped at the end of the array;
  * `merge_blocks` of B5's blocks against B3's plain version, with the
    shards taken in any order;
  * `render(..., mesh=)` on a (2, 2) mesh of CPU shards, streamed without
    compaction (B5 path), streamed shard-local, and dense tables: image and
    gradients against the JAX package's sharded render on 4 virtual CPU
    devices and against the port's unsharded render;
  * the per-shard budget and the tile-range compaction against JAX;
  * `make_mesh`, the sharded train step of the tiny model against the
    unsharded one, the multi-shard dry run, and a two-process gloo step.
"""

from __future__ import annotations

import socket
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pf3plat_tpu.ops.rasterizer import RasterizeConfig as JCfg
from pf3plat_tpu.ops.rasterizer import compact as jcompact
from pf3plat_tpu.ops.rasterizer import render as j_render
from pf3plat_tpu.ops.rasterizer import shard_local as jshard
from pf3plat_tpu.ops.rasterizer import streamed as jstreamed
from pf3plat_tpu.parallel import MeshCfg as JMeshCfg, make_mesh as j_make_mesh

from pf3plat_tpu_torch import entry
from pf3plat_tpu_torch.models.pf3plat import PF3plat
from pf3plat_tpu_torch.ops.rasterizer import RasterizeConfig, render
from pf3plat_tpu_torch.ops.rasterizer import compact as tcompact
from pf3plat_tpu_torch.ops.rasterizer import shard_local as tshard
from pf3plat_tpu_torch.ops.rasterizer import streamed as tstreamed
from pf3plat_tpu_torch.parallel import MeshCfg, make_mesh, replicate, shard_batch, shard_train_step
from pf3plat_tpu_torch.training import train
from pf3plat_tpu_torch.training.losses import LossCfg

from test_torch_helpers import _no_tf32, make_scene_np, n, t  # noqa: F401
from test_torch_rasterizer import _cfg, _screens

REPO = Path(__file__).resolve().parents[1]


def _cpu_mesh(data=2, tile=2):
    return make_mesh(MeshCfg(data_axis=data, tile_axis=tile), device="cpu")


def _backward_inputs(clamp: bool):
    """Sorted pairs, segment rows, B2's (plain) final T and checkpoints and
    a fixed upstream gradient for a dense two-camera scene: some tiles span
    two chunks, most end before the last chunk. `clamp` cuts the feature
    array right after the last real pair, so the last tiles' windows are
    clamped at its end (off >= chunk)."""
    shape = (32, 48)
    tcfg, _ = _cfg()
    rng = np.random.default_rng(12)
    scene = make_scene_np(rng, n=400, b=2, spread=0.3)
    tscr, _ = _screens(scene, shape, tcfg, _cfg()[1])
    featP, _, starts, tiles_x, tiles_y = tstreamed.pair_sort(tscr, shape, tcfg)
    ck = tcfg.chunk
    n_chunks = tcfg.tile_capacity // ck + 1
    if clamp:
        n_cols = max(-(-int(starts[-1]) // ck), n_chunks) * ck
        featP = featP[:, :n_cols].contiguous()
    base, off, counts = tstreamed.segment_rows(starts, featP.shape[1], tcfg)
    rows = base.shape[0]
    tile_ids = torch.arange(tiles_x * tiles_y, dtype=torch.int32).repeat(2)
    bg_rows = t(rng.uniform(0, 1, (rows, 3)).astype(np.float32))
    args = dict(featP=featP, base=base, off=off, counts=counts, tile_ids=tile_ids,
                bg_rows=bg_rows, tiles_x=tiles_x, channels=3, config=tcfg)
    _, tfin, tchk = tstreamed.composite_fwd_plain(**args)
    g_tiles = t(rng.standard_normal((rows, 3, 256)).astype(np.float32))
    bwd = dict(featP=featP, base=base, off=off, counts=counts, tile_ids=tile_ids,
               nproc=tstreamed.n_processed(tchk), bg_rows=bg_rows, tfin=tfin, tchk=tchk,
               g_tiles=g_tiles, tiles_x=tiles_x, channels=3, config=tcfg)
    return bwd, n_chunks


class TestBlocksBackward:
    @pytest.mark.parametrize("clamp", [False, True], ids=["padded", "clamped-window"])
    def test_b5_plain_matches_jax_kernel(self, clamp):
        """Blocks (first 9 of the JAX kernel's 16 feature rows) and d(bg) at
        the JAX suite's gradient tolerance, rtol 1e-4 / atol 1e-7."""
        bwd, n_chunks = _backward_inputs(clamp)
        ck = bwd["config"].chunk
        nproc = n(bwd["nproc"])
        counts = n(bwd["counts"])
        assert (nproc < n_chunks).any() and (nproc >= 2).any() and (counts > ck).any()
        assert bool((bwd["off"] >= ck).any()) == clamp
        dblk, dbg = tstreamed.composite_bwd_blocks_plain(**bwd)

        rows = bwd["base"].shape[0]
        featP = n(bwd["featP"])
        feat16 = np.zeros((16, featP.shape[1]), np.float32)
        feat16[:9] = featP
        _, jcfg = _cfg()
        call = jstreamed._make_streamed_composite(
            rows, featP.shape[1], 3, bwd["tiles_x"], jcfg, True, True)[1]
        ref_blk, ref_dbg = call(
            *(jnp.asarray(n(bwd[k])) for k in ("base", "off", "counts", "tile_ids", "nproc")),
            jnp.asarray(feat16), jnp.asarray(n(bwd["bg_rows"]))[..., None],
            jnp.asarray(n(bwd["tchk"])), jnp.asarray(n(bwd["tfin"])),
            jnp.asarray(n(bwd["g_tiles"])), jnp.zeros((rows, 1, 256), jnp.float32))
        ref_blk = np.asarray(ref_blk)
        assert dblk.shape == (rows, n_chunks, 9, ck)
        assert np.abs(ref_blk[:, :, :9]).max() > 0
        np.testing.assert_allclose(n(dblk), ref_blk[:, :, :9], rtol=1e-4, atol=1e-7)
        np.testing.assert_array_equal(ref_blk[:, :, 9:], 0.0)
        np.testing.assert_allclose(n(dbg), np.asarray(ref_dbg)[:, :, 0], rtol=1e-4, atol=1e-7)

    @pytest.mark.parametrize("order", ["in-order", "shuffled"])
    def test_merged_blocks_equal_b3_plain(self, order):
        """B5 per shard (4 shards of the rows), blocks concatenated in the
        given shard order and merged: equal to B3's plain dP. A window
        shared by two tiles gets one real value and exact zeros, so the
        order of the additions cannot change the sum."""
        bwd, _ = _backward_inputs(True)
        dP, dbg = tstreamed.composite_bwd_plain(**bwd)
        rows = bwd["base"].shape[0]
        row_keys = ("base", "off", "counts", "tile_ids", "nproc", "bg_rows", "tfin", "tchk",
                    "g_tiles")
        shards = [3, 0, 2, 1] if order == "shuffled" else [0, 1, 2, 3]
        rps = rows // 4
        blks, dbgs, bases = [], [], []
        for k in shards:
            part = {**bwd, **{key: bwd[key][k * rps:(k + 1) * rps] for key in row_keys}}
            blk, dbg_k = tstreamed.composite_bwd_blocks_plain(**part)
            blks.append(blk)
            dbgs.append(dbg_k)
            bases.append(part["base"])
        merged = tstreamed.merge_blocks(torch.cat(blks), torch.cat(bases), bwd["featP"].shape[1])
        assert np.abs(n(dP)).max() > 0
        np.testing.assert_allclose(n(merged), n(dP), rtol=0, atol=1e-7)
        back = np.argsort(shards)
        np.testing.assert_array_equal(n(torch.cat([dbgs[i] for i in back])), n(dbg))


def _mesh_scene():
    rng = np.random.default_rng(4)
    return make_scene_np(rng, n=64, b=2)


def _port_render(scene, cfg, impl, mesh):
    ts = {k: t(v) for k, v in scene.items()}
    ts["means"].requires_grad_(True)
    img = render(**ts, image_shape=(32, 32), impl=impl, config=cfg, device="cpu", mesh=mesh)
    (img**2).sum().backward()
    return n(img), n(ts["means"].grad)


def _jax_render(scene, jcfg, impl, mesh):
    js = {k: jnp.asarray(v) for k, v in scene.items() if k != "means"}

    def loss(means):
        img = j_render(js["extrinsics"], js["intrinsics"], js["near"], js["far"], (32, 32),
                       js["background"], means, js["covariances"], js["sh"], js["opacities"],
                       impl=impl, config=jcfg, mesh=mesh)
        return jnp.sum(img**2), img

    (_, img), g = jax.value_and_grad(loss, has_aux=True)(jnp.asarray(scene["means"]))
    return np.asarray(img), np.asarray(g)


MESH_CASES = {
    "streamed-blocks": ("streamed", dict(pairs_budget_factor=0.0, compact_window=512,
                                         compact_min_pairs=0)),
    "streamed-shard-local": ("streamed", dict(pairs_budget_factor=1.0, compact_window=512,
                                              compact_min_pairs=0)),
    "pallas": ("pallas", dict(chunk=64)),
}


class TestMeshRender:
    @pytest.mark.parametrize("case", list(MESH_CASES))
    def test_mesh_path_matches_jax_sharded_and_unsharded(self, case):
        """The JAX suite's mesh tests (tests/test_parallel.py), mirrored on
        a (2, 2) mesh: the port's sharded image and d(means) against the JAX
        sharded render (image atol 1e-5; gradients rtol 1e-4 / atol 1e-5,
        the JAX test's own) and against the port's unsharded render."""
        impl, kw = MESH_CASES[case]
        tcfg, jcfg = _cfg(**kw)
        scene = _mesh_scene()
        img, grad = _port_render(scene, tcfg, impl, _cpu_mesh())
        ref_img, ref_grad = _port_render(scene, tcfg, impl, None)
        assert np.abs(ref_grad).max() > 0
        np.testing.assert_allclose(img, ref_img, atol=1e-5)
        np.testing.assert_allclose(grad, ref_grad, rtol=1e-4, atol=1e-5)
        jmesh = j_make_mesh(JMeshCfg(data_axis=2, tile_axis=2), devices=jax.devices()[:4])
        j_img, j_grad = _jax_render(scene, jcfg, impl, jmesh)
        np.testing.assert_allclose(img, j_img, atol=1e-5)
        np.testing.assert_allclose(grad, j_grad, rtol=1e-4, atol=1e-5)

    @pytest.mark.parametrize("impl", ["streamed", "pallas"])
    def test_rows_not_divisible_raise(self, impl):
        """2 cameras x 4 tiles = 8 rows over a 3-shard mesh: the JAX
        package's ValueError."""
        tcfg, _ = _cfg()
        with pytest.raises(ValueError, match="8 tile rows not divisible by mesh size 3"):
            _port_render(_mesh_scene(), tcfg, impl, _cpu_mesh(3, 1))

    def test_one_shard_mesh_is_the_unsharded_path(self):
        tcfg, _ = _cfg()
        scene = _mesh_scene()
        img, grad = _port_render(scene, tcfg, "streamed", _cpu_mesh(1, 1))
        ref_img, ref_grad = _port_render(scene, tcfg, "streamed", None)
        np.testing.assert_array_equal(img, ref_img)
        np.testing.assert_array_equal(grad, ref_grad)


class TestShardBudgetAndRange:
    def test_shard_pairs_budget_equals_jax(self):
        for factor in (0.3, 0.48, 1.0):
            for b, nn in ((2, 4096), (6, 65536), (1, 512), (9, 131072)):
                for s in (2, 4, 8):
                    for kw in ({}, dict(tile_capacity=256, compact_window=512)):
                        got = tshard.shard_pairs_budget(
                            RasterizeConfig(pairs_budget_factor=factor, **kw), b, nn, s)
                        want = jshard.shard_pairs_budget(
                            JCfg(pairs_budget_factor=factor, **kw), b, nn, s)
                        assert got == want, (factor, b, nn, s, kw)

    @pytest.mark.parametrize("shard", [0, 1, 3])
    def test_tile_range_compaction_equals_jax(self, shard):
        """One shard's compaction (its quarter of the 12 flat tile rows,
        its own budget) against JAX `compact_pairs`: ids, tile keys and both
        counts, bit for bit."""
        shape = (32, 48)
        kw = dict(pairs_budget_factor=1.0, compact_window=512, compact_min_pairs=0)
        tcfg, jcfg = _cfg(**kw)
        scene = make_scene_np(np.random.default_rng(5), n=150, b=2)
        tscr, jscr = _screens(scene, shape, tcfg, jcfg)
        rps = 2 * 6 // 4
        lo, hi = shard * rps, (shard + 1) * rps
        budget = tshard.shard_pairs_budget(tcfg, 2, 150, 4)
        got = tcompact.compact_pairs(tscr, shape, tcfg, tile_lo=lo, tile_hi=hi,
                                     budget_override=budget)
        ref = jcompact.compact_pairs(jscr, shape, jcfg, tile_lo=lo, tile_hi=hi,
                                     budget_override=budget)
        written = int(ref["written"])
        assert 0 < written == int(got["written"])
        assert int(got["total"]) == int(ref["total"])
        np.testing.assert_array_equal(n(got["ids"]), np.asarray(ref["ids"]))
        np.testing.assert_array_equal(n(got["tile"]), np.asarray(ref["tile"]))
        tiles = n(got["tile"])[:written]
        assert tiles.min() >= lo and tiles.max() < hi


class TestMesh:
    def test_make_mesh_shapes(self):
        mesh = make_mesh(MeshCfg(data_axis=2, tile_axis=2), device="cpu")
        assert mesh.shape == {"data": 2, "tile": 2}
        assert mesh.axis_names == ("data", "tile")
        assert mesh.size == 4 and mesh.devices == (torch.device("cpu"),) * 4
        listed = make_mesh(MeshCfg(tile_axis=2), devices=["cpu"] * 6)
        assert listed.shape == {"data": 3, "tile": 2}

    def test_make_mesh_rejects_a_shape_that_does_not_fit(self):
        with pytest.raises(AssertionError, match="cannot form mesh"):
            make_mesh(MeshCfg(data_axis=2, tile_axis=2), devices=["cpu"] * 6)

    def test_shard_batch_and_replicate_single_process(self):
        mesh = _cpu_mesh()
        batch = {"x": torch.ones(8, 4), "step": 3, "nested": {"y": torch.zeros(8)}}
        out = shard_batch(mesh, batch)
        assert out["x"].shape == (8, 4) and out["step"] == 3 and out["nested"]["y"].shape == (8,)
        w = torch.ones(3)
        assert replicate(mesh, [w])[0] is w
        step = lambda state, batch: (state, 0.0)  # noqa: E731
        assert shard_train_step(step, mesh) is step

    @pytest.mark.parametrize("factor,tol", [(0.0, 1e-6), (1.0, 2e-3)],
                             ids=["blocks", "shard-local"])
    def test_sharded_train_step_equals_unsharded(self, factor, tol):
        """One train step of the tiny model of tests/test_torch_model.py
        through a (2, 2) mesh against the same step without a mesh: loss,
        gradient norm, the gradients (Adam's first moment after step 1 is
        0.1 * the clipped gradient) and every updated parameter.

        The B5 path composites the same chunks and sums the same values in
        the same order: tolerance 1e-6. On the shard-local path a tile's
        chunks start at other pairs (offsets into the shard's own sorted
        array), and the tiny model's scene is dense (3,072 gaussians on
        32x32 pixels), so saturated pixels reset their transmittance
        elsewhere: at most the T left at a reset (< 1e-2) times a colour per
        pixel in the image (measured here 8.8e-5), 4e-4 of the largest
        render gradient; tolerance 2e-3 of the largest gradient. Adam's first
        update is lr * sign(g) with lr = 8e-6, which a gradient near zero
        may flip: atol 2e-5 on the parameters."""
        import dataclasses

        from test_torch_model import _cfgs, _inputs

        _, tcfg = _cfgs()
        raster = dataclasses.replace(tcfg.decoder.raster, pairs_budget_factor=factor)
        tcfg = dataclasses.replace(tcfg, decoder=dataclasses.replace(tcfg.decoder, raster=raster))
        images, intr, near, far = (t(a) for a in _inputs())
        batch = dict(context=dict(image=images, intrinsics=intr, near=near, far=far),
                     target=dict(image=images))
        results = []
        for mesh in (None, _cpu_mesh()):
            torch.manual_seed(0)
            model = PF3plat(tcfg, device="cpu")
            step = train.make_model_train_step(model, LossCfg(), train.OptimizerCfg(), mesh=mesh)
            if mesh is not None:
                step = shard_train_step(step, mesh)
                batch = shard_batch(mesh, batch)
            gen = torch.Generator().manual_seed(1)
            state, aux = step(train.init_train_state(model), batch, generator=gen)
            results.append((aux, [p.detach().clone() for p in state.params],
                            state.opt_state.mu))
        (aux0, p0, mu0), (aux1, p1, mu1) = results
        assert float(aux0["grad_norm"]) > 0
        for key in ("loss", "grad_norm"):
            np.testing.assert_allclose(float(aux1[key]), float(aux0[key]), rtol=tol, err_msg=key)
        largest = max(float(b.abs().max()) for b in mu0)
        for a, b in zip(mu1, mu0):
            np.testing.assert_allclose(n(a), n(b), rtol=tol, atol=tol * largest)
        for a, b in zip(p1, p0):
            np.testing.assert_allclose(n(a), n(b), rtol=1e-4, atol=2e-5)

    def test_dryrun_multichip_finite(self):
        loss = entry.dryrun_multichip(4, device="cpu")
        assert np.isfinite(loss) and loss > 0

    def test_entry_forward(self):
        fn, args = entry.entry(device="cpu")
        out = fn(*args)
        assert out.shape == (1, 2, 56, 56, 3) and bool(torch.isfinite(out).all())


WORKER = textwrap.dedent(
    """
    import sys
    pid = int(sys.argv[1]); coord = sys.argv[2]
    sys.path.insert(0, sys.argv[3])
    import numpy as np
    import torch
    from pf3plat_tpu_torch.parallel import (
        MeshCfg, initialize_multihost, make_mesh, shard_batch, shard_train_step)

    initialize_multihost(coordinator=coord, num_processes=2, process_id=pid)
    mesh = make_mesh(MeshCfg(), device="cpu")
    x = torch.as_tensor(np.random.default_rng(100).standard_normal((8, 16)), dtype=torch.float32)
    w = torch.as_tensor(np.random.default_rng(7).standard_normal((16, 4)),
                        dtype=torch.float32).requires_grad_(True)

    def train_step(state, batch, grad_sync=None):
        (w,) = state
        w.grad = None
        ((batch["x"] @ w) ** 2).mean().backward()
        if grad_sync is not None:
            grad_sync([w.grad])
        with torch.no_grad():
            w -= 0.1 * w.grad
        return state, w.grad.clone()

    local = shard_batch(mesh, {"x": x})  # this process's 4 of the 8 rows
    assert local["x"].shape == (4, 16)
    _, g = shard_train_step(train_step, mesh)((w,), local)
    print(f"CHECKSUM {float(g.sum()):.6f} {float(w.sum()):.6f}", flush=True)
    torch.distributed.destroy_process_group()
    """
)


def test_two_process_gradient_all_reduce(tmp_path):
    """`initialize_multihost` + `shard_batch` + `shard_train_step` in two
    gloo processes: each holds half the batch, both apply the full-batch
    gradient (the step tests/test_multihost.py takes in the JAX package)."""
    worker = tmp_path / "worker.py"
    worker.write_text(WORKER)
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    procs = [
        subprocess.Popen(
            [sys.executable, str(worker), str(i), f"localhost:{port}", str(REPO)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for i in range(2)
    ]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=90)
            assert p.returncode == 0, f"worker failed:\n{out}\n{err}"
            outs.append(out)
    finally:
        for p in procs:  # leave no worker behind if one timed out
            if p.poll() is None:
                p.kill()
    sums = [[float(v) for v in next(ln for ln in out.splitlines()
                                    if ln.startswith("CHECKSUM")).split()[1:]] for out in outs]
    np.testing.assert_allclose(sums[0], sums[1], rtol=1e-6)
    x = t(np.random.default_rng(100).standard_normal((8, 16)))
    w = t(np.random.default_rng(7).standard_normal((16, 4))).requires_grad_(True)
    ((x @ w) ** 2).mean().backward()
    want = [float(w.grad.sum()), float((w.detach() - 0.1 * w.grad).sum())]
    np.testing.assert_allclose(sums[0], want, rtol=1e-5)
