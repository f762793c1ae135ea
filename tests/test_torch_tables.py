"""Parity of the port's binned rasterizer backends with the JAX package, on
the CPU: dense binning (exact), the `tiled` backend, the dense-table
`pallas` backend (kernels B6/B7 through their plain versions, the JAX side
through its Pallas kernels in interpret mode), depth rendering, the
orthographic render, `decode(depth_mode=...)` and the evaluation metrics.

Tolerances are the JAX suite's own: images atol 1e-5 / rtol 1e-4
(tests/test_rasterizer.py), gradients rtol 1e-4 / atol 1e-7
(tests/test_streamed.py).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pf3plat_tpu.models import decoder as jdecoder
from pf3plat_tpu.models.types import Gaussians as JGaussians
from pf3plat_tpu.ops.rasterizer import RasterizeConfig as JCfg
from pf3plat_tpu.ops.rasterizer import api as japi
from pf3plat_tpu.ops.rasterizer import binning as jbin
from pf3plat_tpu.ops.rasterizer import pallas_impl as jpallas
from pf3plat_tpu.ops.rasterizer.project import (
    make_camera as j_make_camera,
    project_gaussians as j_project,
)
from pf3plat_tpu.ops.rasterizer.reference_impl import composite_bruteforce as j_bruteforce
from pf3plat_tpu.ops.rasterizer.types import ScreenGaussians as JScreen
from pf3plat_tpu.training import metrics as jmetrics

from pf3plat_tpu_torch.models import decoder as tdecoder
from pf3plat_tpu_torch.models.types import Gaussians
from pf3plat_tpu_torch.ops.rasterizer import RasterizeConfig, api as tapi
from pf3plat_tpu_torch.ops.rasterizer import binning as tbin
from pf3plat_tpu_torch.ops.rasterizer import pallas_impl as tpallas
from pf3plat_tpu_torch.ops.rasterizer import tiled as ttiled
from pf3plat_tpu_torch.ops.rasterizer.types import ScreenGaussians
from pf3plat_tpu_torch.training import metrics as tmetrics

from test_torch_helpers import _no_tf32, make_scene_np, n, t  # noqa: F401

IMG_TOL = dict(atol=1e-5, rtol=1e-4)
GRAD_TOL = dict(rtol=1e-4, atol=1e-7)


def _cfg(**kw):
    base = dict(tile_size=16, tile_capacity=256, chunk=64)
    base.update(kw)
    return RasterizeConfig(**base), JCfg(**base)


def _jax_screen(scene, shape, jcfg):
    jcam = j_make_camera(jnp.asarray(scene["extrinsics"]), jnp.asarray(scene["intrinsics"]), shape)
    return jax.vmap(lambda c, m, cv, o, s: j_project(c, m, cv, o, s, 4, jcfg))(
        jcam, *(jnp.asarray(scene[k]) for k in ("means", "covariances", "opacities", "sh")))


def _same_screens(scene, shape, jcfg):
    """The JAX projection's screen values, handed to both packages."""
    jscr = _jax_screen(scene, shape, jcfg)
    return ScreenGaussians(*(t(np.asarray(f)) for f in jscr)), jscr


def _saturated_fields(rng=None, nn=256):
    """One 16x16 tile under `nn` depth-ordered, tile-wide gaussians. Slots
    0-126 leave T ~ 5.6e-3, slot 127 (alpha 0.99) would push T below 1e-4
    and fails; slots 128.. composite again after the chunk reset."""
    op = np.full(nn, 0.04, np.float32)
    if nn > 128:
        op[127] = 0.995
        op[128:] = 0.3
    color = np.zeros((1, nn, 3), np.float32) if rng is None else \
        rng.uniform(0, 0.2, (1, nn, 3)).astype(np.float32)
    return dict(
        xy=np.full((1, nn, 2), 8.0, np.float32),
        depth=np.linspace(3.0, 6.0, nn, dtype=np.float32)[None],
        conic=np.tile(np.array([1e-4, 0.0, 1e-4], np.float32), (1, nn, 1)),
        radius=np.full((1, nn), 8.0, np.float32),
        color=color,
        opacity=op[None],
        valid=np.ones((1, nn), bool),
    )


class TestBinning:
    @pytest.mark.parametrize(
        "kw,nn",
        [
            (dict(fused_sort_key=True, tight_cull=True), 120),
            (dict(fused_sort_key=True, tight_cull=False), 120),
            (dict(fused_sort_key=False, tight_cull=True), 120),
            (dict(fused_sort_key=False, tight_cull=False), 120),
            (dict(tile_capacity=64, tight_cull=False), 600),
        ],
        ids=["fused-cull", "fused-aabb", "exact-cull", "exact-aabb", "capacity-truncated"],
    )
    def test_bin_gaussians_batched_exact(self, kw, nn):
        shape = (40, 64)  # not a tile multiple
        tcfg, jcfg = _cfg(**kw)
        spread = 0.3 if "tile_capacity" in kw else 1.0
        scene = make_scene_np(np.random.default_rng(31), n=nn, b=2, spread=spread)
        tscr, jscr = _same_screens(scene, shape, jcfg)
        ref = jax.jit(lambda s: jbin.bin_gaussians_batched(s, shape, jcfg))(jscr)
        got = tbin.bin_gaussians_batched(tscr, shape, tcfg)
        assert (got.num_tiles_x, got.num_tiles_y) == (ref.num_tiles_x, ref.num_tiles_y) == (4, 3)
        assert got.indices.dtype == torch.int32 and got.counts.dtype == torch.int32
        np.testing.assert_array_equal(n(got.counts), np.asarray(ref.counts))
        np.testing.assert_array_equal(n(got.indices), np.asarray(ref.indices))
        assert int(got.counts.max()) > 0
        if "tile_capacity" in kw:  # some tile really holds more than its capacity
            assert int(got.counts.max()) == 64
            full = tbin.bin_gaussians_batched(
                tscr, shape, RasterizeConfig(**{**tcfg.__dict__, "tile_capacity": 1024}))
            assert int(full.counts.max()) > 64

    def test_single_camera_and_last_tile(self):
        """`bin_gaussians` is the batched function on one camera, and with
        every pair valid (no pad rows) the last tile's segment ends with the
        array: its deepest gaussian appears once."""
        shape = (16, 16)
        tcfg, jcfg = _cfg(max_tiles_per_gaussian_side=1, tight_cull=False)
        f = _saturated_fields(nn=40)
        tscr = ScreenGaussians(**{k: t(v)[0] for k, v in f.items()})
        jscr = JScreen(**{k: jnp.asarray(v)[0] for k, v in f.items()})
        got = tbin.bin_gaussians(tscr, shape, tcfg)
        ref = jbin.bin_gaussians(jscr, shape, jcfg)
        np.testing.assert_array_equal(n(got.indices), np.asarray(ref.indices))
        np.testing.assert_array_equal(n(got.counts), np.asarray(ref.counts))
        assert n(got.counts).tolist() == [40]
        np.testing.assert_array_equal(n(got.indices)[0, :41], list(range(40)) + [-1])


def _render_both(scene, shape, impl, tcfg, jcfg):
    ref = japi.render(**{k: jnp.asarray(v) for k, v in scene.items()}, image_shape=shape,
                      impl=impl, config=jcfg)
    out = tapi.render(**{k: t(v) for k, v in scene.items()}, image_shape=shape, impl=impl,
                      config=tcfg, device="cpu")
    return out, ref


class TestImages:
    @pytest.mark.parametrize("impl", ["tiled", "pallas"])
    @pytest.mark.parametrize(
        "kw,shape,seed",
        [(dict(), (32, 48), 6), (dict(tile_size=32), (40, 64), 288),
         (dict(tile_size=12), (36, 60), 6), (dict(tile_size=20), (40, 60), 6)],
        ids=["ts16-cap256-chunk64", "ts32-cap256-chunk64", "ts12-cap256-chunk64",
             "ts20-cap256-chunk64"],
    )
    def test_render_matches_jax(self, impl, kw, shape, seed):
        """The port's render against the JAX package's (its Pallas kernels in
        interpret mode for `pallas`), also at tiles of 144 and 400 pixels, no
        multiple of 32, which the JAX path takes and kernels B6 and B7 take
        with idle lanes."""
        tcfg, jcfg = _cfg(**kw)
        rng = np.random.default_rng(seed)
        scene = make_scene_np(rng, n=80, b=2)
        scene["near"] = np.array([0.5, 2.0], np.float32)  # exercise the renorm
        scene["background"] = rng.uniform(0, 1, (2, 3)).astype(np.float32)
        out, ref = _render_both(scene, shape, impl, tcfg, jcfg)
        assert out.shape == (2, *shape, 3)
        np.testing.assert_allclose(n(out), np.asarray(ref), **IMG_TOL)

    def test_table_layouts_equal(self):
        """Both `table_layout` values give the port's one result, which is
        the JAX slot_major image too; an unknown value raises as in JAX."""
        shape = (32, 32)
        rng = np.random.default_rng(9)
        scene = make_scene_np(rng, n=96, b=2)
        tgt = t(rng.uniform(0, 1, (2, *shape, 3)).astype(np.float32))
        outs, grads = [], []
        for layout in ("f_major", "slot_major"):
            tcfg, jcfg = _cfg(table_layout=layout)
            ts = {k: t(v) for k, v in scene.items()}
            ts["means"].requires_grad_(True)
            img = tapi.render(**ts, image_shape=shape, impl="pallas", config=tcfg, device="cpu")
            ((img - tgt) ** 2).mean().backward()
            outs.append(n(img))
            grads.append(n(ts["means"].grad))
        np.testing.assert_array_equal(outs[0], outs[1])
        np.testing.assert_array_equal(grads[0], grads[1])
        ref = japi.render(**{k: jnp.asarray(v) for k, v in scene.items()}, image_shape=shape,
                          impl="pallas", config=jcfg)
        np.testing.assert_allclose(outs[1], np.asarray(ref), **IMG_TOL)
        with pytest.raises(ValueError, match="table_layout"):
            tapi.render(**{k: t(v) for k, v in scene.items()}, image_shape=shape, impl="pallas",
                        config=RasterizeConfig(table_layout="g_major"), device="cpu")
        with pytest.raises(ValueError, match="unknown rasterizer impl"):
            tapi.render(**{k: t(v) for k, v in scene.items()}, image_shape=shape,
                        impl="anchored", device="cpu")

    def test_saturated_tile_chunk_reset(self):
        """The dense-table backend resets T at the chunk boundary like the
        streamed kernels: chunk 1 starts from the T after the last alive
        slot of chunk 0 (~5.6e-3) and composites on; the brute-force oracle
        stops for good. Image, final T and checkpoints follow the JAX
        kernel."""
        shape = (16, 16)
        tcfg, jcfg = _cfg(chunk=128)
        f = _saturated_fields()
        bg = np.ones((1, 3), np.float32)
        jscr = JScreen(**{k: jnp.asarray(v) for k, v in f.items()})
        tscr = ScreenGaussians(**{k: t(v) for k, v in f.items()})
        jb = jbin.bin_gaussians_batched(jscr, shape, jcfg)
        ref = jpallas.composite_tiles_pallas_batched(jscr, jb, shape, jnp.asarray(bg), jcfg)
        tb = tbin.bin_gaussians_batched(tscr, shape, tcfg)
        got = tpallas.composite_tiles_pallas_batched(tscr, tb, shape, t(bg), tcfg)
        np.testing.assert_allclose(n(got), np.asarray(ref), **IMG_TOL)
        args = tpallas.prepare_tables(tscr, tb, t(bg), tcfg)
        _, tfin, tchk = tpallas.composite_table_fwd(**args)
        assert (n(tchk)[0, 1] > 1e-3).all() and (n(tfin) < 1e-3).all()
        oracle = j_bruteforce(jax.tree_util.tree_map(lambda x: x[0], jscr), shape,
                              jnp.asarray(bg[0]), jcfg)
        assert np.abs(n(got)[0] - np.asarray(oracle)).max() > 1e-3
        # the `tiled` backend carries T across chunks the same way
        tiled = ttiled.composite_tiles(
            ScreenGaussians(*(x[0] for x in tscr)), tbin.bin_gaussians(
                ScreenGaussians(*(x[0] for x in tscr)), shape, tcfg), shape, t(bg[0]), tcfg)
        np.testing.assert_allclose(n(tiled), n(got)[0], **IMG_TOL)

    @pytest.mark.parametrize("impl", ["tiled", "pallas"])
    def test_all_culled_scene_is_background_with_zero_grads(self, impl):
        """Every gaussian behind the camera: the image is the background
        and the gradients are finite zeros (no NaN from empty tables)."""
        tcfg, _ = _cfg()
        scene = {k: t(v) for k, v in make_scene_np(np.random.default_rng(4), n=32, b=1).items()}
        scene["means"][..., 2] = -5.0
        scene["background"] = torch.full((1, 3), 0.25)
        diff = ("means", "covariances", "sh", "opacities", "background")
        for k in diff:
            scene[k].requires_grad_(True)
        img = tapi.render(**scene, image_shape=(32, 32), impl=impl, config=tcfg, device="cpu")
        np.testing.assert_allclose(n(img), 0.25, atol=1e-6)
        (img**2).sum().backward()
        for k in diff[:-1]:
            assert bool(torch.isfinite(scene[k].grad).all()), k
            np.testing.assert_allclose(n(scene[k].grad), 0.0, atol=1e-6)
        assert float(scene["background"].grad.abs().max()) > 0


class TestPallasBackward:
    def test_render_grads_match_jax(self):
        """Gradients of mean((img - tgt)^2) w.r.t. means, covariances, SH,
        opacities and background through `impl="pallas"`: the port's
        autograd Function (B7's plain version) and gather backward against
        the JAX custom_vjp (the Pallas backward kernel) and XLA's scatter."""
        shape = (32, 48)
        tcfg, jcfg = _cfg()
        rng = np.random.default_rng(6)
        scene = make_scene_np(rng, n=150, b=2)
        scene["near"] = np.array([0.5, 2.0], np.float32)
        scene["background"] = rng.uniform(0, 1, (2, 3)).astype(np.float32)
        tgt = rng.uniform(0, 1, (2, *shape, 3)).astype(np.float32)
        keys = ("means", "covariances", "sh", "opacities", "background")

        def loss(*xs):
            d = {k: jnp.asarray(v) for k, v in scene.items()}
            d.update(zip(keys, xs))
            img = japi.render(**d, image_shape=shape, impl="pallas", config=jcfg)
            return jnp.mean((img - tgt) ** 2)

        ref = jax.jit(jax.grad(loss, argnums=tuple(range(len(keys)))))(
            *(jnp.asarray(scene[k]) for k in keys))
        ts = {k: t(v) for k, v in scene.items()}
        for k in keys:
            ts[k].requires_grad_(True)
        img = tapi.render(**ts, image_shape=shape, impl="pallas", config=tcfg, device="cpu")
        ((img - t(tgt)) ** 2).mean().backward()
        for k, r in zip(keys, ref):
            assert np.abs(np.asarray(r)).max() > 0, k
            np.testing.assert_allclose(n(ts[k].grad), np.asarray(r), err_msg=k, **GRAD_TOL)

    @pytest.mark.parametrize("saturated", [False, True], ids=["random", "saturated"])
    def test_composite_vjp_matches_jax_kernels(self, saturated):
        """The composite itself, (table, counts, tile_ids, bg_rows) ->
        (img_tiles, t_final), with cotangents on BOTH outputs: the plain
        versions of B6/B7 against the JAX kernels in interpret mode. The
        saturated tile's dead slot 127 gets no gradient, chunk 1's slots
        do."""
        if saturated:
            shape = (16, 16)
            tcfg, jcfg = _cfg(chunk=128)
            f = _saturated_fields(np.random.default_rng(9))
            tscr = ScreenGaussians(**{k: t(v) for k, v in f.items()})
            bg = np.ones((1, 3), np.float32)
        else:
            shape = (32, 48)
            tcfg, jcfg = _cfg()
            scene = make_scene_np(np.random.default_rng(12), n=150, b=2)
            tscr, _ = _same_screens(scene, shape, jcfg)
            bg = np.full((2, 3), 0.3, np.float32)
        tb = tbin.bin_gaussians_batched(tscr, shape, tcfg)
        args = tpallas.prepare_tables(tscr, tb, t(bg), tcfg)
        rows, p = args["table"].shape[0], 256
        rng = np.random.default_rng(13)
        g_img = rng.standard_normal((rows, 3, p)).astype(np.float32)
        g_tfin = rng.standard_normal((rows, p)).astype(np.float32)

        composite = jpallas._make_composite(rows, 9, 3, args["tiles_x"], jcfg, True)
        jargs = (jnp.asarray(n(args["table"]).transpose(0, 2, 1)), jnp.asarray(n(args["counts"])),
                 jnp.asarray(n(args["tile_ids"])), jnp.asarray(n(args["bg_rows"])))
        (jimg, jtfin), vjp = jax.vjp(composite, *jargs)
        jdtab, _, _, jdbg = vjp((jnp.asarray(g_img), jnp.asarray(g_tfin)))

        table = args["table"].clone().requires_grad_(True)
        bg_rows = args["bg_rows"].clone().requires_grad_(True)
        img, tfin = tpallas.CompositeTable.apply(
            table, args["counts"], args["tile_ids"], bg_rows, args["tiles_x"], 3, tcfg)
        np.testing.assert_allclose(n(img), np.asarray(jimg), atol=1e-5)
        np.testing.assert_allclose(n(tfin), np.asarray(jtfin), atol=1e-6)
        ((img * t(g_img)).sum() + (tfin * t(g_tfin)).sum()).backward()
        dtab = n(table.grad)
        assert np.abs(dtab).max() > 0
        np.testing.assert_allclose(dtab, np.asarray(jdtab).transpose(0, 2, 1),
                                   rtol=1e-4, atol=1e-6)
        np.testing.assert_allclose(n(bg_rows.grad), np.asarray(jdbg), rtol=1e-5, atol=1e-6)
        if saturated:
            assert np.abs(dtab[0, 127]).max() == 0.0
            assert np.abs(dtab[0, 128:, 6:]).max() > 0.0

    def test_b7_plain_vs_autograd_of_b6_plain(self):
        """An independent check of the hand-derived backward: on a scene
        where no pixel saturates, B7's plain version equals autograd
        through B6's plain version, with a non-zero t_final cotangent."""
        shape = (32, 48)
        tcfg, jcfg = _cfg()
        scene = make_scene_np(np.random.default_rng(10), n=60, b=2)
        tscr, _ = _same_screens(scene, shape, jcfg)
        tb = tbin.bin_gaussians_batched(tscr, shape, tcfg)
        args = tpallas.prepare_tables(tscr, tb, t(np.full((2, 3), 0.3, np.float32)), tcfg)
        rows = args["table"].shape[0]
        rng = np.random.default_rng(11)
        g_img = t(rng.standard_normal((rows, 3, 256)).astype(np.float32))
        g_tfin = t(rng.standard_normal((rows, 1, 256)).astype(np.float32))
        table = args["table"].clone().requires_grad_(True)
        bg_rows = args["bg_rows"].clone().requires_grad_(True)
        img, tfin, tchk = tpallas.composite_table_fwd_plain(
            **{**args, "table": table, "bg_rows": bg_rows})
        assert float(tfin.detach().min()) > 1e-3  # unsaturated
        ((img * g_img).sum() + (tfin * g_tfin).sum()).backward()
        dtab, dbg = tpallas.composite_table_bwd_plain(
            args["table"], args["counts"], args["tile_ids"], args["bg_rows"], tfin.detach(),
            tchk.detach(), g_img, g_tfin, args["tiles_x"], 3, tcfg)
        assert np.abs(n(dtab)).max() > 0
        np.testing.assert_allclose(n(dtab), n(table.grad), rtol=1e-4, atol=1e-6)
        np.testing.assert_allclose(n(dbg), n(bg_rows.grad), rtol=1e-5, atol=1e-6)

    def test_table_kernels_refuse_cpu_tensors_and_bad_shapes(self):
        tcfg, _ = _cfg()
        table = torch.zeros((2, 256, 9))
        counts = torch.zeros(2, dtype=torch.int32)
        bg = torch.zeros((2, 3))
        with pytest.raises(ValueError, match="CUDA tensors"):
            tpallas.composite_table_fwd_cuda(table, counts, counts, bg, 1, 3, tcfg)
        with pytest.raises(ValueError, match="table: want"):
            tpallas.composite_table_fwd_plain(table[:, :128], counts, counts, bg, 1, 3, tcfg)
        # B7's wrapper refuses CPU tensors too; its plain version takes them
        plane = torch.zeros((2, 1, 256))
        with pytest.raises(ValueError, match="CUDA tensors"):
            tpallas.composite_table_bwd_cuda(table, counts, counts, bg, plane,
                                             torch.zeros((2, 4, 256)), torch.zeros((2, 3, 256)),
                                             plane, 1, 3, tcfg)

    @pytest.mark.parametrize("chunk", [128, 64])
    def test_b7_walks_the_processed_prefix(self, chunk):
        """The chunks B7's plain version walks are exactly the first
        `n_processed(tchk)` chunks of B6's plain checkpoints (what kernel
        B7 is handed as its walked count): rows of 0 slots, 1 slot, a
        partial chunk and full capacity, every slot in the count touching
        every pixel without saturating it."""
        from pf3plat_tpu_torch.ops.rasterizer.streamed import n_processed

        cap, ts = 256, 16
        cfg = RasterizeConfig(tile_size=ts, tile_capacity=cap, chunk=chunk)
        counts = np.array([0, 1, 100, 150, 256], np.int32)
        rows = counts.size
        rng = np.random.default_rng(12)
        table = np.zeros((rows, cap, 9), np.float32)
        for r, k in enumerate(counts):
            table[r, :k, 0] = r * ts + 8.0 + rng.uniform(-1, 1, k)  # tile r of a 5 x 1 grid
            table[r, :k, 1] = 8.0 + rng.uniform(-1, 1, k)
            table[r, :k, 2] = table[r, :k, 4] = 1e-4  # wide: alpha ~ op everywhere
            table[r, :k, 5] = 0.005  # above alpha_min; T after 256 slots ~0.28
            table[r, :k, 6:] = rng.uniform(0, 1, (k, 3))
        args = dict(table=t(table), counts=t(counts), tile_ids=t(np.arange(rows, dtype=np.int32)),
                    bg_rows=t(np.full((rows, 3), 0.3, np.float32)), tiles_x=rows, channels=3,
                    config=cfg)
        _, tfin, tchk = tpallas.composite_table_fwd_plain(**args)
        nproc = n(n_processed(tchk))
        np.testing.assert_array_equal(nproc, -(-counts // chunk))
        g_img = t(rng.standard_normal((rows, 3, ts * ts)).astype(np.float32))
        g_tfin = t(rng.standard_normal((rows, 1, ts * ts)).astype(np.float32))
        dtab, _ = tpallas.composite_table_bwd_plain(
            args["table"], args["counts"], args["tile_ids"], args["bg_rows"], tfin, tchk, g_img,
            g_tfin, rows, 3, cfg)
        walked = n((dtab != 0).reshape(rows, cap // chunk, -1).any(dim=2))
        np.testing.assert_array_equal(walked, np.arange(cap // chunk)[None] < nproc[:, None])
        touched = n(dtab[..., 5] != 0)  # d(opacity): every slot in the count
        np.testing.assert_array_equal(touched, np.arange(cap)[None] < counts[:, None])


def _depth_scene(rng, nn=80):
    scene = make_scene_np(rng, n=nn, b=2)
    scene["near"] = np.array([0.5, 2.0], np.float32)
    return {k: scene[k] for k in ("extrinsics", "intrinsics", "near", "far", "means",
                                  "covariances", "opacities")}


class TestDepthAndOrthographic:
    @pytest.mark.parametrize("mode", ["depth", "disparity", "relative_disparity", "log"])
    def test_render_depth_matches_jax(self, mode):
        shape = (32, 32)
        tcfg, jcfg = _cfg()
        d = _depth_scene(np.random.default_rng(14))
        ref = japi.render_depth(**{k: jnp.asarray(v) for k, v in d.items()}, image_shape=shape,
                                mode=mode, impl="tiled", config=jcfg)
        got = tapi.render_depth(**{k: t(v) for k, v in d.items()}, image_shape=shape,
                                mode=mode, impl="tiled", config=tcfg, device="cpu")
        assert got.shape == (2, *shape)
        assert np.abs(np.asarray(ref)).max() > 0
        np.testing.assert_allclose(n(got), np.asarray(ref), atol=1e-5, rtol=1e-5)

    @pytest.mark.parametrize("impl", ["streamed", "pallas"])
    def test_one_channel_through_the_kernel_backends(self, impl):
        """Depth renders one channel with use_sh=False: the streamed and
        dense-table backends (plain versions of B2/B3/B4 and B6/B7 at
        channels=1) agree with the `tiled` backend's image and autograd
        gradients."""
        shape = (32, 32)
        tcfg, _ = _cfg()
        d = _depth_scene(np.random.default_rng(15))
        outs = {}
        for name in ("tiled", impl):
            ts = {k: t(v) for k, v in d.items()}
            for k in ("means", "covariances", "opacities"):
                ts[k].requires_grad_(True)
            img = tapi.render_depth(**ts, image_shape=shape, impl=name, config=tcfg,
                                    device="cpu")
            (img**2).mean().backward()
            outs[name] = (n(img), [n(ts[k].grad) for k in ("means", "covariances", "opacities")])
        np.testing.assert_allclose(outs[impl][0], outs["tiled"][0], **IMG_TOL)
        for a, r in zip(outs[impl][1], outs["tiled"][1]):
            assert np.abs(r).max() > 0
            np.testing.assert_allclose(a, r, rtol=1e-3, atol=2e-5)

    def test_depth_to_relative_disparity(self):
        rng = np.random.default_rng(16)
        depth = rng.uniform(0.5, 50.0, (2, 9)).astype(np.float32)
        near = np.array([[0.5], [1.0]], np.float32)
        far = np.array([[100.0], [50.0]], np.float32)
        np.testing.assert_allclose(
            n(tapi.depth_to_relative_disparity(t(depth), t(near), t(far))),
            np.asarray(japi.depth_to_relative_disparity(depth, near, far)), atol=1e-6)

    def test_render_orthographic_matches_jax(self):
        shape = (32, 32)
        tcfg, jcfg = _cfg()
        rng = np.random.default_rng(17)
        scene = make_scene_np(rng, n=80, b=2)
        scene["background"] = rng.uniform(0, 1, (2, 3)).astype(np.float32)
        kw = {k: scene[k] for k in ("extrinsics", "near", "far", "background", "means",
                                    "covariances", "sh", "opacities")}
        kw["width"] = np.array([3.0, 2.5], np.float32)
        kw["height"] = np.array([3.0, 2.0], np.float32)
        ref = japi.render_orthographic(**{k: jnp.asarray(v) for k, v in kw.items()},
                                       image_shape=shape, impl="tiled", config=jcfg)
        got = tapi.render_orthographic(**{k: t(v) for k, v in kw.items()}, image_shape=shape,
                                       impl="tiled", config=tcfg, device="cpu")
        assert np.asarray(ref).std() > 1e-3  # the gaussians are in view
        np.testing.assert_allclose(n(got), np.asarray(ref), atol=1e-5, rtol=1e-5)

    @pytest.mark.parametrize("impl", ["pallas"])
    def test_decode_with_depth_mode(self, impl):
        shape = (32, 32)
        tcfg, jcfg = _cfg()
        rng = np.random.default_rng(18)
        scene = make_scene_np(rng, n=80, b=2)
        v = 2
        extr = np.broadcast_to(scene["extrinsics"][:, None], (2, v, 4, 4)).copy()
        extr[:, 1, 0, 3] = 0.2  # second view shifted sideways
        rep = lambda a: np.broadcast_to(a[:, None], (2, v, *a.shape[1:])).copy()  # noqa: E731
        cams = dict(extrinsics=extr, intrinsics=rep(scene["intrinsics"]),
                    near=rep(scene["near"]), far=rep(scene["far"]))
        fields = dict(means=scene["means"], covariances=scene["covariances"],
                      harmonics=scene["sh"], opacities=scene["opacities"])
        ref = jdecoder.decode(
            jdecoder.DecoderCfg(impl=impl, raster=jcfg),
            JGaussians(**{k: jnp.asarray(x) for k, x in fields.items()}),
            **{k: jnp.asarray(x) for k, x in cams.items()}, image_shape=shape,
            depth_mode="disparity")
        got = tdecoder.decode(
            tdecoder.DecoderCfg(impl=impl, raster=tcfg),
            Gaussians(**{k: t(x) for k, x in fields.items()}),
            **{k: t(x) for k, x in cams.items()}, image_shape=shape, depth_mode="disparity")
        assert got.color.shape == (2, v, *shape, 3) and got.depth.shape == (2, v, *shape)
        np.testing.assert_allclose(n(got.color), np.asarray(ref.color), **IMG_TOL)
        np.testing.assert_allclose(n(got.depth), np.asarray(ref.depth), **IMG_TOL)
        none = tdecoder.decode(
            tdecoder.DecoderCfg(impl=impl, raster=tcfg),
            Gaussians(**{k: t(x) for k, x in fields.items()}),
            **{k: t(x) for k, x in cams.items()}, image_shape=shape)
        assert none.depth is None

    def test_depth_entry_points_need_device_off_card(self):
        if torch.cuda.is_available():
            pytest.skip("a GPU is present: the default device is valid here")
        d = {k: t(v) for k, v in _depth_scene(np.random.default_rng(19), nn=8).items()}
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tapi.render_depth(**d, image_shape=(16, 16), impl="pallas")


class TestMetrics:
    def test_psnr_ssim(self):
        rng = np.random.default_rng(20)
        gt = rng.uniform(-0.1, 1.1, (3, 24, 24, 3)).astype(np.float32)
        pr = (gt + rng.normal(0, 0.05, gt.shape)).astype(np.float32)
        np.testing.assert_allclose(n(tmetrics.compute_psnr(t(gt), t(pr))),
                                   np.asarray(jmetrics.compute_psnr(gt, pr)), atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(n(tmetrics.compute_psnr(t(gt), t(gt))), 120.0, atol=1e-4)
        gt01, pr01 = np.clip(gt, 0, 1), np.clip(pr, 0, 1)
        got = tmetrics.compute_ssim(t(gt01), t(pr01))
        assert got.shape == (3,)
        np.testing.assert_allclose(n(got), np.asarray(jmetrics.compute_ssim(gt01, pr01)),
                                   atol=1e-5, rtol=1e-5)

    def test_pose_errors(self):
        from pf3plat_tpu.geometry import transforms as jtr

        rng = np.random.default_rng(21)

        def poses():
            m = np.broadcast_to(np.eye(4, dtype=np.float32), (4, 3, 4, 4)).copy()
            m[..., :3, :3] = np.asarray(jtr.rotation_6d_to_matrix(
                jnp.asarray(rng.standard_normal((4, 3, 6)).astype(np.float32))))
            m[..., :3, 3] = rng.standard_normal((4, 3, 3))
            return m

        pred, gt = poses(), poses()
        ref = jmetrics.pose_errors(jnp.asarray(pred), jnp.asarray(gt))
        got = tmetrics.pose_errors(t(pred), t(gt))
        assert set(got) == set(ref) == {"rot_deg", "trans_norm", "trans_angle_deg"}
        for k in ref:
            assert got[k].shape == (4,)
            # angles in degrees up to ~150: one float32 ulp there is 1.5e-5
            np.testing.assert_allclose(n(got[k]), np.asarray(ref[k]), atol=1e-5, rtol=1e-6,
                                       err_msg=k)
        same = tmetrics.pose_errors(t(gt), t(gt))
        assert float(same["trans_norm"].max()) < 1e-5

    @pytest.mark.parametrize("errors", [[], [1.0, 3.0, 7.0, 12.0, 25.0, 60.0], [30.0, 40.0]],
                             ids=["empty", "mixed", "all-above"])
    def test_pose_auc(self, errors):
        ref = jmetrics.pose_auc(errors)
        got = tmetrics.pose_auc(torch.tensor(errors, dtype=torch.float64))
        assert got.keys() == ref.keys()
        for k in ref:
            assert abs(got[k] - ref[k]) <= 1e-9, k
        assert tmetrics.pose_auc(errors) == got
