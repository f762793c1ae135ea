"""Parity of the port's rasterizer (pf3plat_tpu_torch.ops.rasterizer) with
the JAX package, on the CPU.

Covers port-order steps 1-7: config/types, projection geometry and SH,
EWA projection, tile bounds / tight cull / depth key, kernel B1's plain
version (bit-exact against JAX `compact_pairs`, fitting and overflowing),
kernel B2's plain version (against the JAX streamed forward kernel in
interpret mode: image, final T and per-chunk T checkpoints), the
saturated-tile chunk-reset semantics, and `render` end to end.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pf3plat_tpu.ops.rasterizer import RasterizeConfig as JCfg
from pf3plat_tpu.ops.rasterizer import render as j_render
from pf3plat_tpu.ops.rasterizer import binning as jbin
from pf3plat_tpu.ops.rasterizer import compact as jcompact
from pf3plat_tpu.ops.rasterizer import streamed as jstreamed
from pf3plat_tpu.ops.rasterizer.project import (
    make_camera as j_make_camera,
    project_gaussians as j_project,
)
from pf3plat_tpu.geometry import projection as jproj, sh as jsh, transforms as jtr

from pf3plat_tpu_torch.ops.rasterizer import RasterizeConfig, render
from pf3plat_tpu_torch.ops.rasterizer import binning as tbin
from pf3plat_tpu_torch.ops.rasterizer import compact as tcompact
from pf3plat_tpu_torch.ops.rasterizer import streamed as tstreamed
from pf3plat_tpu_torch.ops.rasterizer.project import make_camera, project_gaussians
from pf3plat_tpu_torch.geometry import projection as tproj, sh as tsh, transforms as ttr

from test_torch_helpers import _no_tf32, make_scene_np, n, t  # noqa: F401


def _cfg(**kw):
    base = dict(tile_size=16, tile_capacity=256, chunk=128)
    base.update(kw)
    return RasterizeConfig(**base), JCfg(**base)


def _screens(scene, shape, tcfg, jcfg):
    jcam = j_make_camera(jnp.asarray(scene["extrinsics"]), jnp.asarray(scene["intrinsics"]), shape)
    jscr = jax.vmap(
        lambda c, m, cv, o, s: j_project(c, m, cv, o, s, 4, jcfg)
    )(jcam, *(jnp.asarray(scene[k]) for k in ("means", "covariances", "opacities", "sh")))
    tcam = make_camera(t(scene["extrinsics"]), t(scene["intrinsics"]), shape)
    tscr = project_gaussians(
        tcam, *(t(scene[k]) for k in ("means", "covariances", "opacities", "sh")), 4, tcfg
    )
    return tscr, jscr


class TestTypesAndGeometry:
    def test_config_fields_and_defaults(self):
        jf = {f.name: f.default for f in dataclasses.fields(JCfg)}
        tf = {f.name: f.default for f in dataclasses.fields(RasterizeConfig)}
        assert jf == tf
        assert RasterizeConfig().max_dup == JCfg().max_dup

    def test_projection_helpers(self):
        rng = np.random.default_rng(0)
        k = np.array([[1.1, 0.02, 0.48], [0, 0.9, 0.52], [0, 0, 1]], np.float32)
        k = np.broadcast_to(k, (3, 3, 3)).copy()
        k[:, 0, 0] += rng.uniform(0, 0.2, 3).astype(np.float32)
        c2w = np.broadcast_to(np.eye(4, dtype=np.float32), (3, 4, 4)).copy()
        c2w[:, :3, :3] = np.asarray(jtr.rotation_6d_to_matrix(
            jnp.asarray(rng.standard_normal((3, 6)).astype(np.float32))))
        c2w[:, :3, 3] = rng.standard_normal((3, 3))
        xy = rng.uniform(0, 1, (3, 7, 2)).astype(np.float32)
        z = rng.uniform(1, 5, (3, 7)).astype(np.float32)
        tol = dict(rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(n(tproj.se3_inverse(t(c2w))), n(jproj.se3_inverse(c2w)), **tol)
        np.testing.assert_allclose(n(tproj.intrinsics_inverse(t(k))), n(jproj.intrinsics_inverse(k)), **tol)
        np.testing.assert_allclose(n(tproj.get_fov(t(k))), n(jproj.get_fov(k)), **tol)
        np.testing.assert_allclose(
            n(tproj.unproject(t(xy), t(z), t(k)[:, None])),
            n(jproj.unproject(xy, z, k[:, None])), **tol)
        to, td = tproj.get_world_rays(t(xy), t(c2w)[:, None], t(k)[:, None])
        jo, jd = jproj.get_world_rays(xy, c2w[:, None], k[:, None])
        np.testing.assert_allclose(n(to), n(jo), **tol)
        np.testing.assert_allclose(n(td), n(jd), **tol)
        tg, ti = tproj.sample_image_grid((5, 7))
        jg, ji = jproj.sample_image_grid((5, 7))
        np.testing.assert_allclose(n(tg), n(jg), **tol)
        np.testing.assert_array_equal(n(ti), n(ji))

    def test_transforms(self):
        rng = np.random.default_rng(1)
        d6 = rng.standard_normal((4, 6)).astype(np.float32)
        q = rng.standard_normal((4, 4)).astype(np.float32)
        m = rng.standard_normal((4, 3, 3)).astype(np.float32)
        r = rng.standard_normal((4, 3, 3)).astype(np.float32)
        tv = rng.standard_normal((4, 3)).astype(np.float32)
        tol = dict(rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(n(ttr.rotation_6d_to_matrix(t(d6))), n(jtr.rotation_6d_to_matrix(d6)), **tol)
        np.testing.assert_allclose(n(ttr.quaternion_to_matrix(t(q))), n(jtr.quaternion_to_matrix(q)), **tol)
        np.testing.assert_allclose(n(ttr.make_rt(t(r), t(tv))), n(jtr.make_rt(r, tv)), **tol)
        np.testing.assert_allclose(n(ttr.so3_project(t(m))), n(jtr.so3_project(m)), **tol)
        np.testing.assert_allclose(
            n(ttr.matrix_to_rotation_6d(t(m))), n(jtr.matrix_to_rotation_6d(m)), **tol)

    def test_sh_eval_and_rotate(self):
        rng = np.random.default_rng(2)
        dirs = rng.standard_normal((6, 3)).astype(np.float32)
        dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
        coeffs = rng.standard_normal((6, 3, 25)).astype(np.float32)
        rot = np.asarray(jtr.rotation_6d_to_matrix(
            jnp.asarray(rng.standard_normal((6, 6)).astype(np.float32))))
        tol = dict(rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(
            n(tsh.eval_sh(t(coeffs), t(dirs), 4)), n(jsh.eval_sh(coeffs, dirs, 4)), **tol)
        np.testing.assert_allclose(
            n(tsh.rotate_sh(t(coeffs), t(rot)[:, None], 4)),
            n(jsh.rotate_sh(coeffs, rot[:, None], 4)), **tol)


class TestProjectAndBin:
    def test_project_bounds_cull_key(self):
        shape = (48, 64)
        tcfg, jcfg = _cfg()
        scene = make_scene_np(np.random.default_rng(3), n=120, b=2)
        tscr, jscr = _screens(scene, shape, tcfg, jcfg)
        tol = dict(rtol=1e-4, atol=1e-5)
        for f in ("xy", "depth", "conic", "color", "opacity"):
            np.testing.assert_allclose(n(getattr(tscr, f)), n(getattr(jscr, f)), **tol)
        np.testing.assert_array_equal(n(tscr.radius), n(jscr.radius))
        np.testing.assert_array_equal(n(tscr.valid), n(jscr.valid))
        tb = tbin.tile_bounds(tscr, shape, tcfg)
        jb = jbin.tile_bounds(jscr, shape, jcfg)
        for a, b in zip(tb, jb):
            np.testing.assert_array_equal(n(a), n(b))
        vis = (tb.tw > 0) & (tb.th > 0)
        np.testing.assert_array_equal(
            n(tbin.depth_sort_key(tscr.depth, vis)),
            n(jbin._depth_sort_key(jscr.depth, jnp.asarray(n(vis)))))
        # tight cull on the port's own screen values through both versions
        args = [n(tscr.xy[..., 0]), n(tscr.xy[..., 1]), n(tscr.conic[..., 0]),
                n(tscr.conic[..., 1]), n(tscr.conic[..., 2]), n(tscr.opacity),
                n(tb.tx0) + 1, n(tb.ty0)]
        np.testing.assert_array_equal(
            n(tbin.tile_alpha_cull(*[t(a) for a in args], tcfg)),
            n(jbin.tile_alpha_cull(*[jnp.asarray(a) for a in args], jcfg)))


def _compact_case(factor, seed, nn):
    """The JAX suite's compaction cases (tests/test_compact.py:53,94):
    window 512, AABB candidates, budget factor 1.0 (fits) or one window
    (overflows)."""
    kw = dict(pairs_budget_factor=factor, compact_window=512,
              compact_min_pairs=0, tight_cull=False)
    tcfg, jcfg = _cfg(**kw)
    scene = make_scene_np(np.random.default_rng(seed), n=nn, b=2)
    return tcfg, jcfg, scene


class TestCompactB1:
    @pytest.mark.parametrize(
        "factor,seed,nn",
        [(1.0, 21, 200), (512 / (2 * 400 * 4), 22, 400)],
        ids=["fits", "overflows"],
    )
    def test_plain_bit_exact_vs_jax(self, factor, seed, nn):
        shape = (48, 64)
        tcfg, jcfg, scene = _compact_case(factor, seed, nn)
        tscr, jscr = _screens(scene, shape, tcfg, jcfg)
        # Feed both sides the SAME screen values (the JAX projection's), so
        # the comparison is of compaction alone, bit for bit.
        tscr = type(tscr)(*(t(np.asarray(f)) for f in jscr))
        jc = jcompact.compact_pairs(jscr, shape, jcfg)
        tc = tcompact.compact_pairs(tscr, shape, tcfg)
        assert tc["budget"] == jc["budget"]
        assert int(tc["written"]) == int(jc["written"])
        assert int(tc["total"]) == int(jc["total"])
        if factor < 1.0:
            assert int(tc["written"]) < int(tc["total"])  # really overflows
        np.testing.assert_array_equal(n(tc["tile"]), n(jc["tile"]))
        np.testing.assert_array_equal(n(tc["dkey"]), n(jc["dkey"]))
        np.testing.assert_array_equal(n(tc["ids"]), n(jc["ids"]))
        jf = np.stack([np.asarray(f) for f in jc["feats"]])
        np.testing.assert_array_equal(n(tc["feats"]).view(np.int32), jf.view(np.int32))

    def test_budget_formula(self):
        for factor in (0.0, 0.3, 0.48, 1.0):
            for b, nn in ((1, 1000), (5, 131072), (2, 65536)):
                tcfg, jcfg = _cfg(pairs_budget_factor=factor)
                assert tcompact.pairs_budget(tcfg, b, nn) == jcompact.pairs_budget(jcfg, b, nn)
        assert tcompact.pairs_budget(
            RasterizeConfig(pairs_budget_factor=0.48), 5, 131072) == 1262592


def _jax_streamed_fwd(jscr, shape, jcfg, bg):
    """The JAX streamed forward up to its kernel outputs (streamed.py:
    1101-1151, single shard)."""
    b, nn = jscr.depth.shape
    ch = jscr.color.shape[-1]
    if jstreamed._use_compaction(jcfg, b, nn):
        featP, ids, starts, tx, ty, _ = jstreamed._pair_sort_compacted(jscr, shape, jcfg)
    else:
        featP, ids, starts, tx, ty, _ = jstreamed._pair_sort(jscr, shape, jcfg)
    rows = b * tx * ty
    ck = jcfg.chunk
    n_chunks = jcfg.tile_capacity // ck + 1
    counts = jnp.minimum(starts[1:] - starts[:-1], jcfg.tile_capacity)
    base = jnp.minimum(starts[:-1] // ck, featP.shape[1] // ck - n_chunks)
    off = starts[:-1] - base * ck
    tile_ids = jnp.tile(jnp.arange(tx * ty, dtype=jnp.int32), b)
    bg_rows = jnp.repeat(jnp.asarray(bg), tx * ty, axis=0)[..., None]
    fwd, _ = jstreamed._make_streamed_composite(
        rows, featP.shape[1], ch, tx, jcfg, True, False)
    img, tfin, tchk = fwd(base, off, counts, tile_ids, featP, bg_rows)
    return dict(featP=featP, starts=starts, img=img, tfin=tfin, tchk=tchk)


class TestCompositeB2:
    @pytest.mark.parametrize("compacted", [False, True], ids=["expanded", "compacted"])
    def test_plain_vs_jax_streamed_kernel(self, compacted):
        shape = (48, 64)
        kw = dict(pairs_budget_factor=0.6, compact_min_pairs=0) if compacted else {}
        tcfg, jcfg = _cfg(**kw)
        scene = make_scene_np(np.random.default_rng(4), n=300, b=2)
        tscr, jscr = _screens(scene, shape, tcfg, jcfg)
        tscr = type(tscr)(*(t(np.asarray(f)) for f in jscr))
        ref = _jax_streamed_fwd(jscr, shape, jcfg, scene["background"])
        args, _ = tstreamed.prepare_streamed(tscr, shape, t(scene["background"]), tcfg)
        np.testing.assert_array_equal(n(args["featP"]), np.asarray(ref["featP"])[:9])
        img, tfin, tchk = tstreamed.composite_fwd(**args)
        np.testing.assert_allclose(n(img), np.asarray(ref["img"]), atol=1e-5)
        np.testing.assert_allclose(n(tfin), np.asarray(ref["tfin"]), atol=1e-6)
        np.testing.assert_allclose(n(tchk), np.asarray(ref["tchk"]), atol=1e-6)

    def test_saturated_tile_chunk_reset(self):
        """One 16x16 tile under 256 depth-ordered, tile-wide gaussians of
        color 0 on a white background. Pairs 0-126 leave T ~ 5.6e-3, pair
        127 (alpha 0.99) would push T below 1e-4 and fails. The JAX
        streamed kernel then RESETS T at the 128-pair chunk boundary to the
        T after the last alive pair and keeps compositing chunk 1; the
        brute-force oracle stops for good. The port follows the streamed
        kernel, not the oracle."""
        from pf3plat_tpu.ops.rasterizer.reference_impl import composite_bruteforce
        from pf3plat_tpu.ops.rasterizer.types import ScreenGaussians as JScreen
        from pf3plat_tpu_torch.ops.rasterizer.types import ScreenGaussians

        shape = (16, 16)
        tcfg, jcfg = _cfg()
        nn = 256
        op = np.full(nn, 0.04, np.float32)
        op[127] = 0.995
        op[128:] = 0.3
        fields = dict(
            xy=np.full((1, nn, 2), 8.0, np.float32),
            depth=np.linspace(3.0, 6.0, nn, dtype=np.float32)[None],
            conic=np.tile(np.array([1e-4, 0.0, 1e-4], np.float32), (1, nn, 1)),
            radius=np.full((1, nn), 8.0, np.float32),
            color=np.zeros((1, nn, 3), np.float32),
            opacity=op[None],
            valid=np.ones((1, nn), bool),
        )
        bg = np.ones((1, 3), np.float32)
        jscr = JScreen(**{k: jnp.asarray(v) for k, v in fields.items()})
        tscr = ScreenGaussians(**{k: t(v) for k, v in fields.items()})
        ref = _jax_streamed_fwd(jscr, shape, jcfg, bg)
        args, _ = tstreamed.prepare_streamed(tscr, shape, t(bg), tcfg)
        img, tfin, tchk = tstreamed.composite_fwd(**args)
        np.testing.assert_allclose(n(img), np.asarray(ref["img"]), atol=1e-5)
        np.testing.assert_allclose(n(tfin), np.asarray(ref["tfin"]), atol=1e-6)
        np.testing.assert_allclose(n(tchk), np.asarray(ref["tchk"]), atol=1e-6)
        # chunk 1 started from the reset T (~5.6e-3), not from a stopped walk
        assert (n(tchk)[0, 1] > 1e-3).all() and (n(tfin) < 1e-3).all()
        oracle = jax.jit(lambda s: composite_bruteforce(
            jax.tree_util.tree_map(lambda x: x[0], s), shape, jnp.asarray(bg[0]), jcfg
        ))(jscr)
        streamed = tstreamed.composite_streamed_batched(tscr, shape, t(bg), tcfg)
        assert np.abs(n(streamed)[0] - np.asarray(oracle)).max() > 1e-3

class TestRender:
    @pytest.mark.parametrize(
        "impl,kw",
        [("streamed", {}), ("streamed", dict(pairs_budget_factor=0.6, compact_min_pairs=0)),
         ("streamed", dict(fused_sort_key=False)), ("bruteforce", {})],
        ids=["streamed", "streamed-compacted", "streamed-exact-key", "bruteforce"],
    )
    def test_render_matches_jax(self, impl, kw):
        shape = (32, 48)
        tcfg, jcfg = _cfg(**kw)
        scene = make_scene_np(np.random.default_rng(6), n=150, b=2)
        scene["near"] = np.array([0.5, 2.0], np.float32)  # exercise the renorm
        ref = j_render(**{k: jnp.asarray(v) for k, v in scene.items()},
                       image_shape=shape, impl=impl, config=jcfg)
        out = render(**{k: t(v) for k, v in scene.items()}, image_shape=shape,
                     impl=impl, config=tcfg, device="cpu")
        assert out.shape == (2, *shape, 3)
        np.testing.assert_allclose(n(out), np.asarray(ref), atol=1e-5, rtol=1e-4)

    def test_entry_point_needs_device_off_card(self):
        if torch.cuda.is_available():
            pytest.skip("a GPU is present: the default device is valid here")
        scene = make_scene_np(np.random.default_rng(7), n=8, b=1)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            render(**{k: t(v) for k, v in scene.items()}, image_shape=(16, 16))
