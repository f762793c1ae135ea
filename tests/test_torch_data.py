"""Parity of the port's data pipeline (pf3plat_tpu_torch.data, .native) with
the JAX package, on the CPU.

The same synthetic chunks (numpy seeds, JPEGs through PIL) go through both
packages' readers, samplers, shims and datasets: every example and batch
must be bit-equal at the same seed, for `.torch` and `.pfchunk` roots, for
the train and test stages. Mirrors tests/test_data.py and
tests/test_native.py.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import pytest

from pf3plat_tpu.data import dataset as jds
from pf3plat_tpu.data import shims as jshims
from pf3plat_tpu.data import view_samplers as jvs
from pf3plat_tpu.native import pfchunk as jpfchunk

from pf3plat_tpu_torch.data import dataset as tds
from pf3plat_tpu_torch.data import shims as tshims
from pf3plat_tpu_torch.data import view_samplers as tvs
from pf3plat_tpu_torch.data.prefetch import ExamplePipeline
from pf3plat_tpu_torch.native import pfchunk as tpfchunk

from test_data import make_chunk

SAMPLER = dict(num_target_views=2, min_distance_between_context_views=10,
               max_distance_between_context_views=20)
IMAGE = dict(image_shape=(64, 64), original_image_shape=(72, 128))


def assert_tree_equal(a, b, path=""):
    """Bit-equal nested dicts / lists of numpy arrays and scalars."""
    assert type(a) is type(b) or (np.isscalar(a) and np.isscalar(b)), (path, type(a), type(b))
    if isinstance(a, dict):
        assert a.keys() == b.keys(), path
        for k in a:
            assert_tree_equal(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            assert_tree_equal(x, y, f"{path}[{i}]")
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape, path
        np.testing.assert_array_equal(a, b, err_msg=path)
    else:
        assert a == b, path


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    """Two roots with the same two chunks: `.torch` files in one, their
    `.pfchunk` conversions (by the port) in the other; train and test
    splits."""
    base = tmp_path_factory.mktemp("chunks")
    torch_root, native_root = base / "torch", base / "native"
    for split, seeds in (("train", (0, 1)), ("test", (2,))):
        (torch_root / split).mkdir(parents=True)
        (native_root / split).mkdir(parents=True)
        for i, seed in enumerate(seeds):
            src = torch_root / split / f"{i:06}.torch"
            make_chunk(src, n_scenes=2, n_frames=30, seed=seed)
            tpfchunk.convert_torch_chunk(src, native_root / split / f"{i:06}.pfchunk")
    return {"torch": torch_root, "pfchunk": native_root}


def _datasets(root, stage, seed=0, host_id=0, num_hosts=1, **cfg):
    out = []
    for vs, ds in ((jvs, jds), (tvs, tds)):
        sampler = vs.BoundedViewSampler(vs.BoundedSamplerCfg(**SAMPLER), stage=stage)
        out.append(ds.ChunkDataset(ds.DatasetCfg(roots=[root], **IMAGE, **cfg), sampler,
                                   stage=stage, host_id=host_id, num_hosts=num_hosts,
                                   seed=seed))
    return out


class TestPoses:
    def test_convert_poses_matches(self):
        rng = np.random.default_rng(0)
        cams = rng.standard_normal((7, 18)).astype(np.float32)
        for f in range(7):
            q, _ = np.linalg.qr(rng.standard_normal((3, 3)))
            cams[f, 6:] = np.hstack([q, rng.standard_normal((3, 1))]).reshape(-1)
        assert_tree_equal(tds.convert_poses(cams), jds.convert_poses(cams))


class TestSamplers:
    @pytest.mark.parametrize("stage", ["train", "test"])
    @pytest.mark.parametrize("warm_up", [0, 100])
    def test_bounded_matches(self, stage, warm_up):
        cfg = dict(SAMPLER, warm_up_steps=warm_up, initial_min_distance_between_context_views=5,
                   initial_max_distance_between_context_views=8)
        j = jvs.BoundedViewSampler(jvs.BoundedSamplerCfg(**cfg), stage=stage)
        t = tvs.BoundedViewSampler(tvs.BoundedSamplerCfg(**cfg), stage=stage)
        rj, rt = np.random.default_rng(3), np.random.default_rng(3)
        for step in (0, 10, 50, 200):
            assert_tree_equal(t.sample("s", 60, rt, step), j.sample("s", 60, rj, step))

    def test_bounded_not_enough_frames(self):
        cfg = tvs.BoundedSamplerCfg(min_distance_between_context_views=100,
                                    max_distance_between_context_views=100)
        with pytest.raises(tvs.SampleError):
            tvs.BoundedViewSampler(cfg).sample("x", 10, np.random.default_rng(0), 0)

    def test_evaluation_matches(self, tmp_path):
        p = tmp_path / "index.json"
        p.write_text(json.dumps({"a": {"context": [0, 30], "target": [10, 15, 20]}, "b": None}))
        assert_tree_equal(tvs.EvaluationViewSampler(p).sample("a", 60),
                          jvs.EvaluationViewSampler(p).sample("a", 60))
        with pytest.raises(tvs.SampleError):
            tvs.EvaluationViewSampler(p).sample("b", 60)

    @pytest.mark.parametrize("max_views", [None, 7])
    def test_all_and_arbitrary_match(self, max_views):
        assert_tree_equal(tvs.AllViewSampler(max_views).sample("s", 40),
                          jvs.AllViewSampler(max_views).sample("s", 40))
        assert_tree_equal(
            tvs.ArbitraryViewSampler(3, 4).sample("s", 40, np.random.default_rng(1)),
            jvs.ArbitraryViewSampler(3, 4).sample("s", 40, np.random.default_rng(1)))


class TestShims:
    def _example(self, h=72, w=128, v=3):
        rng = np.random.default_rng(0)
        views = {
            "extrinsics": rng.standard_normal((v, 4, 4)).astype(np.float32),
            "intrinsics": np.tile(np.asarray([[0.9, 0, 0.5], [0, 1.6, 0.5], [0, 0, 1]],
                                             np.float32), (v, 1, 1)),
            "image": rng.uniform(0, 1, (v, h, w, 3)).astype(np.float32),
            "near": np.ones(v, np.float32),
            "far": np.full(v, 100.0, np.float32),
            "index": np.arange(v),
        }
        return {"context": views, "target": dict(views), "scene": "s"}

    @pytest.mark.parametrize("shape", [(64, 64), (32, 32), (72, 96), (256, 256)],
                             ids=str)
    def test_crop_shim_bit_equal(self, shape):
        """Lanczos rescale + centre crop, at the configs' shapes (256 x 256
        from 360 x 640 is RE10K's, scaled here from 72 x 128)."""
        ex = self._example(h=360, w=640, v=1) if shape == (256, 256) else self._example()
        assert_tree_equal(tshims.apply_crop_shim(ex, shape), jshims.apply_crop_shim(ex, shape))

    def test_patch_shim_bit_equal(self):
        ex = self._example(h=66, w=98)
        assert_tree_equal(tshims.apply_patch_shim(ex, 16), jshims.apply_patch_shim(ex, 16))

    @pytest.mark.parametrize("seed", [0, 5])
    def test_augmentation_bit_equal(self, seed):
        ex = self._example()
        assert_tree_equal(tshims.apply_augmentation_shim(ex, np.random.default_rng(seed)),
                          jshims.apply_augmentation_shim(ex, np.random.default_rng(seed)))


class TestChunkDataset:
    @pytest.mark.parametrize("stage", ["train", "test"])
    @pytest.mark.parametrize("kind", ["torch", "pfchunk"])
    def test_examples_and_batches_bit_equal(self, roots, kind, stage):
        jd, td = _datasets(roots[kind], stage, seed=7)
        assert [p.name for p in td.chunks] == [p.name for p in jd.chunks]
        assert td.chunks[0].suffix == f".{kind}"
        jex, tex = list(jd.examples(global_step=0)), list(td.examples(global_step=0))
        assert len(tex) == len(jex) > 0
        for a, b in zip(tex, jex):
            assert_tree_equal(a, b)
        v = tex[0]["context"]["image"].shape[0]
        same = [i for i, e in enumerate(tex) if e["context"]["image"].shape[0] == v]
        assert_tree_equal(tds.batch_examples([tex[i] for i in same]),
                          jds.batch_examples([jex[i] for i in same]))

    def test_load_chunk_formats_agree(self, roots):
        """The `.pfchunk` conversion serves the same keys, cameras and JPEG
        bytes as the `.torch` chunk it came from, in both packages."""
        a = tds.load_chunk(roots["torch"] / "train" / "000000.torch")
        b = tds.load_chunk(roots["pfchunk"] / "train" / "000000.pfchunk")
        c = jds.load_chunk(roots["pfchunk"] / "train" / "000000.pfchunk")
        for x, y, z in zip(a, b, c):
            assert x["key"] == y["key"] == z["key"]
            np.testing.assert_array_equal(x["cameras"], y["cameras"])
            np.testing.assert_array_equal(y["cameras"], z["cameras"])
            for i, j in zip(x["images"], y["images"]):
                assert np.asarray(i, np.uint8).tobytes() == j.tobytes()

    def test_pipeline_matches_synchronous(self, roots):
        """The worker pool yields the synchronous path's examples in order."""
        _, sync_ds = _datasets(roots["torch"], "train", seed=3)
        _, par_ds = _datasets(roots["torch"], "train", seed=3)
        sync = list(sync_ds.examples(global_step=0))
        with ExamplePipeline(par_ds, lambda: 0, num_workers=4, prefetch=3) as pipe:
            par = list(pipe)
        assert len(par) == len(sync) > 0
        for a, b in zip(par, sync):
            assert_tree_equal(a, b)

    def test_host_sharding_matches(self, roots):
        for host in (0, 1):
            jd, td = _datasets(roots["torch"], "train", host_id=host, num_hosts=2)
            assert [p.name for p in td.chunks] == [p.name for p in jd.chunks]
            assert len(td.chunks) == 1
            assert_tree_equal(list(td.examples(0)), list(jd.examples(0)))

    def test_overfit_to_scene(self, roots):
        jd, td = _datasets(roots["torch"], "train", overfit_to_scene="scene_1_0")
        scenes = [e["scene"] for e in td.examples(global_step=0)]
        assert set(scenes) == {"scene_1_0"}
        assert scenes == [e["scene"] for e in jd.examples(global_step=0)]


class TestNative:
    def _scenes(self, seed=0):
        rng = np.random.default_rng(seed)
        scenes = []
        for s in range(3):
            n = 4 + s
            cams = rng.standard_normal((n, 18)).astype(np.float32)
            for f in range(n):
                cams[f, 6:] = np.hstack([np.eye(3), rng.standard_normal((3, 1))]).reshape(-1)
            scenes.append({"key": f"scene_{s}" + "x" * s, "cameras": cams,
                           "images": [bytes(rng.integers(0, 256, 100 + f, dtype=np.uint8))
                                      for f in range(n)]})
        return scenes

    def test_roundtrip_and_same_bytes_as_jax(self, tmp_path):
        scenes = self._scenes()
        tpfchunk.write_pfchunk(tmp_path / "t.pfchunk", scenes)
        jpfchunk.write_pfchunk(tmp_path / "j.pfchunk", scenes)
        assert (tmp_path / "t.pfchunk").read_bytes() == (tmp_path / "j.pfchunk").read_bytes()
        r = tpfchunk.PfChunkReader(tmp_path / "t.pfchunk")
        assert len(r) == 3
        for s in range(3):
            assert r.key(s) == scenes[s]["key"]
            assert r.num_frames(s) == 4 + s
            np.testing.assert_array_equal(r.cameras(s), scenes[s]["cameras"])
            for f in range(r.num_frames(s)):
                assert r.jpeg(s, f) == scenes[s]["images"][f]
        r.close()

    def test_native_pose_decode_matches_jax(self, tmp_path):
        rng = np.random.default_rng(1)
        n = 6
        cams = np.zeros((n, 18), np.float32)
        cams[:, :4] = [0.9, 1.1, 0.5, 0.48]
        for f in range(n):
            q, rr = np.linalg.qr(rng.standard_normal((3, 3)))
            q *= np.sign(np.diag(rr))
            q[:, 0] *= np.sign(np.linalg.det(q))
            cams[f, 6:] = np.hstack([q, rng.standard_normal((3, 1))]).reshape(-1)
        path = tmp_path / "p.pfchunk"
        tpfchunk.write_pfchunk(path, [{"key": "x", "cameras": cams, "images": [b""] * n}])
        r, rj = tpfchunk.PfChunkReader(path), jpfchunk.PfChunkReader(path)
        c2w, intr = r.poses(0)
        assert_tree_equal((c2w, intr), rj.poses(0))
        c2w_py, intr_py = jds.convert_poses(cams)
        np.testing.assert_allclose(c2w, c2w_py, atol=1e-5)
        np.testing.assert_array_equal(intr, intr_py)
        r.close()
        rj.close()

    def test_convert_torch_chunk_same_bytes_as_jax(self, tmp_path):
        src = tmp_path / "000000.torch"
        make_chunk(src, n_scenes=2, n_frames=5, seed=0)
        assert tpfchunk.convert_torch_chunk(src, tmp_path / "t.pfchunk") == 2
        jpfchunk.convert_torch_chunk(src, tmp_path / "j.pfchunk")
        assert (tmp_path / "t.pfchunk").read_bytes() == (tmp_path / "j.pfchunk").read_bytes()

    def test_library_builds_into_the_port_build_dir(self):
        lib = tpfchunk.build_library()
        assert lib.exists() and lib.parent.parent == tpfchunk.BUILD_ROOT
        assert Path(lib).resolve() != (Path(jpfchunk.__file__).parent / "libpfchunk.so").resolve()
