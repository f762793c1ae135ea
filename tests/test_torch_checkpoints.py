"""Parity of the port's checkpoints (pf3plat_tpu_torch.training.checkpoints,
.pretrained) with the JAX package, on the CPU: the save interval, `keep`
and the forced last save, `frozen/` written once, a restore bit-equal to
what was saved, the warm start that carries `frozen/`; an orbax checkpoint
written by the JAX package's CheckpointManager read into the port; the
converted `.pkl` weights loaded as the JAX loader loads them.

Mirrors tests/test_training.py's checkpoint cases. The JAX parameter trees
come from `jax.eval_shape` of the tiny model's init
(tests/test_torch_model.py), filled with numpy draws: the JAX package's own
tree layout without compiling its init.
"""

from __future__ import annotations

import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pf3plat_tpu.training import checkpoints as jckpt
from pf3plat_tpu.training import pretrained as jpretrained
from pf3plat_tpu.training import train as jtrain

from pf3plat_tpu_torch.models.pf3plat import PF3plat
from pf3plat_tpu_torch.training import checkpoints as tckpt
from pf3plat_tpu_torch.training import pretrained as tpretrained
from pf3plat_tpu_torch.training.train import OptState, TrainState
from pf3plat_tpu_torch.weights import load_jax_params

from test_torch_helpers import one_thread  # noqa: F401
from test_torch_model import _cfgs, _inputs

pytestmark = pytest.mark.usefixtures("one_thread")


@pytest.fixture(scope="module")
def jax_trees():
    """(trainable, frozen) JAX parameter trees of the tiny model, numpy
    leaves drawn from seed 0 (layout from `jax.eval_shape` of its init)."""
    from pf3plat_tpu.models.pf3plat import PF3plat as JPF3plat

    jcfg, _ = _cfgs()
    shapes = jax.eval_shape(JPF3plat(jcfg).init, jax.random.PRNGKey(0),
                            *(jnp.asarray(a) for a in _inputs()))
    rng = np.random.default_rng(0)
    fill = lambda s: (0.1 * rng.standard_normal(s.shape)).astype(s.dtype)  # noqa: E731
    trainable = jax.tree_util.tree_map(fill, shapes.trainable)
    frozen = {k: jax.tree_util.tree_map(fill, v) for k, v in shapes.frozen.items()}
    return trainable, frozen


def tiny_model():
    return PF3plat(_cfgs()[1], device="cpu")


def module_tensors(module) -> dict:
    return {k: v.clone() for k, v in module.state_dict().items()}


def assert_state_dict_equal(a: dict, b: dict):
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k


def random_state(seed: int, step: int) -> TrainState:
    g = torch.Generator().manual_seed(seed)
    shapes = ((4, 3), (7,), (2, 2, 2))
    r = lambda: [torch.randn(s, generator=g) for s in shapes]  # noqa: E731
    return TrainState(r(), OptState(seed + 1, r(), [x.abs() for x in r()], seed % 3), step)


class TestCheckpoints:
    def test_interval_keep_and_force(self, tmp_path):
        mgr = tckpt.CheckpointManager(tckpt.CheckpointCfg(directory=tmp_path, every_n_steps=2,
                                                          keep=2))
        saved = [mgr.maybe_save(random_state(0, s), force=s == 5) for s in range(1, 6)]
        assert saved == [False, True, False, True, True]
        assert mgr.all_steps() == [4, 5]
        # an existing step is never overwritten, even when forced
        assert not mgr.maybe_save(random_state(1, 5), force=True)
        assert mgr.latest_step() == 5

    def test_restore_bit_equal(self, tmp_path):
        cfg = tckpt.CheckpointCfg(directory=tmp_path, every_n_steps=1)
        src = random_state(3, 9)
        tckpt.CheckpointManager(cfg).maybe_save(src)
        template = TrainState([torch.zeros_like(p) for p in src.params],
                              OptState(0, [], [], 0), 0)
        got = tckpt.CheckpointManager(cfg).restore_latest(template)
        assert got.params is template.params  # restored into the model's tensors
        assert (got.step, got.opt_state.count, got.opt_state.notfinite_count) == (
            9, src.opt_state.count, src.opt_state.notfinite_count)
        for a, b in zip(got.params + got.opt_state.mu + got.opt_state.nu,
                        src.params + src.opt_state.mu + src.opt_state.nu):
            assert torch.equal(a, b)

    def test_frozen_written_once(self, tmp_path):
        mgr = tckpt.CheckpointManager(tckpt.CheckpointCfg(directory=tmp_path))
        assert not mgr.has_frozen()
        mgr.save_frozen({"lpips": {"w": torch.full((2,), 3.0)}})
        mgr.save_frozen({"lpips": {"w": torch.zeros(2)}})
        assert mgr.has_frozen()
        assert torch.equal(mgr.restore_frozen()["lpips"]["w"], torch.full((2,), 3.0))

    def test_warm_start_carries_frozen(self, tmp_path):
        src = tckpt.CheckpointManager(tckpt.CheckpointCfg(directory=tmp_path / "src",
                                                          every_n_steps=1, keep=1))
        src.save_frozen({"lpips": {"w": torch.ones(2) * 3}})
        state = random_state(5, 7)
        src.maybe_save(state)
        dst = tckpt.CheckpointManager(tckpt.CheckpointCfg(directory=tmp_path / "dst",
                                                          load=tmp_path / "src"))
        template = TrainState([torch.zeros_like(p) for p in state.params],
                              OptState(0, [], [], 0), 0)
        got = dst.restore_latest(template)
        assert got.step == 7
        assert all(torch.equal(a, b) for a, b in zip(got.params, state.params))
        assert dst.has_frozen()
        assert torch.equal(dst.restore_frozen()["lpips"]["w"], torch.full((2,), 3.0))

    def test_warm_start_missing_raises(self, tmp_path):
        dst = tckpt.CheckpointManager(tckpt.CheckpointCfg(directory=tmp_path / "dst",
                                                          load=tmp_path / "nonexistent"))
        with pytest.raises(FileNotFoundError):
            dst.restore_latest(random_state(0, 0))

    def test_frozen_state_roundtrip(self, tmp_path):
        a, b = tiny_model(), tiny_model()
        mgr = tckpt.CheckpointManager(tckpt.CheckpointCfg(directory=tmp_path))
        mgr.save_frozen(tckpt.frozen_state(a))
        tckpt.load_frozen_state(b, mgr.restore_frozen())
        for k in tckpt.FROZEN_MODULES:
            assert_state_dict_equal(module_tensors(getattr(b, k)),
                                    module_tensors(getattr(a, k)))

    def test_load_jax_checkpoint(self, tmp_path, jax_trees):
        """An orbax checkpoint written by the JAX package's CheckpointManager
        (trainable state with Adam moments mu = 2 params and nu = |params|,
        count 3, one non-finite step, step 7; frozen/) reads into the port."""
        trainable, frozen = jax_trees
        opt = jtrain.make_optimizer(jtrain.OptimizerCfg(max_steps=100))
        s = opt.init(trainable)
        clip, (adam, sched) = s.inner_state
        adam = adam._replace(count=jnp.asarray(3, jnp.int32),
                             mu=jax.tree_util.tree_map(lambda x: 2 * x, trainable),
                             nu=jax.tree_util.tree_map(np.abs, trainable))
        s = s._replace(notfinite_count=jnp.asarray(1, jnp.int32),
                       inner_state=(clip, (adam, sched)))
        mgr = jckpt.CheckpointManager(jckpt.CheckpointCfg(directory=tmp_path, every_n_steps=1))
        mgr.maybe_save(jtrain.TrainState(trainable, s, jnp.asarray(7, jnp.int32)))
        mgr.save_frozen(frozen)
        mgr.wait()

        model = tiny_model()
        st = tckpt.load_jax_checkpoint(tmp_path, model)
        ref = tiny_model()
        load_jax_params(ref, trainable, frozen)
        assert_state_dict_equal(module_tensors(model), module_tensors(ref))
        assert (st.step, st.opt_state.count, st.opt_state.notfinite_count) == (7, 3, 1)
        assert len(st.params) == len(st.opt_state.mu) == len(list(model.encoder.parameters()))
        for p, m, v in zip(st.params, st.opt_state.mu, st.opt_state.nu):
            assert torch.equal(m, 2 * p) and torch.equal(v, p.abs())

    def test_load_jax_checkpoint_needs_orbax(self, tmp_path, monkeypatch):
        import sys

        monkeypatch.setitem(sys.modules, "orbax", None)
        monkeypatch.setitem(sys.modules, "orbax.checkpoint", None)
        with pytest.raises(ImportError):
            tckpt.load_jax_checkpoint(tmp_path, None)

    def test_load_pretrained_frozen_matches_jax(self, tmp_path, jax_trees):
        _, frozen = jax_trees
        for artifact, key in jpretrained._ARTIFACTS.items():
            if key != "lightglue":  # one artifact left out: it keeps its init
                with (tmp_path / f"{artifact}.pkl").open("wb") as f:
                    pickle.dump(frozen[key], f)
        want = jpretrained.load_pretrained_frozen(tmp_path, frozen)
        model = tiny_model()
        before = module_tensors(model.lightglue)
        found = tpretrained.load_pretrained_frozen(tmp_path, model)
        assert found == ["superpoint", "unidepth", "lpips_vgg"]
        ref = tiny_model()
        load_jax_params(ref, jax_trees[0], jax.tree_util.tree_map(np.asarray, want))
        for k in ("superpoint", "unidepth", "lpips"):
            assert_state_dict_equal(module_tensors(getattr(model, k)),
                                    module_tensors(getattr(ref, k)))
        assert_state_dict_equal(module_tensors(model.lightglue), before)
        with pytest.raises(FileNotFoundError):
            tpretrained.load_pretrained_frozen(tmp_path, model, require_all=True)
        with pytest.raises(FileNotFoundError):
            tpretrained.load_pretrained_frozen(tmp_path / "empty", model)

    def test_load_pretrained_frozen_shape_mismatch_raises(self, tmp_path, jax_trees):
        bad = jax.tree_util.tree_map(lambda x: x[..., :1], jax_trees[1]["superpoint"])
        with (tmp_path / "superpoint.pkl").open("wb") as f:
            pickle.dump(bad, f)
        with pytest.raises(ValueError):
            tpretrained.load_pretrained_frozen(tmp_path, tiny_model())
