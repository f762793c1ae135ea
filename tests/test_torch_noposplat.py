"""NoPoSplat on the port (`models/noposplat.py`) against the plain float32
reference (`tests/noposplat_reference.py`) on seeded weights at a tiny size
(64 x 64 images, an encoder of 2 blocks of width 64 with 4 heads, decoders of
2 blocks of width 48), the benchmark's copy of the reference held to it bit
for bit, and one training step through the port's entry point.

The trunk (ViT, lockstep decoders) takes its eager path off the card, and
on the card under no_grad and in eval mode; on the card its graphed train
steps are held to the eager ones from the same weights. The card's tests
are `cuda`-marked: `python3 -m pytest tests/test_torch_noposplat.py -m cuda
-o addopts="" --noconftest`.

Tolerances: the port's attention on the CPU rounds q, k, v and the
probabilities to bf16 (`layers.mxu_attention`, what the card's bf16 SDPA
does), the reference keeps float32, and everything else is float32 on both
sides. That rounding moves the Gaussians by <= 3e-5, the worst leaf's
gradient by <= 0.016 and the median leaf's by <= 1e-3 here (three input
seeds); the bf16 control (the reference with every product's operands
rounded to bf16, `pf3bench.check.Rounded`) moves them by more than the
tolerances below."""

from __future__ import annotations

import json
import statistics

import pytest
import torch

import noposplat_reference as ref_module
from pf3plat_tpu_torch.models import layers
from pf3plat_tpu_torch.models.decoder import DecoderCfg
from pf3plat_tpu_torch.models.gaussian_adapter import GaussianAdapterCfg
from pf3plat_tpu_torch.models.noposplat import (
    CrossViewTrunk, NoPoSplat, NoPoSplatCfg, ViTTrunk, token_positions)
from pf3plat_tpu_torch.utils import profiling
from test_data import make_chunk
from test_torch_helpers import one_thread  # noqa: F401

TINY = dict(enc_embed_dim=64, enc_depth=2, enc_num_heads=4, dec_embed_dim=48, dec_depth=2,
            dec_num_heads=4, dpt_hooks=(1, 2, 2), dpt_layer_dims=(8, 16, 32, 64),
            dpt_feature_dim=32, dpt_last_dim=16, centre_prior_depth=4.0)
SIZE = 64
# the Gaussians' relative gaps (each field's norm): bf16 attention reads
# <= 3e-5, the bf16 control >= 1e-3
GAUSSIAN_TOL = 3e-4
# a leaf's gradient gap against the larger of its own and the median leaf's
# norm. The worst leaf: bf16 attention reads 0.009 on the test's seed, the
# control 0.040; the median leaf: 9e-4 and 3.5e-3
GRAD_TOL = 0.02
GRAD_MEDIAN_TOL = 2e-3


def _cfgs():
    port = NoPoSplatCfg(**TINY, gaussian_adapter=GaussianAdapterCfg(sh_degree=1))
    ref = ref_module.NoPoSplatCfg(**TINY, gaussian_adapter=ref_module.AdapterCfg(sh_degree=1))
    return port, ref


def _inputs(b=1, seed=0):
    g = torch.Generator().manual_seed(seed)
    images = torch.rand(b, 2, SIZE, SIZE, 3, generator=g)
    k = torch.tensor([[0.86, 0.0, 0.5], [0.0, 1.53, 0.5], [0.0, 0.0, 1.0]])
    return images, k.expand(b, 2, 3, 3).clone()


@pytest.fixture(scope="module")
def models():
    torch.manual_seed(0)
    port_cfg, ref_cfg = _cfgs()
    port = NoPoSplat(port_cfg, DecoderCfg(), device="cpu")
    ref = ref_module.NoPoSplat(ref_cfg)
    ref.load_state_dict({k: v for k, v in port.state_dict().items()
                         if not k.startswith("lpips.")})
    return port, ref


def _rel(a, b) -> float:
    return float((a.double() - b.double()).norm() / b.double().norm())


def test_rope_2d_rotates_each_token_by_its_row_and_column():
    g = torch.Generator().manual_seed(1)
    d, base = 16, 100.0
    pos = token_positions(4, 4, "cpu")
    t = torch.randn(2, 3, pos.shape[0], d, generator=g)
    got = layers.apply_rope_2d(t, layers.rope_2d_tables(pos, d, base))
    want = t.double().clone()
    half, quarter = d // 2, d // 4
    for j, p in enumerate(pos.tolist()):
        for h in (0, 1):  # rows rotate the first half, columns the second
            for i in range(quarter):
                angle = torch.tensor(p[h] * base ** (-2.0 * i / half), dtype=torch.float64)
                a = t[..., j, h * half + i].double()
                b = t[..., j, h * half + i + quarter].double()
                want[..., j, h * half + i] = a * angle.cos() - b * angle.sin()
                want[..., j, h * half + i + quarter] = b * angle.cos() + a * angle.sin()
    torch.testing.assert_close(got.double(), want, rtol=0, atol=4e-6)
    torch.testing.assert_close(got, ref_module.rope_2d(t, pos, base), rtol=0, atol=1e-6)


def test_lockstep_swaps_the_branches(models):
    """Swapping the two views swaps the two decoder stacks' inputs: at the
    first layer for any weights, and at every layer, with the Gaussians'
    halves swapped, once the two stacks and the two sets of heads are
    tied."""
    port, _ = models
    tied = NoPoSplat(port.cfg, DecoderCfg(), device="cpu")
    tied.load_state_dict(port.state_dict())
    for a, b in ((tied.dec_blocks, tied.dec_blocks2),
                 (tied.downstream_head1, tied.downstream_head2),
                 (tied.gaussian_param_head, tied.gaussian_param_head2)):
        b.load_state_dict(a.state_dict())
    images, k = _inputs(seed=2)
    swapped = images.flip(1)

    def inputs_of(model, views):
        seen = {1: [], 2: []}
        hooks = [blk.register_forward_pre_hook(
            lambda _, args, s=s: seen[s].append((args[0].detach(), args[1].detach())))
            for s, stack in ((1, model.dec_blocks), (2, model.dec_blocks2)) for blk in stack]
        with torch.no_grad():
            g = model.gaussians(views, k)
        for h in hooks:
            h.remove()
        return seen, g

    for model in (port, tied):
        one, g_ab = inputs_of(model, images)
        two, g_ba = inputs_of(model, swapped)
        layers_checked = len(one[1]) if model is tied else 1
        for i in range(layers_checked):
            for a, b in zip(one[1][i], two[2][i]):
                torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)
            for a, b in zip(one[2][i], two[1][i]):
                torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)
    n = SIZE * SIZE
    for a, b in zip(g_ab, g_ba):
        torch.testing.assert_close(a, torch.cat([b[:, n:], b[:, :n]], dim=1),
                                   rtol=1e-4, atol=1e-6)


def test_gaussians_match_the_reference(models):
    from pf3bench.check import Rounded

    port, ref = models
    images, k = _inputs(seed=3)
    with torch.no_grad():
        got = port.gaussians(images, k)
        want = ref.gaussians(images, k)
        with Rounded(torch.bfloat16):
            control = ref.gaussians(images, k)
    gaps = [_rel(a, b) for a, b in zip(got, want)]
    assert max(gaps) < GAUSSIAN_TOL, gaps
    assert max(_rel(a, b) for a, b in zip(control, want)) > GAUSSIAN_TOL
    assert got.means.shape == (1, 2 * SIZE * SIZE, 3)
    assert got.harmonics.shape == (1, 2 * SIZE * SIZE, 3, 4)


def _leaf_gaps(got: dict, want: dict) -> list[float]:
    norms = {n: float(g.norm()) for n, g in want.items()}
    median = float(torch.tensor(list(norms.values())).median())
    return [float((got[n] - want[n]).norm()) / max(norms[n], median) for n in want]


def test_gradients_match_the_reference(models):
    """The gradients of a fixed weighted sum of the four fields (weights in
    [0.5, 1.5): random signs would leave each gradient a small remainder of
    cancelling terms), on every trained leaf."""
    from pf3bench.check import Rounded

    port, ref = models
    images, k = _inputs(seed=4)
    g = torch.Generator().manual_seed(5)
    with torch.no_grad():
        shapes = [x.shape for x in port.gaussians(images, k)]
    weights = [torch.rand(s, generator=g) + 0.5 for s in shapes]

    def grads(model, run):
        model.zero_grad(set_to_none=True)
        fields = run()
        sum((w * f).sum() for w, f in zip(weights, fields)).backward()
        return {n: p.grad.clone() for n, p in model.named_parameters()
                if not n.startswith("lpips.")}

    got = grads(port, lambda: port.gaussians(images, k))
    want = grads(ref, lambda: ref.gaussians(images, k))
    assert got.keys() == want.keys()

    def control():
        with Rounded(torch.bfloat16):
            return ref.gaussians(images, k)

    rounded = grads(ref, control)
    gaps, control_gaps = _leaf_gaps(got, want), _leaf_gaps(rounded, want)
    assert max(gaps) < GRAD_TOL and statistics.median(gaps) < GRAD_MEDIAN_TOL, \
        (max(gaps), statistics.median(gaps))
    assert max(control_gaps) > GRAD_TOL and statistics.median(control_gaps) > GRAD_MEDIAN_TOL


def test_benchmark_reference_copy_is_bit_identical(models):
    from pf3bench.reference.models import noposplat as bench_ref

    port, ref = models
    cfg = bench_ref.NoPoSplatCfg(**TINY, gaussian_adapter=bench_ref.AdapterCfg(sh_degree=1))
    copy = bench_ref.NoPoSplatTrainer(cfg)
    copy.load_state_dict(port.state_dict())
    images, k = _inputs(seed=6)
    with torch.no_grad():
        for a, b in zip(copy.gaussians(images, k), ref.gaussians(images, k)):
            assert torch.equal(a, b)


def parameter_count(cfg: NoPoSplatCfg) -> int:
    """NoPoSplat's trained parameters from its configuration alone."""
    e, d, r = cfg.enc_embed_dim, cfg.dec_embed_dim, cfg.mlp_ratio

    def lin(i, o):
        return i * o + o

    def conv(i, o, k, bias=True):
        return i * o * k * k + (o if bias else 0)

    enc_block = 2 * 2 * e + lin(e, 3 * e) + lin(e, e) + lin(e, r * e) + lin(r * e, e)
    dec_block = 4 * 2 * d + lin(d, 3 * d) + 5 * lin(d, d) + lin(d, r * d) + lin(r * d, d)
    dims, f, last = cfg.dpt_layer_dims, cfg.dpt_feature_dim, cfg.dpt_last_dim
    ins = (e, d, d, d)
    rcu = 2 * conv(f, f, 3)

    def dpt(out, shortcut):
        n = conv(ins[0], dims[0], 1) + conv(dims[0], dims[0], 4) + conv(ins[1], dims[1], 1) \
            + conv(dims[1], dims[1], 2) + conv(ins[2], dims[2], 1) + conv(ins[3], dims[3], 1) \
            + conv(dims[3], dims[3], 3)
        n += sum(conv(c, f, 3, bias=False) for c in dims)
        n += 3 * (2 * rcu + conv(f, f, 1)) + rcu + conv(f, f, 1)
        n += conv(f, f // 2, 3) + conv(f // 2, last, 3) + conv(last, out, 1)
        return n + (conv(3, last, 7) if shortcut else 0)

    n_raw = 1 + cfg.gaussian_adapter.d_in
    return (conv(3, e, cfg.patch_size) + lin(4, e) + cfg.enc_depth * enc_block + 2 * e
            + lin(e, d) + 2 * cfg.dec_depth * dec_block + 2 * d
            + 2 * dpt(3, False) + 2 * dpt(n_raw, True))


def test_parameter_count_from_the_configuration(models):
    port, _ = models
    assert parameter_count(port.cfg) == sum(p.numel() for p in port.trainable_parameters())
    full = parameter_count(NoPoSplatCfg())
    assert 0.55e9 < full < 0.65e9, full  # the paper's ~0.6 B at its published widths


def test_architecture_key(tmp_path):
    from pf3plat_tpu_torch.main import build_model
    from pf3plat_tpu_torch.utils.config import load_config

    assert load_config(None, []).model.architecture == "pf3plat"
    cfg = load_config(None, ['model.architecture="noposplat"', "noposplat.enc_depth=3"])
    assert cfg.noposplat.enc_depth == 3 and cfg.noposplat.dec_embed_dim == 768
    with pytest.raises(KeyError, match="enc_width"):
        load_config(None, ["noposplat.enc_width=3"])
    with pytest.raises(ValueError, match="nosuch"):
        build_model(load_config(None, ['model.architecture="nosuch"']), device="cpu")


def test_run_train_through_main(tmp_path, capsys, monkeypatch, one_thread):
    """One training step of `model.architecture=noposplat` through the
    port's entry point on the CPU: its loss is finite and the parameter
    count it reports is the configuration's."""
    from pf3plat_tpu_torch import main as tmain

    (tmp_path / "data" / "train").mkdir(parents=True)
    make_chunk(tmp_path / "data" / "train" / "000000.torch", n_scenes=2, n_frames=30, seed=0)
    tiny = {k: list(v) if isinstance(v, tuple) else v for k, v in TINY.items()}
    tmain.main([
        'model.architecture="noposplat"', f"noposplat={json.dumps(tiny)}",
        'noposplat.gaussian_adapter={"sh_degree": 1}', "max_steps=1",
        f'dataset.roots=["{tmp_path / "data"}"]', f"dataset.image_shape=[{SIZE}, {SIZE}]",
        "dataset.original_image_shape=[72, 128]", "view_sampler.num_target_views=2",
        "view_sampler.min_distance_between_context_views=20",
        "view_sampler.max_distance_between_context_views=20",
        "data_loader.batch_size=1", "data_loader.num_workers=0", "loss.lpips_weight=0.05",
        f'checkpointing.directory="{tmp_path / "ckpt"}"', f'output_dir="{tmp_path / "logs"}"',
        f'test.output_path="{tmp_path / "out" / "test"}"'], device="cpu")
    out = capsys.readouterr().out
    cfg = NoPoSplatCfg(**TINY, gaussian_adapter=GaussianAdapterCfg(sh_degree=1))
    assert f"model initialized: noposplat, {parameter_count(cfg)} trainable parameters" in out
    rows = [json.loads(r) for r in (tmp_path / "logs" / "scalars.jsonl").read_text().splitlines()]
    assert [r["step"] for r in rows] == [1]
    assert all(torch.isfinite(torch.tensor(rows[0][k])) for k in ("loss", "mse", "lpips"))
    assert rows[0]["grad_norm"] > 0


def _direct_layers(model, images, k):
    """The token maps the DPT heads read (the encoder's, then `dpt_hooks`'),
    from the model's blocks called one by one."""
    cfg = model.cfg
    b, v, h, w, _ = images.shape
    grid = (h // cfg.patch_size, w // cfg.patch_size)
    x = (images.reshape(b * v, h, w, 3).permute(0, 3, 1, 2) - 0.5) / 0.5
    pos = token_positions(*grid, images.device)
    rope = layers.rope_2d_tables(pos, cfg.enc_embed_dim // cfg.enc_num_heads, cfg.rope_base)
    tok = model.patch_embed(x).flatten(2).transpose(1, 2)
    kk = k.reshape(b * v, 3, 3)
    kk = torch.stack([kk[:, 0, 0], kk[:, 1, 1], kk[:, 0, 2], kk[:, 1, 2]], dim=-1)
    tok = torch.cat([tok, model.intrinsics_embed(kk)[:, None]], dim=1)
    for blk in model.enc_blocks:
        tok = blk(tok, rope)
    tok = model.enc_norm(tok).unflatten(0, (b, v))
    rope = layers.rope_2d_tables(pos, cfg.dec_embed_dim // cfg.dec_num_heads, cfg.rope_base)
    f = model.decoder_embed(tok)
    f1, f2 = f[:, 0], f[:, 1]
    out = [(tok[:, 0], tok[:, 1])]
    for blk1, blk2 in zip(model.dec_blocks, model.dec_blocks2):
        f1, f2 = blk1(f1, f2, rope, rope), blk2(f2, f1, rope, rope)
        out.append((f1, f2))
    out[-1] = (model.dec_norm(f1), model.dec_norm(f2))
    return [out[j] for j in (0, *cfg.dpt_hooks)]


def _check_eager_trunk(model, images, k, tmp_path, mode: str):
    """`model` called on (images, k) in `mode` ("grad", "no_grad" or "eval")
    runs the trunk as modules: every token map the heads get is bit-equal
    to the blocks called directly, no graph is captured or replayed."""
    seen = {}
    hooks = [head.register_forward_pre_hook(lambda _, args, i=i: seen.update({i: args[0]}))
             for i, head in enumerate((model.downstream_head1, model.downstream_head2))]
    grad = torch.no_grad() if mode == "no_grad" else torch.enable_grad()
    if mode == "eval":
        model.eval()
    try:
        with grad, profiling.trace(tmp_path, window="w"):
            model(images, k)
        with torch.no_grad():
            want = _direct_layers(model, images, k)
    finally:
        model.train()
        for h in hooks:
            h.remove()
    for i in (0, 1):
        assert len(seen[i]) == len(want)
        for got, direct in zip(seen[i], want):
            assert torch.equal(got, direct[i][:, :-1])
    (path,) = tmp_path.glob("*.pt.trace.json")
    counters = json.loads(path.read_text())[profiling.COUNTERS]
    assert counters["forwards"] == 1
    assert counters.get("nopo.graph_replays", 0) == 0
    assert counters.get("nopo.graph_captures", 0) == 0
    assert model._trunk_graphs == {}


@pytest.mark.parametrize("mode", ["grad", "no_grad", "eval"])
def test_trunk_is_eager_off_the_card(models, tmp_path, mode):
    """On the CPU the trunk runs as modules in every mode (the card's
    guards for no_grad and eval mode: the `cuda` test below)."""
    port, _ = models
    _check_eager_trunk(port, *_inputs(b=2, seed=7), tmp_path, mode)


def test_trunk_stages_are_the_models_modules(models):
    """The stages share the model's parameters (no copy) and read the
    decoder layers the heads need, each once."""
    port, _ = models
    pos = token_positions(2, 2, "cpu")
    vit, cross = ViTTrunk(port, pos), CrossViewTrunk(port, pos)
    ids = {id(p) for p in port.trainable_parameters()}
    assert {id(p) for p in vit.parameters()} <= ids
    assert {id(p) for p in cross.parameters()} <= ids
    assert sum(p.numel() for p in vit.parameters()) + sum(
        p.numel() for p in cross.parameters()) == sum(
        p.numel() for n, p in port.named_parameters()
        if n.split(".")[0] in ("patch_embed", "intrinsics_embed", "enc_blocks", "enc_norm",
                               "decoder_embed", "dec_blocks", "dec_blocks2", "dec_norm"))
    tok = torch.randn(1, 2, pos.shape[0], port.cfg.enc_embed_dim)
    with torch.no_grad():
        out = cross(tok)
    assert sorted(out) == sorted(set(port.cfg.dpt_hooks))


# --- on the card -------------------------------------------------------------


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; on the card: pytest -m cuda (module docstring)")
    return torch.device("cuda")


def _card_batch(b: int, card, seed: int) -> dict:
    """A batch of `b` stacks of 4 views (2 context, 2 targets) at SIZE."""
    g = torch.Generator().manual_seed(seed)
    v = 4
    images = torch.rand(b, v, SIZE, SIZE, 3, generator=g)
    extr = torch.eye(4).repeat(b, v, 1, 1)
    extr[..., 0, 3] = 0.05 * torch.arange(v)
    ctx = {"image": images, "intrinsics": _inputs(b=b)[1][:, :1].expand(b, v, 3, 3).clone(),
           "extrinsics": extr, "near": torch.full((b, v), 0.5), "far": torch.full((b, v), 100.0)}
    return {"context": {n: t.to(card) for n, t in ctx.items()}}


def _rel_gap(a, b) -> float:
    return float((a.double() - b.double()).norm() / b.double().norm().clamp(min=1e-30))


def _card_models(card):
    torch.manual_seed(0)
    cfg, _ = _cfgs()
    graphed = NoPoSplat(cfg, DecoderCfg(), device=card)
    eager = NoPoSplat(cfg, DecoderCfg(), device=card)
    eager.load_state_dict(graphed.state_dict())
    return graphed, eager


OPT = dict(lr=1e-3, cosine_lr=False, warm_up_steps=1)  # a constant rate from the first step


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["no_grad", "eval"])
def test_trunk_is_eager_on_the_card_outside_training(card, tmp_path, mode):
    """On the card, under no_grad and in eval mode, the trunk runs as
    modules: nothing is captured or replayed."""
    model, _ = _card_models(card)
    images, k = _inputs(b=2, seed=7)
    _check_eager_trunk(model, images.to(card), k.to(card), tmp_path, mode)


@pytest.mark.cuda
def test_graphed_trunk_steps_match_eager(card):
    """Two training steps of the trunk (a fixed weighted sum of the token
    maps the heads read as the loss, backward, the in-place Adam update),
    replayed as CUDA graphs, against the same steps with the stages run as
    modules from the same weights: the loss, every gradient and every
    updated parameter within 1e-4 relative (bit-equal on the H100). The
    second step replays the first's capture with the updated weights."""
    from pf3plat_tpu_torch.training import train

    graphed, eager = _card_models(card)
    b = 2
    x = torch.rand(b * 2, 3, SIZE, SIZE, generator=torch.Generator().manual_seed(3)).to(card)
    k = _inputs(b=b)[1].reshape(b * 2, 3, 3).to(card)
    grid = (SIZE // 16, SIZE // 16)
    pos = token_positions(*grid, card)
    runs = {}
    for name, model in (("graphed", graphed), ("eager", eager)):
        params = [*ViTTrunk(model, pos).parameters(), *CrossViewTrunk(model, pos).parameters()]
        opt = train.make_optimizer(train.OptimizerCfg(**OPT))
        state = train.init_opt_state(params)
        steps = []
        for i in range(2):
            for p in params:
                p.grad = None
            if name == "graphed":
                vit, cross = model._trunk(x, k, grid, (b, 2))
            else:
                vit, cross = ViTTrunk(model, pos), CrossViewTrunk(model, pos)
            tok = vit(x, k).unflatten(0, (b, 2))
            maps = [tok, *(t for pair in cross(tok).values() for t in pair)]
            g = torch.Generator().manual_seed(5)
            loss = sum(((torch.rand(t.shape, generator=g) + 0.5).to(card) * t).sum() for t in maps)
            loss.backward()
            state, _ = opt.apply(params, [p.grad for p in params], state)
            steps.append({"loss": float(loss), "grads": [p.grad.clone() for p in params],
                          "params": [p.detach().clone() for p in params]})
        runs[name] = steps
    assert len(graphed._trunk_graphs) == 1 and eager._trunk_graphs == {}
    for got, want in zip(runs["graphed"], runs["eager"]):
        assert abs(got["loss"] - want["loss"]) <= 1e-4 * abs(want["loss"])
        for key in ("grads", "params"):
            gaps = [_rel_gap(a, b) for a, b in zip(got[key], want[key])]
            assert max(gaps) <= 1e-4, (key, max(gaps))


# The whole train step's gradients and updates, graphed against eager, each
# leaf's gap (`_rel_gap`; an update's against the eager update from the
# same weights). Eager against eager they differ too: the backward outside
# the trunk adds in no fixed order (the heads' bilinear upsampling, the
# render) and the bf16 attention operands round those differences up. On
# the H100 (two steps at b=2, two runs): eager against eager, the worst
# leaf's gradient 1.0% / 3.8% apart, the median leaf's 0.007% / 0.44%, the
# median leaf's update 0.01% / 0.35%; graphed against eager, 0.7-0.8% /
# 2.5-9.1%, 0.007% / 0.48-0.49% and 0.01% / 0.29-0.32%. A doubled or a
# stale gradient reads 100% or so.
STEP_GRAD_WORST = 0.25
STEP_GRAD_MEDIAN = 0.02
STEP_UPDATE_MEDIAN = 0.02


@pytest.mark.cuda
def test_train_step_captures_once_a_shape(card, tmp_path):
    """NoPoSplat's train step on the card: the first step captures the
    trunk (one capture, two replays), the second replays it (no capture,
    two replays), a batch of another shape captures anew; a model with the
    stages run as modules replays nothing. After each of the two steps at
    b=2 (the second from the weights the in-place Adam update left) the
    loss is the eager one's within 1e-4 relative, and every gradient and
    every parameter's update within `STEP_*` of the eager ones."""
    import types

    from pf3plat_tpu_torch.training import train
    from pf3plat_tpu_torch.training.losses import LossCfg

    graphed, eager = _card_models(card)

    def modules_only(self, x, intrinsics, grid, views):
        pos = token_positions(*grid, x.device)
        return ViTTrunk(self, pos), CrossViewTrunk(self, pos)

    eager._trunk = types.MethodType(modules_only, eager)
    runs = {}
    for name, model in (("graphed", graphed), ("eager", eager)):
        step_fn = train.make_noposplat_train_step(model, LossCfg(lpips_weight=0.05),
                                                  train.OptimizerCfg(**OPT))
        state = train.init_train_state(model)
        start = [p.detach().clone() for p in state.params]
        seen = []
        for i, b in enumerate((2, 2, 1)):
            with profiling.trace(tmp_path / f"{name}{i}", window="w"):
                state, aux = step_fn(state, _card_batch(b, card, seed=10 + i))
            (path,) = (tmp_path / f"{name}{i}").glob("*.pt.trace.json")
            counters = json.loads(path.read_text())[profiling.COUNTERS]
            assert torch.isfinite(aux["loss"])
            seen.append({"loss": float(aux["loss"]),
                         "captures": counters.get("nopo.graph_captures", 0),
                         "replays": counters.get("nopo.graph_replays", 0),
                         "grads": [p.grad.detach().clone() for p in state.params],
                         "params": [p.detach().clone() for p in state.params]})
        runs[name] = seen, start
    (graphed_steps, start), (eager_steps, _) = runs["graphed"], runs["eager"]
    assert [s["captures"] for s in graphed_steps] == [1, 0, 1]
    assert [s["replays"] for s in graphed_steps] == [2, 2, 2]
    assert [(s["captures"], s["replays"]) for s in eager_steps] == [(0, 0)] * 3
    assert len(graphed._trunk_graphs) == 2
    before = start
    for i, (got, want) in enumerate(zip(graphed_steps[:2], eager_steps[:2])):
        assert abs(got["loss"] - want["loss"]) <= 1e-4 * abs(want["loss"]), i
        grads = [_rel_gap(a, b) for a, b in zip(got["grads"], want["grads"])]
        updates = [_rel_gap(a - p, b - p)
                   for a, b, p in zip(got["params"], want["params"], before)]
        print(f"step {i + 1}: loss {got['loss']} {want['loss']} grads worst {max(grads)} "
              f"median {statistics.median(grads)} updates worst {max(updates)} "
              f"median {statistics.median(updates)}")
        assert max(grads) <= STEP_GRAD_WORST, (i, max(grads))
        assert statistics.median(grads) <= STEP_GRAD_MEDIAN, (i, statistics.median(grads))
        assert statistics.median(updates) <= STEP_UPDATE_MEDIAN, (i, statistics.median(updates))
        before = want["params"]
