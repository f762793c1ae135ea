"""NoPoSplat on the port (`models/noposplat.py`) against the plain float32
reference (`tests/noposplat_reference.py`) on seeded weights at a tiny size
(64 x 64 images, an encoder of 2 blocks of width 64 with 4 heads, decoders of
2 blocks of width 48), the benchmark's copy of the reference held to it bit
for bit, and one training step through the port's entry point.

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
from pf3plat_tpu_torch.models.noposplat import NoPoSplat, NoPoSplatCfg, token_positions
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
