"""The optimizer update in place (`training/train.py:Optimizer.apply`) and
its two Adam kernels (`csrc/adam.cu`).

On the CPU: `apply` against `opt_update` plus `p.add_` bit for bit; the
host's decision from the norm pass's [sum of squares, flag] (`adam_step`)
against `opt_update`'s own; the kernels' work list; the counters of the
kernel path (its launches replaced by plain stand-ins). `cuda`-marked, on
the card at NoPoSplat's leaf shapes: the norm pass against the plain
`global_norm` and against itself, params and moments bit for bit against
`opt_update` fed the kernel's norm, and two launches and one host sync an
update. On the card's machine: `python3 -m pytest tests/test_torch_adam.py
-m cuda -o addopts="" --noconftest`."""

from __future__ import annotations

import json
import warnings

import numpy as np
import pytest
import torch

from pf3plat_tpu_torch.ops.rasterizer import kernels
from pf3plat_tpu_torch.training import train
from pf3plat_tpu_torch.utils import profiling

SHAPES = ((4, 3), (7,), (2, 2, 2), (5,))
NO_GRAD = 3  # the leaf that takes no gradient


def _bits(x: torch.Tensor) -> torch.Tensor:
    return x.detach().cpu().contiguous().view(torch.int32)


def _grads(rng, scale: float, nan: bool = False, shapes=SHAPES):
    grads = [torch.as_tensor((scale * rng.standard_normal(s)).astype(np.float32))
             for s in shapes]
    if nan:
        grads[1][3] = float("nan")
    grads[NO_GRAD] = None
    return grads


# (per-step gradient scales, steps with a NaN, the first state's count of
# consecutive non-finite steps): global norms ~6 clip, ~0.03 do not
CASES = {
    "clip": ((1.0,) * 5, (), 0),
    "no_clip": ((0.01,) * 5, (), 0),
    "clip_on_and_off": ((1.0, 0.01, 1.0, 0.01, 0.01), (), 0),
    "nan_skipped": ((1.0,) * 5, (1, 2), 0),
    "give_up": ((1.0,) * 5, (0, 2), 100),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_apply_on_cpu_is_opt_update_and_add(case):
    """Five updates through `Optimizer.apply` against `opt_update` and
    `p.add_` with zeros for the gradient-less leaf: parameters, moments,
    counts and the gradient norm bit for bit."""
    scales, nans, notfinite = CASES[case]
    cfg = train.OptimizerCfg(max_steps=1000)
    opt = train.make_optimizer(cfg)
    rng = np.random.default_rng(0)
    params = [torch.as_tensor(rng.standard_normal(s).astype(np.float32)) for s in SHAPES]
    ref = [p.clone() for p in params]
    state = opt.init(params)._replace(notfinite_count=notfinite)
    ref_state = state
    for k, scale in enumerate(scales):
        grads = _grads(rng, scale, nan=k in nans)
        state, norm = opt.apply(params, grads, state)
        full = [torch.zeros_like(p) if g is None else g for p, g in zip(ref, grads)]
        updates, ref_state = train.opt_update(cfg, opt.schedule, full, ref_state)
        for p, u in zip(ref, updates):
            p.add_(u)
        assert torch.equal(_bits(norm), _bits(train.global_norm(full)))
        assert (state.count, state.notfinite_count) == (ref_state.count,
                                                         ref_state.notfinite_count)
        for a, b in zip(params + state.mu + state.nu, ref + ref_state.mu + ref_state.nu):
            assert torch.equal(_bits(a), _bits(b))
    if case == "nan_skipped":
        assert state.count == 3 and state.notfinite_count == 0
    if case == "give_up":  # step 0 is the 101st failure in a row: applied
        assert state.count == 4 and bool(torch.isnan(params[0]).all())


# (count, consecutive non-finite steps, gradient scale, NaN): the state
# before the update; scale 0.5 / 6.5 puts the norm just under / over 0.5
DECISIONS = {
    "first": (0, 0, 1.0, False),
    "warm_up": (7, 0, 1.0, False),
    "past_warm_up": (2000, 0, 1.0, False),
    "small_norm": (3, 0, 0.01, False),
    "norm_just_under_clip": (3, 0, 0.5 / 6.5, False),
    "zero_gradients": (3, 0, 0.0, False),
    "nonfinite_skipped": (3, 5, 1.0, True),
    "nonfinite_100th": (3, 99, 1.0, True),
    "nonfinite_give_up": (3, 100, 1.0, True),
    "finite_resets": (3, 100, 1.0, False),
}


@pytest.mark.parametrize("case", sorted(DECISIONS))
def test_host_decision_is_opt_updates(case):
    """`adam_step` from the gradients' sum of squares and flag against
    what `opt_update` does with the same gradients and state: whether it
    applies, the next count and failure count, the schedule's count, the
    clip, and (lr, bc1, bc2) reproducing its updates bit for bit from its
    own moments."""
    count0, notfinite, scale, nan = DECISIONS[case]
    cfg = train.OptimizerCfg(max_steps=1000)
    schedule = train.make_schedule(cfg)
    asked = []

    def spy(k):
        asked.append(k)
        return schedule(k)

    grads = _grads(np.random.default_rng(1), scale, nan=nan)
    grads[NO_GRAD] = torch.zeros(SHAPES[NO_GRAD])
    state = train.init_opt_state(grads)._replace(count=count0, notfinite_count=notfinite)
    updates, want = train.opt_update(cfg, spy, grads, state)
    sumsq = float(sum(torch.sum(g.double() * g.double()) for g in grads))
    nonfinite = not all(bool(torch.isfinite(g).all()) for g in grads)
    step, got = train.adam_step(cfg, schedule, state, sumsq, nonfinite)
    assert (got.count, got.notfinite_count) == (want.count, want.notfinite_count)
    if step is None:
        assert not asked and all(not bool(u.any()) for u in updates)
        return
    assert asked == [count0] and step.lr == schedule(count0)
    # the clip: the first moment from zero is 0.1 * the (clipped) gradient
    norm = train.global_norm(grads)
    if not nan:
        assert abs(float(step.norm) - float(norm)) <= 1e-6 * float(norm)
    assert step.clip == (not bool(norm < cfg.grad_clip))
    for g, m in zip(grads, want.mu):
        g = (g / norm) * cfg.grad_clip if step.clip else g
        mine = (1 - train.ADAM_B1) * g + train.ADAM_B1 * torch.zeros_like(g)
        assert torch.equal(_bits(m), _bits(mine))
    for m, v, u in zip(want.mu, want.nu, updates):
        mine = -step.lr * ((m / step.bc1) / (torch.sqrt(v / step.bc2 + train.ADAM_EPS_ROOT)
                                             + train.ADAM_EPS))
        assert torch.equal(_bits(mine), _bits(u))


def _leaf(numel: int, offset: int = 0) -> torch.Tensor:
    return torch.zeros(numel + offset)[offset:]


@pytest.mark.parametrize("numels,offset", [
    ((1,), 0), ((3,), 0), ((4,), 0), ((65_537,), 0),
    ((1, 3, 4, 65_537, 3 * train.ADAM_CHUNK + 5), 0),
    ((4, 65_537), 1),
], ids=["1", "3", "4", "65537", "mixed", "storage_offset"])
def test_work_list_covers_every_element_once(numels, offset):
    """Every element of every leaf in exactly one item, in the item's
    16-byte part or its tail; items start at multiples of 4 elements and
    hold at most ADAM_CHUNK; a leaf whose storage offset breaks 16-byte
    alignment takes no 16-byte accesses."""
    params = [_leaf(n, offset) for n in numels]
    moments = [torch.zeros(n) for n in numels]
    items = train.adam_work_list(params, moments, moments)
    assert items.dtype == np.int32 and items.shape[1] == 4
    seen = [np.zeros(n, np.int64) for n in numels]
    for leaf, start, length, vec in items.tolist():
        assert 0 < length <= train.ADAM_CHUNK and start % 4 == 0
        assert vec % 4 == 0 and 0 <= vec <= length
        aligned = params[leaf].data_ptr() % 16 == 0
        assert vec == (length & ~3 if aligned else 0)
        seen[leaf][start:start + vec] += 1  # 16-byte part
        seen[leaf][start + vec:start + length] += 1  # one at a time
    assert all((s == 1).all() for s in seen)
    if offset:
        assert not any(row[3] for row in items.tolist())


class _FakePlan:
    """`_AdamPlan` for CPU tensors: what the kernels would read."""

    def __init__(self, params, mu, nu):
        self.params, self.mu, self.nu = params, mu, nu

    def set_grads(self, params, grads):
        self.step_grads = grads


def _fake_norm(plan):
    grads = [g for g in plan.step_grads if g is not None]
    sumsq = sum(torch.sum(g * g) for g in grads)
    flag = float(not all(bool(torch.isfinite(g).all()) for g in grads))
    return torch.stack([sumsq, torch.tensor(flag), torch.sqrt(sumsq)])


def test_kernel_path_counters(monkeypatch, tmp_path):
    """The kernel path's counters under a profiler session, its launches
    replaced by plain stand-ins: each applied update adds the leaves, the
    elements and one fused update; a skipped (NaN) step adds none and
    launches no update pass."""
    launched = []
    monkeypatch.setattr(train, "_AdamPlan", _FakePlan)
    monkeypatch.setattr(train, "adam_norm_cuda", lambda plan: launched.append("norm")
                        or _fake_norm(plan))
    monkeypatch.setattr(train, "adam_update_cuda",
                        lambda plan, step, cfg: launched.append("update"))
    opt = train.make_optimizer(train.OptimizerCfg(max_steps=1000))
    rng = np.random.default_rng(2)
    params = [torch.zeros(s) for s in SHAPES]
    state = opt.init(params)

    def run():
        nonlocal state
        for nan in (False, True, False):
            with profiling.span("pf3.train_step"):
                state, _ = opt._apply_cuda(params, _grads(rng, 1.0, nan=nan), state)

    with profiling.trace(tmp_path, window="w"):
        run()
    (path,) = tmp_path.glob("*.pt.trace.json")
    counters = json.loads(path.read_text())[profiling.COUNTERS]
    numel = sum(int(np.prod(s)) for s in SHAPES)
    assert counters == {"adam.leaves": 2 * len(SHAPES), "adam.elements": 2 * numel,
                        "adam.fused_updates": 2}
    assert launched == ["norm", "update", "norm", "norm", "update"]
    assert (state.count, state.notfinite_count) == (2, 0)


# --- on the card -------------------------------------------------------------


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; on the card: pytest -m cuda (module docstring)")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def nopo_shapes(card):
    """The shapes of NoPoSplat's trained leaves at its published widths,
    plus a leaf whose storage offset breaks 16-byte alignment (appended by
    `_leaves`)."""
    from pf3plat_tpu_torch.models.noposplat import NoPoSplat, NoPoSplatCfg

    model = NoPoSplat(NoPoSplatCfg(), device=card)
    shapes = [tuple(p.shape) for p in model.trainable_parameters()]
    del model
    torch.cuda.empty_cache()
    return shapes


def _params(shapes, card, seed: int):
    """Parameters at the shapes, and one more whose storage offset breaks
    16-byte alignment."""
    gen = torch.Generator(device=card).manual_seed(seed)
    params = [torch.randn(s, device=card, generator=gen) for s in shapes]
    return params + [torch.randn(1001, device=card, generator=gen)[1:]]


def _grads_like(params, seed: int, scale: float = 1.0):
    """Gradients for `params`, the third leaf without one."""
    gen = torch.Generator(device=params[0].device).manual_seed(seed)
    grads = [scale * torch.randn(p.shape, device=p.device, generator=gen) for p in params]
    grads[2] = None
    return grads


@pytest.mark.cuda
def test_norm_pass_on_card(card, nopo_shapes):
    """The norm pass against `global_norm` and against the norm in float64,
    within 1e-6 relative each, its bits equal on two runs; an infinity
    sets the flag."""
    params = _params(nopo_shapes, card, 0)
    grads = _grads_like(params, 1)
    state = train.init_opt_state(params)
    plan = train._AdamPlan(params, state.mu, state.nu)
    plan.set_grads(params, grads)
    first = train.adam_norm_cuda(plan)
    second = train.adam_norm_cuda(plan)
    real = [g for g in grads if g is not None]
    plain = float(train.global_norm(real))
    exact = float(torch.sqrt(sum(torch.sum(g.double() ** 2) for g in real)))
    assert torch.equal(_bits(first), _bits(second))
    assert float(first[1]) == 0.0
    assert float(first[2]) == float(np.sqrt(np.float32(float(first[0]))))
    for want in (plain, exact):
        assert abs(float(first[2]) - want) <= 1e-6 * want, (float(first[2]), plain, exact)
    grads[5].view(-1)[7] = float("inf")
    plan.set_grads(params, grads)
    assert float(train.adam_norm_cuda(plan)[1]) == 1.0


@pytest.mark.cuda
@pytest.mark.parametrize("scale", [1.0, 1e-7], ids=["clip", "no_clip"])
def test_update_bit_equal_to_plain_on_card(card, nopo_shapes, monkeypatch, scale):
    """Three updates through the kernels against `opt_update` and `p.add_`
    on the card, fed the kernel's norm: parameters, moments and counts bit
    for bit."""
    params = _params(nopo_shapes, card, 2)
    ref = [p.clone() for p in params]
    opt = train.make_optimizer(train.OptimizerCfg(max_steps=1000))
    state, ref_state = opt.init(params), opt.init(ref)
    for k in range(3):
        grads = _grads_like(params, 10 + k, scale)
        state, norm = opt.apply(params, grads, state)
        assert (float(norm) < 0.5) == (scale < 1.0)
        monkeypatch.setattr(train, "global_norm", lambda _, norm=norm: norm)
        full = [torch.zeros_like(p) if g is None else g for p, g in zip(ref, grads)]
        updates, ref_state = train.opt_update(opt.cfg, opt.schedule, full, ref_state)
        monkeypatch.undo()
        for p, u in zip(ref, updates):
            p.add_(u)
        del full, updates
        assert state.count == ref_state.count == k + 1
        groups = (("params", params, ref), ("mu", state.mu, ref_state.mu),
                  ("nu", state.nu, ref_state.nu))
        for name, got, want in groups:
            bad = [i for i, (a, b) in enumerate(zip(got, want)) if not torch.equal(
                a.view(torch.int32), b.contiguous().view(torch.int32))]
            assert not bad, f"step {k}: {name} differs at leaves {bad[:8]} of {len(got)}"


@pytest.mark.cuda
def test_two_launches_and_one_sync_an_update(card):
    """An update on the card: two kernels (the profiler's device events)
    and one host sync (torch's sync debug mode)."""
    params = _params([(1024, 1024), (4096,), (3, 5)], card, 3)
    grads = _grads_like(params, 4)
    opt = train.make_optimizer(train.OptimizerCfg())
    state = opt.init(params)
    state, _ = opt.apply(params, grads, state)  # builds the plan
    torch.cuda.synchronize()
    before = kernels.LAUNCHES["adam"]
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                state, _ = opt.apply(params, grads, state)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
    syncs = [str(w.message) for w in caught
             if "called a synchronizing CUDA operation" in str(w.message)]
    names = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
             and "memcpy" not in e.name.lower() and "memset" not in e.name.lower()]
    assert kernels.LAUNCHES["adam"] - before == 2
    assert len(names) == 2 and all("adam" in n for n in names), names
    assert len(syncs) == 1, syncs
