"""What decides `correct`: the benchmark's plain reference (`reference/`, a
frozen float32 copy of the port's model in plain PyTorch) against what the
timed path produced.

The reference follows the program stage by stage from the program's own
state, because random weights make perception's discrete choices (the
top-k keypoints, the matches) turn on rounding: UniDepth and SuperPoint
are compared from the images (SuperPoint's score and descriptor maps at the
program's keypoints), LightGlue from the program's keypoints, the encoder
from the program's perception outputs and the same RANSAC generator, the
answer from the program's Gaussians and poses. Training follows the
program's batches and perception outputs for the first steps, from the
seed's weights, with its own parameters.

Each number is a relative gap; a cell's limits are in
`cells/<workload>.json`. The control (`Rounded`) is the reference itself
with every product's operands rounded to a lower precision. Nothing here
imports the program.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from . import inputs, spec
from .reference.models.decoder import decode
from .reference.models.encoder import Correspondences, FrozenInputs
from .reference.models.pf3plat import PF3plat
from .reference.models.types import Gaussians
from .reference.precision import reference_precision
from .reference.training.losses import LossCfg, total_loss
from .reference.training.train import (
    ADAM_B1, OptimizerCfg, init_opt_state, make_schedule, opt_update)

# ---- configuration ------------------------------------------------------------


def fill(cls, tree: dict):
    """`cls` from the fields of `tree` that it has, nested dataclasses and
    tuples built as the program's config loader builds them."""
    kwargs = {}
    for f in dataclasses.fields(cls):
        if f.name not in tree:
            continue
        value = tree[f.name]
        default = getattr(cls(), f.name) if f.default is not dataclasses.MISSING or \
            f.default_factory is not dataclasses.MISSING else None
        if dataclasses.is_dataclass(default) and isinstance(value, dict):
            value = fill(type(default), value)
        elif isinstance(value, list):
            value = tuple(value)
        kwargs[f.name] = value
    return cls(**kwargs)


def build_reference(tree: dict, device) -> PF3plat:
    """PF3plat's reference (`architectures/pf3plat.py`), for PF3plat's own
    loops."""
    arch = spec.load_module(spec.HERE / "architectures" / "pf3plat.py", "pf3bench_architecture")
    return arch.build_reference(tree, device)


# ---- the control's precision ----------------------------------------------------

def round_to(x: torch.Tensor, dtype) -> torch.Tensor:
    """x rounded to `dtype` and back; float8 with one scale per tensor (its
    largest magnitude onto the format's largest finite value); "tf32"
    keeps float32's 10 leading mantissa bits, rounded to nearest (what the
    card's TF32 products see of their operands)."""
    if dtype == "tf32":
        bits = x.float().contiguous().view(torch.int32)
        bits = (bits + 0x1000) & ~0x1FFF
        return bits.view(torch.float32).to(x.dtype)
    if dtype in (torch.float8_e4m3fn, torch.float8_e5m2):
        amax = x.abs().amax().float()
        if not bool(amax > 0):
            return x
        scale = amax / torch.finfo(dtype).max
        return ((x / scale).to(dtype).to(x.dtype) * scale).to(x.dtype)
    return x.to(dtype).to(x.dtype)


class Rounded(TorchDispatchMode):
    """Every matrix product and convolution, forward and backward, with its
    float32 operands rounded to `dtype`, and every fused attention with its
    q, k and v rounded (the accumulation stays float32)."""

    def __init__(self, dtype):
        super().__init__()
        self.dtype = dtype
        a = torch.ops.aten
        self.products = {a.mm.default, a.addmm.default, a.bmm.default, a.baddbmm.default,
                         a.convolution.default, a.convolution_backward.default}
        self.attention = {getattr(a, name).default for name in (
            "_scaled_dot_product_efficient_attention", "_scaled_dot_product_flash_attention",
            "_scaled_dot_product_cudnn_attention", "_scaled_dot_product_flash_attention_for_cpu")
            if hasattr(a, name)}

    def _round(self, x):
        if isinstance(x, torch.Tensor) and x.dtype == torch.float32:
            return round_to(x, self.dtype)
        return x

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in self.products:
            args = tuple(self._round(a) for a in args)
        elif func in self.attention:
            args = tuple(self._round(a) for a in args[:3]) + tuple(args[3:])
        return func(*args, **kwargs)


# ---- gaps ---------------------------------------------------------------------------


def rel(a, b) -> float:
    """||a - b|| / ||b|| over whole tensors, in float64."""
    a = torch.as_tensor(a).double().cpu()
    b = torch.as_tensor(b).double().cpu()
    den = float(torch.linalg.vector_norm(b))
    num = float(torch.linalg.vector_norm(a - b))
    if not math.isfinite(num):
        return math.inf
    return num / den if den > 0 else (0.0 if num == 0 else math.inf)


def ratio(num: float, den: float) -> float:
    return num / den if den > 0 else (0.0 if num == 0 else math.inf)


def _dev(x, device):
    return torch.as_tensor(x).to(device, torch.float32)


class Recorder:
    """While `on`, keeps what a model's perception returns: `perceive`'s
    outputs and, with `matching`, SuperPoint's keypoints, each LightGlue
    call's matches and its last layer's descriptors, in call order. It
    wraps the entry points as instance attributes over the methods (of the
    program's model or the reference's); `close` takes them away again."""

    LISTS = ("matches", "descriptors")

    def __init__(self, model, matching: bool = False):
        self.on = False
        self.wrapped = [(model, "perceive", "perceived")]
        if matching:
            self.wrapped += [(model.superpoint, "forward", "keypoints"),
                             (model.lightglue, "forward", "matches"),
                             (model.lightglue.transformers[-1].cross_attn, "forward",
                              "descriptors")]
        self.clear()
        for obj, attr, key in self.wrapped:
            self._wrap(obj, attr, key)

    def _wrap(self, obj, attr: str, key: str) -> None:
        orig = getattr(obj, attr)

        def wrapper(*args, **kwargs):
            out = orig(*args, **kwargs)
            if self.on:
                if key in self.LISTS:
                    self.kept[key].append(tuple(out))
                else:
                    self.kept[key] = tuple(out)
            return out

        setattr(obj, attr, wrapper)

    def clear(self) -> None:
        self.kept = {"perceived": None, "keypoints": None, "matches": [], "descriptors": []}

    def take(self) -> dict:
        """What was kept since the last `take`."""
        p = self.kept["perceived"]
        out = {"frozen": tuple(p[0]), "corr": tuple(p[1])} if p is not None else {}
        if len(self.wrapped) > 1:
            out.update(keypoints=self.kept["keypoints"], matches=tuple(self.kept["matches"]),
                       descriptors=tuple(self.kept["descriptors"]))
        self.clear()
        return out

    def close(self) -> None:
        for obj, attr, _ in self.wrapped:
            delattr(obj, attr)


# ---- serving ----------------------------------------------------------------------


def perceive(model: PF3plat, images, intrinsics, device):
    with torch.no_grad():
        return model.perceive(_dev(images, device), _dev(intrinsics, device))


def encode(model: PF3plat, req: dict, frozen, corr, device):
    """The reference encoder on a request, fed `frozen` and `corr`, with
    the request's RANSAC generator."""
    gen = torch.Generator(device=device).manual_seed(req["ransac_seed"])
    frozen = FrozenInputs(*(_dev(x, device) for x in frozen))
    corr = Correspondences(*(_dev(x, device) for x in corr[:3]),
                           torch.as_tensor(corr[3]).to(device))
    with torch.no_grad():
        return model.encoder(_dev(req["images"], device), _dev(req["intrinsics"], device),
                             _dev(req["near"], device), _dev(req["far"], device),
                             frozen, corr, 0, generator=gen)


def render_views(model: PF3plat, gaussians, poses, req: dict, device):
    """The views at `poses` (w2c, b x v) rendered from `gaussians`."""
    c2w = torch.linalg.inv(_dev(poses, device))
    g = Gaussians(*(_dev(x, device) for x in gaussians))
    h, w = req["images"].shape[2:4]
    with torch.no_grad():
        return decode(model.cfg.decoder, g, c2w, _dev(req["intrinsics"], device),
                      _dev(req["near"], device), _dev(req["far"], device), (h, w)).color


def keypoint_gaps(model: PF3plat, images, keypoints, device, look: dict | None) -> float:
    """SuperPoint: the scores and descriptors at the record's keypoints
    against the reference's score and descriptor maps at the same points
    (its keypoints are chosen from scores that random weights make nearly
    equal, so the choice turns on rounding; the values do not)."""
    from .reference.models.backbones.superpoint import _descriptor_sample

    xy, scores, desc, valid = (torch.as_tensor(x).to(device) for x in keypoints)
    imgs = _dev(images, device)
    imgs = imgs.reshape(-1, *imgs.shape[-3:])
    with torch.no_grad():
        score_map, desc_map = model.superpoint.dense(imgs)
        ref_valid = model.superpoint(imgs).valid
    n = torch.arange(xy.shape[0], device=device)[:, None].expand(xy.shape[:2])
    ix = xy.long()
    ref_scores = score_map[n, ix[..., 1], ix[..., 0]]
    ref_desc = _descriptor_sample(desc_map, xy.float())
    if look is not None:
        look.update(keypoints_valid=int(valid.sum()), reference_valid=int(ref_valid.sum()))
    if not bool(valid.any()):
        return math.inf if bool(ref_valid.any()) else 0.0
    return max(rel(scores[valid], ref_scores[valid]), rel(desc[valid], ref_desc[valid]))


def match_gaps(model: PF3plat, images, keypoints, matches, descriptors, device,
               look: dict | None) -> float:
    """LightGlue: each view pair's descriptors after its last layer (the
    whole transformer stack) against the reference's LightGlue fed the
    record's own keypoints. The match scores go to the look, on the
    keypoints that both find a mutual nearest neighbour for: random
    weights leave about two a pair, and the mutual test turns on rounding."""
    from .reference.models.backbones.superpoint import Keypoints
    from .reference.models.encoder import view_pairs

    b, v, h, w = torch.as_tensor(images).shape[:4]
    kp = [torch.as_tensor(x).to(device) for x in keypoints]
    kp = [x.reshape(b, v, *x.shape[1:]) for x in kp]
    kp[0], kp[1], kp[2] = kp[0].float(), kp[1].float(), kp[2].float()
    recorder = Recorder(model, matching=True)
    recorder.on = True
    got, want, scores, agree, mutual = [], [], [[], []], 0, 0
    try:
        with torch.no_grad():
            for (i, j), m, d in zip(zip(*view_pairs(v)), matches, descriptors):
                res = model.lightglue(Keypoints(*(x[:, i] for x in kp)),
                                      Keypoints(*(x[:, j] for x in kp)), (h, w))
                ref_d = recorder.take()["descriptors"][-1]
                got += [torch.as_tensor(x).to(device).float() for x in d]
                want += list(ref_d)
                s = torch.as_tensor(m[1]).to(device).float()
                both = (s > 0) & (res.scores0 > 0)
                scores[0].append(s[both])
                scores[1].append(res.scores0[both])
                agree += int(both.sum())
                mutual += int((s > 0).sum())
    finally:
        recorder.close()
    if look is not None:
        look.update(mutual_rows=mutual, mutual_agreed=agree,
                    match_scores=rel(torch.cat(scores[0]), torch.cat(scores[1])) if agree else None)
    if not got:
        return math.inf
    return rel(torch.cat([x.flatten() for x in got]), torch.cat([x.flatten() for x in want]))


# the Gaussians' fields compared in units of the reference's own gap at TF32
TF32_UNITS = ("covariances", "harmonics")


def serve_gaps(model: PF3plat, rec: dict, answer, device, detail: dict | None = None) -> dict:
    """The gaps of one served request's record (the program's or the
    control's) to the reference, each stage from the record's previous
    one: perception (UniDepth's depth and features, SuperPoint's scores and
    descriptors) from the images, LightGlue from the record's keypoints,
    the encoder from the record's perception outputs, and the answer
    (`answer(model, gaussians, poses, rec, device)`, a dict of the loop's
    answer arrays) from its Gaussians and refined poses.

    *covariances* and *harmonics* are gaps in units of the reference's own
    at TF32 (the encoder with its products' operands rounded to TF32, from
    the same inputs): across scenes these gaps swing with how the scene
    conditions their heads, the same for the program and the control, and
    the unit takes that swing out (PERF.md)."""
    look = {} if detail is None else detail
    with reference_precision():
        frozen, _ = perceive(model, rec["images"], rec["intrinsics"], device)
        gaps = {"perceive": max(rel(rec["frozen"][0], frozen.depth),
                                rel(rec["frozen"][1], frozen.features)),
                "keypoints": keypoint_gaps(model, rec["images"], rec["keypoints"], device, look),
                "lightglue": match_gaps(model, rec["images"], rec["keypoints"], rec["matches"],
                                        rec["descriptors"], device, look)}
        enc = encode(model, rec, rec["frozen"], rec["corr"], device)
        with Rounded("tf32"):
            tf32 = encode(model, rec, rec["frozen"], rec["corr"], device)
        g = rec["gaussians"]
        fields = {f: rel(a, b) for f, a, b in zip(Gaussians._fields, g, enc.gaussians)}
        gaps.update(fields, means=max(fields["means"], rel(rec["depths"], enc.depths)))
        for f in TF32_UNITS:
            scale = rel(getattr(tf32.gaussians, f), getattr(enc.gaussians, f))
            gaps[f] = ratio(fields[f], scale)
            look.update({f"{f}_gap": fields[f], f"{f}_tf32": scale})
        look.update(depths=rel(rec["depths"], enc.depths),
                    depth=rel(rec["frozen"][0], frozen.depth),
                    features=rel(rec["frozen"][1], frozen.features))
        for k, want in answer(model, g, rec["refined_poses"], rec, device).items():
            gaps[k] = rel(rec[k], want)
    return gaps


def control_record(model: PF3plat, req: dict, answer, device,
                   perception=torch.float8_e4m3fn, rest=torch.bfloat16) -> dict:
    """The control's record of a request: the reference in the program's
    place, perception's products in float8 (the program's stated bfloat16
    one step down), the encoder's and the decoder's in bfloat16 (its
    float32 one step down, the Gaussians rounded to bfloat16 before the
    render), each stage fed its own previous stage."""
    rec = dict(req)
    recorder = Recorder(model, matching=True)
    recorder.on = True
    try:
        with reference_precision():
            with Rounded(perception):
                perceive(model, req["images"], req["intrinsics"], device)
            rec.update(recorder.take())
            with Rounded(rest):
                enc = encode(model, rec, rec["frozen"], rec["corr"], device)
                g = Gaussians(*(round_to(x, rest) for x in enc.gaussians))
                rec.update(refined_poses=enc.refined_poses, depths=enc.depths, gaussians=g)
                rec.update(answer(model, g, enc.refined_poses, rec, device))
    finally:
        recorder.close()
    return rec


# ---- training ---------------------------------------------------------------------


def train_cfgs(tree: dict) -> tuple[LossCfg, OptimizerCfg]:
    return fill(LossCfg, tree.get("loss", {})), fill(OptimizerCfg, tree.get("optimizer", {}))


def reference_steps(model: PF3plat, steps: list[dict], tree: dict, seed: int, device,
                    precision=None) -> dict:
    """The reference's own training from the weights loaded in `model`,
    following the program's batches and perception outputs (`steps`, one
    record each): each step's loss and parts, the first gradient as the
    optimizer gets it (from Adam's first moment after one step), the
    first raw gradient, and the parameters after the last step."""
    loss_cfg, opt_cfg = train_cfgs(tree)
    schedule = make_schedule(opt_cfg)
    params = list(model.encoder.parameters())
    for p in params:
        p.requires_grad_(True)
    state = init_opt_state(params)
    out = {"loss": [], "parts": []}
    lpips_fn = model.lpips_apply if loss_cfg.lpips_weight > 0 else None
    ctx = Rounded(precision) if precision is not None else None
    with reference_precision():
        for step, rec in enumerate(steps):
            b = rec["batch"]
            images, intr, near, far = (_dev(b[k], device)
                                       for k in ("image", "intrinsics", "near", "far"))
            target = _dev(b["target"], device)
            frozen = FrozenInputs(*(_dev(x, device) for x in rec["frozen"]))
            c = rec["corr"]
            corr = Correspondences(*(_dev(x, device) for x in c[:3]),
                                   torch.as_tensor(c[3]).to(device))
            gen = torch.Generator(device=device).manual_seed(inputs.step_seed(seed, step))
            for p in params:
                p.grad = None
            if ctx is not None:
                ctx.__enter__()
            try:
                enc = model.encoder(images, intr, near, far, frozen, corr, step, generator=gen)
                c2w = torch.linalg.inv(enc.refined_poses)
                color = decode(model.cfg.decoder, enc.gaussians, c2w, intr, near, far,
                               tuple(images.shape[2:4])).color
                loss, parts = total_loss(loss_cfg, color, target, enc, intr, step,
                                         lpips_fn=lpips_fn)
                loss.backward()
            finally:
                if ctx is not None:
                    ctx.__exit__(None, None, None)
            grads = [torch.zeros_like(p) if p.grad is None else p.grad for p in params]
            if step == 0:
                out["raw_grad"] = [float(torch.linalg.vector_norm(g)) for g in grads]
            updates, state = opt_update(opt_cfg, schedule, grads, state)
            with torch.no_grad():
                for p, u in zip(params, updates):
                    p.add_(u)
            out["loss"].append(float(loss.detach()))
            out["parts"].append({k: float(v.detach()) for k, v in parts.items()})
            if step == 0:
                out["grad"] = [float(torch.linalg.vector_norm(m / (1 - ADAM_B1)))
                               for m in state.mu]
            del enc, color, loss, parts, grads, updates
    out["params"] = [p.detach().to("cpu", copy=True) for p in params]
    return out


def leaf_gaps(got: list[float], want: list[float], keep=None) -> list[tuple[float, int]]:
    """(|got - want| / max(want, the median leaf's want), leaf index) for
    each kept leaf, smallest first."""
    idx = [i for i in range(len(want)) if keep is None or keep[i]]
    median = float(np.median([want[i] for i in idx])) if idx else 0.0
    out = []
    for i in idx:
        den = max(want[i], median)
        gap = abs(got[i] - want[i]) / den if den > 0 else (0.0 if got[i] == want[i] else math.inf)
        out.append((gap if math.isfinite(gap) else math.inf, i))
    return sorted(out)


def train_gaps(prog: dict, ref: dict, w0: list[torch.Tensor], names: list[str]
               ) -> tuple[dict, dict]:
    """`prog` / `ref`: each step's loss, the first gradient's leaf norms as
    the optimizer got them, the parameters after the last step -> (the
    numbers compared, the look). *loss* is the worst step's relative gap;
    *grad* and *update* are the worst leaf's gap of the first gradient's
    norm and of the change's norm, against the larger of that leaf's and
    the median leaf's reference norm; *update_median* is the median leaf's
    gap of the change (TF32 rounding moves single leaves' changes by up to
    half their norm, so a state left unchanged, which reads 1, is caught by
    the median leaf and not the worst; PERF.md). Leaves whose reference
    gradient is under a thousandth of the median leaf's are left out of the
    change (they move by round-off alone under Adam). The look keeps every
    leaf's norms."""
    steps = [abs(a - b) / abs(b) if b != 0 else math.inf
             for a, b in zip(prog["loss"], ref["loss"])]
    median = float(np.median(ref["raw_grad"]))
    keep = [g >= 1e-3 * median for g in ref["raw_grad"]]
    dp = [float(torch.linalg.vector_norm(p.double() - w.double()))
          for p, w in zip(prog["params"], w0)]
    dr = [float(torch.linalg.vector_norm(p.double() - w.double()))
          for p, w in zip(ref["params"], w0)]
    grad, update = leaf_gaps(prog["grad"], ref["grad"]), leaf_gaps(dp, dr, keep)
    look = {"loss_by_step": steps,
            "grad_worst": [(g, names[i]) for g, i in grad[-3:]],
            "update_worst": [(g, names[i]) for g, i in update[-3:]],
            "grad_median": float(np.median([g for g, _ in grad])),
            "update_median": float(np.median([g for g, _ in update])),
            "leaves": {"names": names, "numel": [int(w.numel()) for w in w0],
                       "raw_grad": ref["raw_grad"], "ref_grad": ref["grad"],
                       "grad": prog["grad"], "ref_change": dr, "change": dp}}
    return ({"loss": max(steps), "grad": grad[-1][0], "update": update[-1][0],
             "update_median": look["update_median"]}, look)
