"""Checkpoint save/restore with `torch.save`.

Port of `pf3plat_tpu/training/checkpoints.py` (orbax there) with its
semantics: the training state (the encoder's parameters, Adam's moments and
count, the non-finite counter, the step) is saved every `every_n_steps`,
the newest `keep` are kept, a forced save covers a run's last step, and the
frozen perception weights are stored once (`frozen/`) since they never
change. `restore_latest` warm-starts from `load` (another run's directory,
its `frozen/` carried along) when this run has no state of its own.

Layout under `directory`: `state/<step>/state.pt` and `frozen/frozen.pt`
(each written to a temporary name and renamed into place). Over several
processes only the manager made with `writer=True` (rank 0) writes: the
state is replicated, so one copy is the whole of it (orbax's multi-process
save writes one copy of a replicated tree); every rank restores.

`load_jax_checkpoint` reads a JAX-package orbax checkpoint into the port
(only where `orbax` imports).
"""

from __future__ import annotations

import dataclasses
import os
import shutil
from pathlib import Path
from typing import Optional

import torch

from .train import OptState, TrainState

# The frozen modules of `models.pf3plat.PF3plat`, by their key in the JAX
# package's frozen parameter tree.
FROZEN_MODULES = ("unidepth", "superpoint", "lightglue", "lpips")


@dataclasses.dataclass(frozen=True)
class CheckpointCfg:
    directory: Path = Path("checkpoints")
    every_n_steps: int = 10_000
    keep: int = 5
    # Warm-start: another run's checkpoint directory to restore from when
    # this run has no state of its own (reference `checkpointing.load`,
    # `config/main.yaml`). Training continues from the loaded step into
    # this run's directory.
    load: Optional[Path] = None


def frozen_state(model) -> dict:
    """The frozen modules' tensors: {module: state_dict}, of those the
    model has (NoPoSplat's LPIPS alone)."""
    return {k: getattr(model, k).state_dict() for k in FROZEN_MODULES if hasattr(model, k)}


def load_frozen_state(model, frozen: dict) -> None:
    for k in FROZEN_MODULES:
        if hasattr(model, k):
            getattr(model, k).load_state_dict(frozen[k])


def _save_atomic(obj, path: Path) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{path.name}.tmp{os.getpid()}")
    torch.save(obj, tmp)
    os.replace(tmp, path)


class CheckpointManager:
    def __init__(self, cfg: CheckpointCfg, writer: bool = True):
        self.cfg = cfg
        self.writer = writer
        path = Path(cfg.directory).absolute()
        path.mkdir(parents=True, exist_ok=True)
        self._state_dir = path / "state"
        self._frozen_dir = path / "frozen"

    def all_steps(self) -> list[int]:
        if not self._state_dir.exists():
            return []
        return sorted(int(p.name) for p in self._state_dir.iterdir()
                      if p.name.isdigit() and (p / "state.pt").exists())

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def has_frozen(self) -> bool:
        return self._frozen_dir.exists()

    def save_frozen(self, frozen: dict) -> None:
        """Write `frozen` ({module: state_dict}) unless this run has it."""
        if self.writer and not self.has_frozen():
            tmp = self._frozen_dir.with_name(f"frozen.tmp{os.getpid()}")
            _save_atomic({k: {n: t.detach().cpu() for n, t in sd.items()}
                          for k, sd in frozen.items()}, tmp / "frozen.pt")
            os.replace(tmp, self._frozen_dir)

    def restore_frozen(self) -> dict:
        return torch.load(self._frozen_dir / "frozen.pt", map_location="cpu",
                          weights_only=True)

    def maybe_save(self, state: TrainState, force: bool = False) -> bool:
        """Save if the step is on the interval; `force=True` saves regardless
        (an off-interval last step of a run would end checkpoint-less). A
        step at or before the latest saved one is never written, nor any by
        a manager that is not the writer."""
        if not self.writer:
            return False
        step = int(state.step)
        latest = self.latest_step()
        if latest is not None and latest >= step:
            return False
        if not force and step % self.cfg.every_n_steps != 0:
            return False
        cpu = lambda ts: [t.detach().cpu() for t in ts]  # noqa: E731
        opt = state.opt_state
        _save_atomic({
            "step": step,
            "params": cpu(state.params),
            "count": int(opt.count),
            "mu": cpu(opt.mu),
            "nu": cpu(opt.nu),
            "notfinite_count": int(opt.notfinite_count),
        }, self._state_dir / str(step) / "state.pt")
        for old in self.all_steps()[:-self.cfg.keep]:
            shutil.rmtree(self._state_dir / str(old))
        return True

    def restore(self, step: int, template: TrainState) -> TrainState:
        """The state saved at `step`. Its parameters are copied into
        `template.params` (the model's own tensors); the moments land on
        their devices."""
        raw = torch.load(self._state_dir / str(step) / "state.pt",
                         map_location="cpu", weights_only=True)
        if len(raw["params"]) != len(template.params):
            raise ValueError(f"checkpoint at step {step} holds {len(raw['params'])} "
                             f"parameters, the model {len(template.params)}")
        for p, saved in zip(template.params, raw["params"]):
            if p.shape != saved.shape:
                raise ValueError(f"checkpoint at step {step}: shape {tuple(saved.shape)}, "
                                 f"model {tuple(p.shape)}")
        with torch.no_grad():
            for p, saved in zip(template.params, raw["params"]):
                p.copy_(saved)
        to = lambda ts: [t.to(p.device) for t, p in zip(ts, template.params)]  # noqa: E731
        opt = OptState(raw["count"], to(raw["mu"]), to(raw["nu"]), raw["notfinite_count"])
        return TrainState(template.params, opt, raw["step"])

    def restore_latest(self, template: TrainState) -> Optional[TrainState]:
        """Latest state of this run; falls back to `cfg.load` (warm start)."""
        step = self.latest_step()
        if step is None:
            if self.cfg.load is not None:
                other = CheckpointManager(
                    dataclasses.replace(self.cfg, load=None,
                                        directory=Path(self.cfg.load))
                )
                state = other.restore_latest(template)
                if state is None:
                    raise FileNotFoundError(
                        f"checkpointing.load={self.cfg.load} has no state"
                    )
                if other.has_frozen() and not self.has_frozen():
                    # carry the source run's frozen perception weights too
                    self.save_frozen(other.restore_frozen())
                return state
            return None
        return self.restore(step, template)


def load_jax_checkpoint(directory: Path, model) -> TrainState:
    """Read the newest state of a JAX-package orbax checkpoint directory
    (`<directory>/state/<step>`, and `<directory>/frozen` where present)
    into `model` through `weights.load_jax_params`, and return the port's
    `TrainState` with the JAX run's Adam moments, counts and step.

    Needs `orbax` (imported here); without it this raises ImportError."""
    import numpy as np
    import orbax.checkpoint as ocp

    from ..weights import ENCODER_RULES, flatten, jax_leaf, load_flat, load_jax_params
    from .train import init_train_state

    directory = Path(directory).absolute()
    mgr = ocp.CheckpointManager(directory / "state")
    step = mgr.latest_step()
    if step is None:
        raise FileNotFoundError(f"no JAX checkpoint under {directory}/state")
    # restored without a template: TrainState(params, opt_state, step) as a
    # dict; opt_state = apply_if_finite(chain(clip_by_global_norm,
    # adam(schedule))) -> {"notfinite_count", ..., "inner_state": [clip,
    # [{"count", "mu", "nu"}, schedule]]}
    raw = mgr.restore(step, args=ocp.args.StandardRestore())
    adam = raw["opt_state"]["inner_state"][1][0]
    if (directory / "frozen").exists():
        frozen = ocp.StandardCheckpointer().restore(directory / "frozen")
        load_jax_params(model, raw["params"], frozen)
    else:
        load_flat(model.encoder, flatten(raw["params"]["params"]), ENCODER_RULES, "encoder")
    state = init_train_state(model)
    names = [n for n, _ in model.encoder.named_parameters()]

    def moments(tree) -> list[torch.Tensor]:
        flat = flatten(tree["params"])
        return [torch.tensor(np.array(jax_leaf(flat, n, ENCODER_RULES, "adam")[1]),
                             dtype=p.dtype, device=p.device)
                for n, p in zip(names, state.params)]

    opt = OptState(int(adam["count"]), moments(adam["mu"]), moments(adam["nu"]),
                   int(raw["opt_state"]["notfinite_count"]))
    return TrainState(state.params, opt, int(raw["step"]))
