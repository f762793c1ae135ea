"""Evaluation harness: the reference's test protocol as a loop over requests.

Port of `pf3plat_tpu/evaluation/evaluator.py` (`ModelWrapper.test_step` /
`on_test_end`, `src/model/model_wrapper.py:243-414`):

  * target views are spliced INTO the context stack (context = (ctx_0,
    targets..., ctx_n), `model_wrapper.py:251-256`) — the pose-free model
    must localize them;
  * encoder/decoder wall-clock is benchmarked with warmup skipping, each
    request ending in a device synchronisation;
  * PSNR/SSIM/LPIPS per target view + pose errors (rotation geodesic,
    translation norm/angle) for the first->last context pair, in float32
    outside autocast;
  * scenes are bucketed by overlap: small < 0.5 <= medium <= 0.75 < large
    (`model_wrapper.py:360-369`);
  * results stream to `metrics.txt`; aggregates to `scores_all_avg.json`,
    `benchmark.json`, `peak_memory.json`.

The model (`models.pf3plat.PF3plat`, or anything called the same way)
runs on `device`, which takes the place of the JAX evaluator's `params`,
under `torch.no_grad()`; a `torch.Generator` takes the place of the JAX
key.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from ..geometry.transforms import geodesic_distance, translation_angle
from ..training.metrics import compute_psnr, compute_ssim, pose_auc
from ..utils.benchmarker import Benchmarker
from ..visualization.layout import apply_depth_color_map, hcat, save_image, save_video, vcat


@dataclasses.dataclass
class EvalCfg:
    output_path: Path = Path("outputs/test")
    eval_time_skip_steps: int = 5
    save_image: bool = True
    compute_scores: bool = True
    # Render wobble + interpolated-trajectory videos per example
    # (reference `model_wrapper.py:698-778` test-time video rendering).
    save_video: bool = False
    video_frames: int = 30
    # Depth rendering mode for the saved depth panels ("depth", "disparity",
    # "relative_disparity", "log"); None skips the depth render entirely.
    # Mirrors the reference's test-time depth splatting
    # (`model_wrapper.py:269-278`, `cuda_splatting.py:223-269`).
    depth_mode: Optional[str] = "depth"


def overlap_bucket(overlap: Optional[float]) -> str:
    if overlap is None:
        return "all"
    if overlap < 0.5:
        return "small"
    if overlap <= 0.75:
        return "medium"
    return "large"


# Trajectory frames decoded per call: fixed, the tail padded, so every
# video chunk makes the same launches.
VIDEO_CHUNK = 6


class Evaluator:
    def __init__(self, cfg: EvalCfg, model, device, lpips_apply=None):
        self.cfg = cfg
        self.model = model
        self.device = torch.device(device)
        self.lpips_apply = lpips_apply
        self.benchmarker = Benchmarker(skip_first=cfg.eval_time_skip_steps, device=self.device)
        self.records: list[dict] = []
        cfg.output_path.mkdir(parents=True, exist_ok=True)
        self._metrics_file = (cfg.output_path / "metrics.txt").open("a")

    @torch.no_grad()
    def run_example(self, example: dict, generator: Optional[torch.Generator],
                    step_idx: int) -> dict:
        """example: batched (b=1) numpy dict with spliced context==target
        stacks, ground-truth extrinsics, and optional 'overlap'."""
        ctx = example["context"]
        images, intr, near, far = (
            torch.as_tensor(np.asarray(ctx[k]), dtype=torch.float32).to(self.device)
            for k in ("image", "intrinsics", "near", "far"))

        with self.benchmarker.time("encoder_decoder"):
            enc, out = self.model(
                images, intr, near, far, 0,
                depth_mode=self.cfg.depth_mode if self.cfg.save_image else None,
                generator=generator,
            )

        record: dict = {"scene": example.get("scene", ["?"])[0]}
        tgt = slice(1, -1) if images.shape[1] > 2 else slice(None)

        if self.cfg.compute_scores:
            gt = images[:, tgt]
            pred = out.color[:, tgt]
            b, v, h, w, c = gt.shape
            gt_f = gt.reshape(b * v, h, w, c)
            pr_f = pred.reshape(b * v, h, w, c)
            record["psnr"] = float(compute_psnr(gt_f, pr_f).mean())
            record["ssim"] = float(compute_ssim(gt_f, pr_f).mean())
            if self.lpips_apply is not None:
                record["lpips"] = float(self.lpips_apply(gt_f, pr_f).mean())

            if "extrinsics" in ctx:
                gt_c2w = torch.as_tensor(np.asarray(ctx["extrinsics"]),
                                         dtype=torch.float32).to(self.device)
                pred_c2w = torch.linalg.inv(enc.refined_poses)
                rel_p = torch.matmul(torch.linalg.inv(pred_c2w[:, -1]), pred_c2w[:, 0])
                rel_g = torch.matmul(torch.linalg.inv(gt_c2w[:, -1]), gt_c2w[:, 0])
                record["rot_deg"] = float(torch.rad2deg(
                    geodesic_distance(rel_p[:, :3, :3], rel_g[:, :3, :3])).mean())
                record["trans_angle_deg"] = float(torch.rad2deg(
                    translation_angle(rel_p[:, :3, 3], rel_g[:, :3, 3])).mean())
                record["trans_norm"] = float(torch.linalg.norm(
                    rel_p[:, :3, 3] - rel_g[:, :3, 3], dim=-1).mean())

        record["bucket"] = overlap_bucket(example.get("overlap"))
        self.records.append(record)
        self._metrics_file.write(json.dumps(record) + "\n")
        self._metrics_file.flush()

        if self.cfg.save_image:
            # Per-method directory layout (matching filenames across gt/pred
            # so `metric_computer.compute_metrics` can re-score offline;
            # reference saves color/gt dirs per scene, model_wrapper.py:287-298).
            gt_views = images[0, tgt].cpu().numpy()
            pred_views = out.color[0, tgt].cpu().numpy()
            for vi in range(pred_views.shape[0]):
                stem = f"{step_idx:06}_{vi}"
                save_image(pred_views[vi], self.cfg.output_path / "images" / "pred" / f"{stem}.png")
                save_image(gt_views[vi], self.cfg.output_path / "images" / "gt" / f"{stem}.png")
            # Side-by-side panel + rendered depth of the middle target view.
            panel = vcat(hcat(*gt_views), hcat(*pred_views))
            save_image(panel, self.cfg.output_path / "compare" / f"{step_idx:06}.png")
            if out.depth is not None:
                mid = pred_views.shape[0] // 2
                d = out.depth[0, tgt][mid].cpu().numpy()
                save_image(apply_depth_color_map(d),
                           self.cfg.output_path / "depth" / f"{step_idx:06}.png")

        if self.cfg.save_video:
            self._render_videos(enc, intr, near, far, step_idx)
        return record

    def _render_videos(self, enc, intr, near, far, step_idx: int) -> None:
        """Wobble + interpolated trajectory videos through the decoder
        (reference `render_video_wobble`/`render_video_interpolation`,
        `model_wrapper.py:698-778`), in fixed chunks of VIDEO_CHUNK frames."""
        from ..models.decoder import decode
        from ..visualization.trajectories import generate_wobble, interpolate_extrinsics

        c2w = torch.linalg.inv(enc.refined_poses)[0]  # (v, 4, 4)
        t = torch.linspace(0.0, 1.0, self.cfg.video_frames, device=c2w.device)
        delta = 0.25 * torch.linalg.norm(c2w[-1, :3, 3] - c2w[0, :3, 3])
        trajs = {
            "wobble": generate_wobble(c2w[0], delta, t),
            "interpolation": interpolate_extrinsics(c2w[0], c2w[-1], t),
        }
        f = VIDEO_CHUNK
        shape = tuple(enc.depths.shape[2:4])
        intr_f = intr[:, :1].expand(1, f, 3, 3)
        near_f = near[:, :1].expand(1, f)
        far_f = far[:, :1].expand(1, f)
        for name, traj in trajs.items():
            pad = (-traj.shape[0]) % f
            if pad:
                traj = torch.cat([traj, traj[-1:].expand(pad, 4, 4)], 0)
            frames = []
            for s in range(0, traj.shape[0], f):
                color = decode(self.model.cfg.decoder, enc.gaussians, traj[s:s + f][None],
                               intr_f, near_f, far_f, shape).color
                frames += list(color[0].cpu().numpy())
            save_video(
                frames[: self.cfg.video_frames],
                self.cfg.output_path / "video" / f"{step_idx:06}_{name}.mp4",
            )

    def finalize(self) -> dict:
        buckets: dict[str, list[dict]] = {}
        for r in self.records:
            if r["bucket"] != "all":
                buckets.setdefault(r["bucket"], []).append(r)
            buckets.setdefault("all", []).append(r)
        summary = {}
        for bucket, rs in buckets.items():
            agg = {}
            for key in ("psnr", "ssim", "lpips", "rot_deg", "trans_angle_deg",
                        "trans_norm"):
                vals = [r[key] for r in rs if key in r]
                if vals:
                    agg[key] = float(np.mean(vals))
                    if key == "rot_deg":
                        agg["rot_deg_median"] = float(np.median(vals))
            pose_errs = [
                max(r["rot_deg"], r["trans_angle_deg"])
                for r in rs
                if "rot_deg" in r and "trans_angle_deg" in r
            ]
            if pose_errs:
                agg.update(pose_auc(pose_errs))
            agg["count"] = len(rs)
            summary[bucket] = agg
        (self.cfg.output_path / "scores_all_avg.json").write_text(
            json.dumps(summary, indent=2)
        )
        self.benchmarker.dump(self.cfg.output_path / "benchmark.json")
        self.benchmarker.dump_memory(self.cfg.output_path / "peak_memory.json")
        self._metrics_file.close()
        return summary
