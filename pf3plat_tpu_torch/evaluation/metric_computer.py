"""Offline metric computation over saved renders from multiple methods.

Port of `pf3plat_tpu/evaluation/metric_computer.py` (the reference's
`MetricComputer`, `src/evaluation/metric_computer.py:15`, and
`src/scripts/compute_metrics.py`): given directories of rendered images
(one per method) plus ground-truth images with matching filenames,
recompute PSNR/SSIM/LPIPS per method and aggregate. Runs on the card
unless the caller passes `device="cpu"`; the CLI sets the declared
precision policy (`precision.apply_policy`).
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import torch

from ..device import resolve_device
from ..precision import apply_policy
from ..training.metrics import compute_psnr, compute_ssim


def _load_dir(path: Path) -> dict[str, np.ndarray]:
    from PIL import Image

    out = {}
    for p in sorted(Path(path).glob("*.png")):
        out[p.stem] = np.asarray(Image.open(p), np.float32)[..., :3] / 255.0
    return out


def compute_metrics(
    ground_truth_dir: Path,
    method_dirs: dict[str, Path],
    output_path: Path | None = None,
    lpips_apply=None,
    device=None,
) -> dict:
    dev = resolve_device(device)
    gt = _load_dir(ground_truth_dir)
    results: dict[str, dict] = {}
    for method, mdir in method_dirs.items():
        preds = _load_dir(mdir)
        keys = sorted(set(gt) & set(preds))
        if not keys:
            results[method] = {"count": 0}
            continue
        psnrs, ssims, lpipss = [], [], []
        with torch.no_grad():
            for k in keys:
                g = torch.from_numpy(gt[k]).to(dev)[None]
                p = torch.from_numpy(preds[k]).to(dev)[None]
                psnrs.append(float(compute_psnr(g, p)[0]))
                ssims.append(float(compute_ssim(g, p)[0]))
                if lpips_apply is not None:
                    lpipss.append(float(lpips_apply(g, p)[0]))
        results[method] = {
            "psnr": float(np.mean(psnrs)),
            "ssim": float(np.mean(ssims)),
            **({"lpips": float(np.mean(lpipss))} if lpipss else {}),
            "count": len(keys),
        }
    if output_path is not None:
        Path(output_path).parent.mkdir(exist_ok=True, parents=True)
        Path(output_path).write_text(json.dumps(results, indent=2))
    return results


def main(argv=None, device=None) -> None:
    """CLI (reference `src/scripts/compute_metrics.py` equivalent):

    python -m pf3plat_tpu_torch.evaluation.metric_computer GT_DIR \\
        name1=dir1 [name2=dir2 ...] [--out metrics.json]
    """
    import sys

    argv = list(sys.argv[1:] if argv is None else argv)
    out = None
    if "--out" in argv:
        i = argv.index("--out")
        out = Path(argv[i + 1])
        del argv[i:i + 2]
    if len(argv) < 2:
        raise SystemExit(main.__doc__)
    gt = Path(argv[0])
    methods = dict(a.split("=", 1) for a in argv[1:])
    apply_policy(resolve_device(device))
    results = compute_metrics(
        gt, {k: Path(v) for k, v in methods.items()}, output_path=out, device=device
    )
    print(json.dumps(results, indent=2))


if __name__ == "__main__":
    main()
