"""Encoder-internals visualization: gaussian stat maps + match overlays.

Port of `pf3plat_tpu/visualization/encoder_vis.py` (numpy renderers; the
encoder's tensors are moved to the host here).

The reference ships an `EncoderVisualizerCostVolume` whose epipolar-attention
panels are short-circuited at runtime (`encoder_visualizer_costvolume.py:42`
returns {} before any of them run — dead code inherited from pixelsplat).
The panels that are meaningful for PF3plat's pipeline are re-designed here
as host-side numpy renderers:

  * `gaussians_panel` — per-view maps of opacity, DC-color x opacity, and
    covariance determinant for the pixel-aligned gaussian field (the live
    subset of reference `visualize_gaussians`,
    `encoder_visualizer_costvolume.py:269-300`);
  * `matches_panel` — SuperPoint keypoints + LightGlue match lines per view
    pair, PF3plat's actual encoder internals (the reference inspects these
    offline; here they are a first-class validation artifact).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from .layout import apply_depth_color_map, hcat, save_image, vcat


def _normalize01(x: np.ndarray) -> np.ndarray:
    lo, hi = float(x.min()), float(x.max())
    return (x - lo) / (hi - lo + 1e-12)


def gaussians_panel(
    images: np.ndarray,      # (v, h, w, 3) context images in [0, 1]
    opacities: np.ndarray,   # (g,) pixel-aligned: g = v*h*w (any spp folds in)
    covariances: np.ndarray, # (g, 3, 3)
    colors_dc: np.ndarray,   # (g, 3) DC color component
    path: Path | None = None,
) -> np.ndarray:
    """Rows: context / opacity / color*opacity / log-det(cov). -> panel.

    The gaussian field is pixel-aligned to its SOURCE views — PF3plat
    predicts gaussians from the first & last context views only
    (`models/encoder.py`), so with a 3+-view stack g = 2*h*w while
    images carries every view; source views are inferred from g.
    """
    v, h, w, _ = images.shape
    v_src = max(1, opacities.shape[0] // (h * w))
    if v_src == 2 and v > 2:
        images = images[[0, -1]]
    else:
        images = images[:v_src]
    v = images.shape[0]
    spp = max(1, opacities.shape[0] // (v * h * w))
    fold = lambda x: x.reshape(v, h, w, spp, *x.shape[1:]).mean(axis=3)

    op = fold(opacities)[..., None]                       # (v, h, w, 1)
    col = fold(colors_dc)                                  # (v, h, w, 3)
    det = np.linalg.det(covariances.astype(np.float64))
    logdet = fold(np.log(np.maximum(det, 1e-30)).astype(np.float32))

    row_ctx = hcat(*[images[i] for i in range(v)])
    row_op = hcat(*[np.repeat(op[i], 3, axis=-1) for i in range(v)])
    row_col = hcat(*[np.clip(col[i], 0, 1) * op[i] for i in range(v)])
    ld = _normalize01(logdet)
    row_det = hcat(*[apply_depth_color_map(ld[i]) for i in range(v)])
    panel = vcat(row_ctx, row_op, row_col, row_det)
    if path is not None:
        save_image(panel, path)
    return panel


def _draw_line(img: np.ndarray, p0, p1, color) -> None:
    """Simple DDA line draw in-place; coordinates (x, y) pixels."""
    x0, y0 = float(p0[0]), float(p0[1])
    x1, y1 = float(p1[0]), float(p1[1])
    n = int(max(abs(x1 - x0), abs(y1 - y0))) + 1
    xs = np.linspace(x0, x1, n).round().astype(int)
    ys = np.linspace(y0, y1, n).round().astype(int)
    h, w = img.shape[:2]
    keep = (xs >= 0) & (xs < w) & (ys >= 0) & (ys < h)
    img[ys[keep], xs[keep]] = color


def _draw_point(img: np.ndarray, p, color, r: int = 1) -> None:
    x, y = int(round(float(p[0]))), int(round(float(p[1])))
    h, w = img.shape[:2]
    img[max(0, y - r):y + r + 1, max(0, x - r):x + r + 1] = color


def matches_panel(
    images: np.ndarray,   # (v, h, w, 3)
    kpts0: np.ndarray,    # (n_pairs, m, 2) pixel xy in view pair_i[p]
    kpts1: np.ndarray,    # (n_pairs, m, 2) pixel xy in view pair_j[p]
    scores: np.ndarray,   # (n_pairs, m)
    valid: np.ndarray,    # (n_pairs, m) bool
    pair_i: np.ndarray,
    pair_j: np.ndarray,
    max_draw: int = 100,
    path: Path | None = None,
) -> np.ndarray:
    """One row per view pair: [view_i | view_j] with match lines colored by
    score (red = weak, green = strong). Returns the stacked panel."""
    v, h, w, _ = images.shape
    rows = []
    for p in range(len(pair_i)):
        canvas = hcat(np.array(images[int(pair_i[p])]),
                      np.array(images[int(pair_j[p])]), gap=0)
        off = np.array([w, 0.0])
        idx = np.argsort(-np.where(valid[p], scores[p], -1.0))[:max_draw]
        smax = float(scores[p].max()) + 1e-12
        for m in idx:
            if not valid[p, m]:
                continue
            s = float(scores[p, m]) / smax
            color = np.array([1.0 - s, s, 0.2], np.float32)
            _draw_line(canvas, kpts0[p, m], kpts1[p, m] + off, color * 0.8)
            _draw_point(canvas, kpts0[p, m], color)
            _draw_point(canvas, kpts1[p, m] + off, color)
        rows.append(canvas)
    panel = vcat(*rows)
    if path is not None:
        save_image(panel, path)
    return panel


def encoder_internals_panels(
    images: np.ndarray,   # (v, h, w, 3)
    enc,                  # EncoderOutput (tensors on any device)
    out_dir: Path,
) -> None:
    """Save the per-validation-step encoder-internal artifacts."""
    from ..models.encoder import view_pairs

    def host(x) -> np.ndarray:
        return x.detach().cpu().numpy()

    out_dir = Path(out_dir)
    g = enc.gaussians
    gaussians_panel(
        np.asarray(images),
        host(g.opacities[0]),
        host(g.covariances[0]),
        host(g.harmonics[0][..., 0]),
        path=out_dir / "gaussians.png",
    )
    v = images.shape[0]
    pi, pj = view_pairs(v)
    corr = enc.correspondences
    matches_panel(
        np.asarray(images),
        host(corr.kpts0[0]),
        host(corr.kpts1[0]),
        host(corr.scores[0]),
        host(corr.valid[0]),
        np.asarray(pi),
        np.asarray(pj),
        path=out_dir / "matches.png",
    )
