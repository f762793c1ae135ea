"""A synthetic scene for the encoder's pose path, in numpy only.

Shared by tests/test_torch_pose_path.py (the port against the JAX package on
the CPU) and chip_smoke.py's phase `pose_path` (the card against the port on
the CPU), which imports this file from the checkout. It imports numpy (and
torch inside `live_pose_head`) and nothing of JAX.

The surface is the boundary of a convex "roof" in front of the cameras: the
intersection of the half-spaces z >= z0 + sx |x - xc| (two slanted planes
meeting in a ridge) and z >= z0 + sy (y - yc), so it is not planar. Each
camera both rotates (a few degrees of yaw and pitch a view) and translates
(a baseline of ~0.15 of the depth a view, plus a little height and depth).
World coordinates are camera 0's, so camera 0's c2w is the identity and the
encoder's synchronised poses (view 0 -> view k) are the true w2c matrices.

Every pixel's depth is analytic: the ray of a pixel centre enters the convex
set at the largest of the entry times of its half-spaces. Correspondences
are exact: a keypoint of view i is a pixel centre, its 3D point is that
pixel's surface point, and its match in view j is that point's projection
(the encoder reads the pixel the match falls in, so view j's lookup carries
up to half a pixel of quantisation, as with any matcher's output).
"""

from __future__ import annotations

import numpy as np

# normalized pinhole intrinsics of every view (the tests' and the training
# batch's of record)
INTRINSICS = np.array([[1.0, 0.0, 0.5], [0.0, 1.0, 0.5], [0.0, 0.0, 1.0]])
DEPTH0 = 4.0      # the ridge's distance from camera 0
SLOPE_X = 0.35    # the two roof planes' slopes along x
SLOPE_Y = 0.2     # the third plane's slope along y
SCORE = 0.9       # every match's score


def view_pairs(v: int) -> list[tuple[int, int]]:
    """All (i, j), i < j, in the encoder's order."""
    return [(i, j) for i in range(v) for j in range(i + 1, v)]


def _rot(yaw: float, pitch: float, roll: float) -> np.ndarray:
    """Rotation about y (yaw), then x (pitch), then z (roll), radians."""
    cy, sy, cp, sp, cr, sr = (f(a) for a in (yaw, pitch, roll) for f in (np.cos, np.sin))
    ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
    rx = np.array([[1, 0, 0], [0, cp, -sp], [0, sp, cp]])
    rz = np.array([[cr, -sr, 0], [sr, cr, 0], [0, 0, 1]])
    return ry @ rx @ rz


def camera_poses(rng, b: int, v: int, yaw_deg: float = 3.0, pitch_deg: float = 2.0,
                 baseline: float = 0.15) -> np.ndarray:
    """(b, v, 4, 4) c2w in camera 0's frame: view k moves `baseline` x the
    depth a view along x (with a little y and z), turns ~`yaw_deg` back
    towards the ridge and ~`pitch_deg` up or down, each row's steps drawn
    from `rng`."""
    c2w = np.zeros((b, v, 4, 4))
    for bi in range(b):
        raw = []
        for k in range(v):
            jitter = rng.uniform(0.7, 1.3, 3)
            centre = np.array([baseline * DEPTH0 * k * jitter[0],
                               0.05 * DEPTH0 * k * rng.uniform(-1, 1),
                               0.05 * DEPTH0 * k * rng.uniform(-1, 1)])
            r = _rot(np.deg2rad(-yaw_deg * k * jitter[1]),
                     np.deg2rad(pitch_deg * k * jitter[2] * (-1) ** bi),
                     np.deg2rad(0.5 * k * rng.uniform(-1, 1)))
            m = np.eye(4)
            m[:3, :3], m[:3, 3] = r, centre
            raw.append(m)
        inv0 = np.linalg.inv(raw[0])
        for k in range(v):
            c2w[bi, k] = inv0 @ raw[k]
    return c2w


def _half_spaces(xc: float, yc: float):
    """(normals (3, 3), offsets (3,)): the set n . p >= c for every row."""
    normals = np.array([[-SLOPE_X, 0.0, 1.0], [SLOPE_X, 0.0, 1.0], [0.0, -SLOPE_Y, 1.0]])
    offsets = np.array([DEPTH0 - SLOPE_X * xc, DEPTH0 + SLOPE_X * xc, DEPTH0 - SLOPE_Y * yc])
    return normals, offsets


def ray_depth(c2w: np.ndarray, uv: np.ndarray, ridge: tuple[float, float]) -> np.ndarray:
    """z-depth in the camera `c2w` (4, 4) of the surface seen through the
    normalized image points `uv` (..., 2)."""
    d_cam = np.concatenate([uv, np.ones_like(uv[..., :1])], -1) @ np.linalg.inv(INTRINSICS).T
    d_world = d_cam @ c2w[:3, :3].T
    normals, offsets = _half_spaces(*ridge)
    nd = d_world @ normals.T                     # (..., 3)
    if not (nd > 0).all():
        raise ValueError("a ray runs parallel to or away from a roof plane")
    entry = (offsets - normals @ c2w[:3, 3]) / nd  # z_cam = 1 along d_cam
    return entry.max(-1)


def _project(c2w: np.ndarray, points: np.ndarray) -> np.ndarray:
    """World points (..., 3) -> normalized image points (..., 2)."""
    w2c = np.linalg.inv(c2w)
    cam = points @ w2c[:3, :3].T + w2c[:3, 3]
    img = cam @ INTRINSICS.T
    return img[..., :2] / img[..., 2:]


def _texture(points: np.ndarray) -> np.ndarray:
    """A smooth colour pattern fixed to the surface: (..., 3) in [0.1, 0.9]."""
    x, y, z = points[..., 0], points[..., 1], points[..., 2]
    return 0.5 + 0.4 * np.stack([np.sin(5 * x + 2 * z), np.cos(4 * y - 3 * x),
                                 np.sin(3 * x * y + z)], -1)


def gumbel(rng, shape) -> np.ndarray:
    """Standard Gumbel draws in float32, -log(-log(u)), u uniform in (0, 1):
    the RANSAC noise that the card, the port on the CPU (and, through the
    same array, any other caller) share."""
    u = rng.uniform(np.finfo(np.float32).tiny, 1.0 - 2.0**-24, shape)
    return (-np.log(-np.log(u))).astype(np.float32)


def pose_scene(b: int, v: int, h: int, w: int, m: int, seed: int = 0,
               feature_shape: tuple[int, int, int] | None = None,
               ransac_samples: int | None = None, **camera) -> dict:
    """The scene seen by `v` views of `h` x `w` pixels in `b` batch rows,
    with `m` exact matches in each of the v (v - 1) / 2 pairs.

    Returns numpy float32 arrays (bool for `valid`): images (b, v, h, w, 3),
    intrinsics (b, v, 3, 3), near (b, v), far (b, v), depth (b, v, h, w),
    c2w (b, v, 4, 4), rel (b, P, 4, 4) the true cam_i -> cam_j transforms
    of the pairs, kpts0 / kpts1 (b, P, m, 2) in pixels, scores (b, P, m),
    valid (b, P, m); with `feature_shape` (hd, wd, cd) also features (b, v,
    hd, wd, cd), standard normal; with `ransac_samples` also ransac_noise
    (b, P, ransac_samples, m), Gumbel draws. `camera` goes to
    `camera_poses`."""
    rng = np.random.default_rng(seed)
    c2w = camera_poses(rng, b, v, **camera)
    ridge = (0.5 * c2w[0, -1, 0, 3], 0.0)
    jj, ii = np.meshgrid(np.arange(w), np.arange(h))
    uv = np.stack([(jj + 0.5) / w, (ii + 0.5) / h], -1)  # (h, w, 2) pixel centres
    rays = np.concatenate([uv, np.ones_like(uv[..., :1])], -1) @ np.linalg.inv(INTRINSICS).T
    depth = np.zeros((b, v, h, w))
    images = np.zeros((b, v, h, w, 3))
    for bi in range(b):
        for k in range(v):
            depth[bi, k] = ray_depth(c2w[bi, k], uv, ridge)
            pts = (rays * depth[bi, k][..., None]) @ c2w[bi, k, :3, :3].T + c2w[bi, k, :3, 3]
            images[bi, k] = _texture(pts)

    pairs = view_pairs(v)
    kpts0 = np.zeros((b, len(pairs), m, 2))
    kpts1 = np.zeros_like(kpts0)
    rel = np.zeros((b, len(pairs), 4, 4))
    margin = 2
    for bi in range(b):
        for p, (i, j) in enumerate(pairs):
            rel[bi, p] = np.linalg.inv(c2w[bi, j]) @ c2w[bi, i]
            # distinct pixels of view i whose surface point lands inside
            # view j with a margin
            flat = rng.permutation(h * w)
            yi, xi = flat // w, flat % w
            pts = ((rays[yi, xi] * depth[bi, i, yi, xi][:, None]) @ c2w[bi, i, :3, :3].T
                   + c2w[bi, i, :3, 3])
            uv_j = _project(c2w[bi, j], pts) * np.array([w, h])
            inside = ((uv_j[:, 0] >= margin) & (uv_j[:, 0] < w - margin)
                      & (uv_j[:, 1] >= margin) & (uv_j[:, 1] < h - margin))
            keep = np.flatnonzero(inside)[:m]
            if keep.size < m:
                raise ValueError(f"pair {(i, j)} shares {keep.size} < {m} points")
            kpts0[bi, p] = np.stack([xi[keep] + 0.5, yi[keep] + 0.5], -1)
            kpts1[bi, p] = uv_j[keep]

    f32 = lambda a: np.asarray(a, np.float32)  # noqa: E731
    out = dict(
        images=f32(images), intrinsics=f32(np.broadcast_to(INTRINSICS, (b, v, 3, 3))),
        near=f32(np.ones((b, v))), far=f32(np.full((b, v), 100.0)), depth=f32(depth),
        c2w=f32(c2w), rel=f32(rel), kpts0=f32(kpts0), kpts1=f32(kpts1),
        scores=f32(np.full((b, len(pairs), m), SCORE)),
        valid=np.ones((b, len(pairs), m), bool),
    )
    if feature_shape is not None:
        out["features"] = f32(rng.standard_normal((b, v, *feature_shape)))
    if ransac_samples is not None:
        out["ransac_noise"] = gumbel(rng, (b, len(pairs), ransac_samples, m))
    return out


def rotation_deg(r_pred: np.ndarray, r_true: np.ndarray) -> np.ndarray:
    """Angle in degrees between (..., 3, 3) rotations, from their chordal
    distance |R1 - R2|_F = 2 sqrt(2) sin(angle / 2): well conditioned at
    small angles, where the arccos of the trace turns float32 rounding of
    the matrices into hundredths of a degree."""
    chord = np.linalg.norm(np.asarray(r_pred, np.float64) - r_true, axis=(-2, -1))
    return np.rad2deg(2.0 * np.arcsin(np.minimum(chord / (2.0 * np.sqrt(2.0)), 1.0)))


def direction_deg(t_pred: np.ndarray, t_true: np.ndarray) -> np.ndarray:
    """Angle in degrees between (..., 3) translation directions, as
    atan2(|a x b|, a . b) (well conditioned at small angles)."""
    a, c = np.asarray(t_pred, np.float64), np.asarray(t_true, np.float64)
    cross = np.linalg.norm(np.cross(a, c), axis=-1)
    return np.rad2deg(np.arctan2(cross, (a * c).sum(-1)))


def pose_errors(poses: np.ndarray, truth: np.ndarray) -> dict:
    """Rotation and translation-direction errors in degrees of (..., 4, 4)
    transforms against the truth: each one's largest and mean. Identity
    truths (view 0 of a synchronised stack) are left out."""
    poses, truth = np.asarray(poses, np.float64), np.asarray(truth, np.float64)
    moving = np.linalg.norm(truth[..., :3, 3], axis=-1) > 1e-9
    rot = rotation_deg(poses[..., :3, :3], truth[..., :3, :3])[moving]
    trans = direction_deg(poses[..., :3, 3], truth[..., :3, 3])[moving]
    return dict(rot_deg_max=float(rot.max()), rot_deg_mean=float(rot.mean()),
                trans_deg_max=float(trans.max()), trans_deg_mean=float(trans.mean()))


def live_pose_head(encoder, seed: int = 0, std: float = 1e-2) -> None:
    """Random weights (normal, `std`, from torch seed `seed` on the CPU) in
    the encoder's zero-initialised pose head (`pose_branch.Dense_1`), so the
    refinement transformer moves the refined poses off the synchronised
    ones. `encoder` is the port's `PoseFreeEncoder`, on any device."""
    import torch

    gen = torch.Generator().manual_seed(seed)
    dense = encoder.pose_branch.Dense_1
    with torch.no_grad():
        for x in (dense.weight, dense.bias):
            x.copy_(torch.randn(x.shape, generator=gen) * std)
