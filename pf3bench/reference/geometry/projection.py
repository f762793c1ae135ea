"""Pinhole projection / ray geometry on torch tensors.

Port of `pf3plat_tpu/geometry/projection.py`. Conventions are the JAX package's: intrinsics normalized,
extrinsics OpenCV-style c2w, pixel coordinates normalized to (0, 1) with
half-pixel centers.
"""

from __future__ import annotations

import torch

_EPS = float(torch.finfo(torch.float32).eps)


def homogenize_points(points: torch.Tensor) -> torch.Tensor:
    return torch.cat([points, torch.ones_like(points[..., :1])], dim=-1)


def homogenize_vectors(vectors: torch.Tensor) -> torch.Tensor:
    return torch.cat([vectors, torch.zeros_like(vectors[..., :1])], dim=-1)


def transform_rigid(homogeneous: torch.Tensor, transformation: torch.Tensor) -> torch.Tensor:
    return torch.einsum("...ij,...j->...i", transformation, homogeneous)


def transform_cam2world(homogeneous: torch.Tensor, extrinsics: torch.Tensor) -> torch.Tensor:
    return transform_rigid(homogeneous, extrinsics)


def se3_inverse(m: torch.Tensor) -> torch.Tensor:
    """Closed-form inverse of a rigid 4x4 transform (R|t)."""
    r = m[..., :3, :3]
    t = m[..., :3, 3:]
    r_inv = r.transpose(-1, -2)
    t_inv = -torch.matmul(r_inv, t)
    top = torch.cat([r_inv, t_inv], dim=-1)
    bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=m.dtype, device=m.device)
    bottom = bottom.expand(top[..., :1, :].shape)
    return torch.cat([top, bottom], dim=-2)


def transform_world2cam(homogeneous: torch.Tensor, extrinsics: torch.Tensor) -> torch.Tensor:
    return transform_rigid(homogeneous, se3_inverse(extrinsics))


def intrinsics_inverse(k: torch.Tensor) -> torch.Tensor:
    """Closed-form inverse of K = [[fx, s, cx], [0, fy, cy], [0, 0, 1]]."""
    fx, s, cx = k[..., 0, 0], k[..., 0, 1], k[..., 0, 2]
    fy, cy = k[..., 1, 1], k[..., 1, 2]
    one = torch.ones_like(fx)
    zero = torch.zeros_like(fx)
    inv_fx = one / fx
    inv_fy = one / fy
    row0 = torch.stack(
        [inv_fx, -s * inv_fx * inv_fy, (s * cy - cx * fy) * inv_fx * inv_fy],
        dim=-1,
    )
    row1 = torch.stack([zero, inv_fy, -cy * inv_fy], dim=-1)
    row2 = torch.stack([zero, zero, one], dim=-1)
    return torch.stack([row0, row1, row2], dim=-2)


def project_camera_space(
    points: torch.Tensor,
    intrinsics: torch.Tensor,
    epsilon: float = _EPS,
    infinity: float = 1e8,
) -> torch.Tensor:
    """Perspective-divide then apply intrinsics. (..., 3) -> (..., 2)."""
    points = points / (points[..., -1:] + epsilon)
    points = torch.nan_to_num(points, posinf=infinity, neginf=-infinity)
    points = torch.einsum("...ij,...j->...i", intrinsics, points)
    return points[..., :-1]


def project(
    points: torch.Tensor,
    extrinsics: torch.Tensor,
    intrinsics: torch.Tensor,
    epsilon: float = _EPS,
) -> tuple[torch.Tensor, torch.Tensor]:
    """World points -> normalized pixel xy + in-front-of-camera mask."""
    points_h = homogenize_points(points)
    cam = transform_world2cam(points_h, extrinsics)[..., :-1]
    in_front = cam[..., -1] >= 0
    return project_camera_space(cam, intrinsics, epsilon=epsilon), in_front


def unproject(coordinates: torch.Tensor, z: torch.Tensor, intrinsics: torch.Tensor) -> torch.Tensor:
    """Normalized pixel xy + depth (z along the optical axis) -> camera xyz."""
    coords_h = homogenize_points(coordinates)
    directions = torch.einsum(
        "...ij,...j->...i", intrinsics_inverse(intrinsics), coords_h
    )
    return directions * z[..., None]


def get_world_rays(
    coordinates: torch.Tensor, extrinsics: torch.Tensor, intrinsics: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Normalized pixel xy -> (world ray origins, unit world directions)."""
    directions = unproject(
        coordinates, torch.ones_like(coordinates[..., 0]), intrinsics
    )
    directions = directions / torch.linalg.norm(directions, dim=-1, keepdim=True)
    directions = homogenize_vectors(directions)
    directions = transform_cam2world(directions, extrinsics)[..., :-1]
    origins = extrinsics[..., :-1, -1].expand(directions.shape)
    return origins, directions


def sample_image_grid(
    shape: tuple[int, int], dtype=torch.float32, device=None
) -> tuple[torch.Tensor, torch.Tensor]:
    """Normalized (0, 1) xy coordinates + integer ij indices of an image grid."""
    indices = [torch.arange(n, device=device) for n in shape]
    stacked = torch.stack(torch.meshgrid(*indices, indexing="ij"), dim=-1)
    coords = [(idx.to(dtype) + 0.5) / n for idx, n in zip(indices, shape)]
    coords = list(reversed(coords))
    coordinates = torch.stack(torch.meshgrid(*coords, indexing="xy"), dim=-1)
    return coordinates, stacked


def intersect_rays(
    origins_x: torch.Tensor,
    directions_x: torch.Tensor,
    origins_y: torch.Tensor,
    directions_y: torch.Tensor,
    eps: float = 1e-5,
    inf: float = 1e10,
) -> torch.Tensor:
    """Least-squares intersection point of two ray bundles; parallel pairs
    get an identity system (so the solve stays finite) and the result
    `inf`."""
    shape = torch.broadcast_shapes(
        origins_x.shape, directions_x.shape, origins_y.shape, directions_y.shape
    )
    ox, dx, oy, dy = (x.expand(shape) for x in (origins_x, directions_x, origins_y, directions_y))

    parallel = torch.einsum("...i,...i->...", dx, dy) > 1 - eps

    origins = torch.stack([ox, oy], dim=0)
    directions = torch.stack([dx, dy], dim=0)

    n = torch.einsum("r...i,r...j->r...ij", directions, directions)
    n = n - torch.eye(3, dtype=n.dtype, device=n.device)
    lhs = n.sum(dim=0)
    rhs = torch.einsum("r...ij,r...j->r...i", n, origins).sum(dim=0)

    eye = torch.eye(3, dtype=lhs.dtype, device=lhs.device)
    lhs = torch.where(parallel[..., None, None], eye, lhs)
    result = torch.linalg.solve(lhs, rhs[..., None])[..., 0]
    return torch.where(parallel[..., None], torch.full_like(result, inf), result)


def get_fov(intrinsics: torch.Tensor) -> torch.Tensor:
    """Horizontal/vertical field of view (radians) from normalized intrinsics."""
    k_inv = intrinsics_inverse(intrinsics)

    def bearing(vector):
        vec = torch.tensor(vector, dtype=intrinsics.dtype, device=intrinsics.device)
        v = torch.einsum("...ij,j->...i", k_inv, vec)
        return v / torch.linalg.norm(v, dim=-1, keepdim=True)

    left = bearing([0.0, 0.5, 1.0])
    right = bearing([1.0, 0.5, 1.0])
    top = bearing([0.5, 0.0, 1.0])
    bottom = bearing([0.5, 1.0, 1.0])
    fov_x = torch.arccos(torch.clamp((left * right).sum(-1), -1.0, 1.0))
    fov_y = torch.arccos(torch.clamp((top * bottom).sum(-1), -1.0, 1.0))
    return torch.stack([fov_x, fov_y], dim=-1)
