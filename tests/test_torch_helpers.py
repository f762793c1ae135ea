"""Shared helpers for the PyTorch-port parity tests (tests/test_torch_*.py).

Inputs are made with numpy from a seed and handed to both packages; the
JAX side runs on the CPU (tests/conftest.py pins it there), with its Pallas
kernels in interpret mode as the JAX suite runs them. Every port call here
passes `device="cpu"` or CPU tensors, so the port's wrappers take their
plain versions.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch


@pytest.fixture(autouse=True)
def _no_tf32():
    """Parity is taken in full float32 (TF32 off for matmuls and convs)."""
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


@pytest.fixture
def one_thread():
    """One intra-op thread for model-sized CPU work: under `pytest -n` the
    test processes share the cores, and torch's default of one thread per
    core then oversubscribes them many times over."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def t(x, dtype=None):
    """numpy / jax array -> CPU torch tensor (float64 inputs become f32)."""
    a = np.asarray(x)
    if dtype is None and a.dtype == np.float64:
        a = a.astype(np.float32)
    out = torch.from_numpy(np.ascontiguousarray(a))
    return out if dtype is None else out.to(dtype)


def n(x):
    """torch tensor / jax array -> numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def make_scene_np(rng, n=64, b=2, d_sh=25, spread=1.0):
    """Random gaussians in front of a canonical camera (numpy, float32);
    the same construction as tests/test_rasterizer.py:make_scene."""
    means = np.stack(
        [rng.uniform(-spread, spread, (b, n)), rng.uniform(-spread, spread, (b, n)),
         rng.uniform(3.0, 6.0, (b, n))], axis=-1,
    )
    scales = rng.uniform(0.02, 0.12, (b, n, 3))
    q = rng.standard_normal((b, n, 4))
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    rot = np.zeros((b, n, 3, 3))
    rot[..., 0, 0] = 1 - 2 * (y * y + z * z)
    rot[..., 0, 1] = 2 * (x * y - w * z)
    rot[..., 0, 2] = 2 * (x * z + w * y)
    rot[..., 1, 0] = 2 * (x * y + w * z)
    rot[..., 1, 1] = 1 - 2 * (x * x + z * z)
    rot[..., 1, 2] = 2 * (y * z - w * x)
    rot[..., 2, 0] = 2 * (x * z - w * y)
    rot[..., 2, 1] = 2 * (y * z + w * x)
    rot[..., 2, 2] = 1 - 2 * (x * x + y * y)
    cov = np.einsum("bnij,bnj,bnkj->bnik", rot, scales**2, rot)
    sh = rng.standard_normal((b, n, 3, d_sh)) * 0.3
    sh[..., 0] += 0.5
    opac = rng.uniform(0.3, 0.95, (b, n))
    extr = np.broadcast_to(np.eye(4), (b, 4, 4)).copy()
    intr = np.broadcast_to(
        np.array([[1.0, 0, 0.5], [0, 1.0, 0.5], [0, 0, 1.0]]), (b, 3, 3)
    ).copy()
    f32 = lambda a: np.asarray(a, np.float32)  # noqa: E731
    return dict(
        extrinsics=f32(extr), intrinsics=f32(intr), near=f32(np.full((b,), 1.0)),
        far=f32(np.full((b,), 100.0)), background=f32(np.zeros((b, 3))),
        means=f32(means), covariances=f32(cov), sh=f32(sh), opacities=f32(opac),
    )


def jax_tree_from_port(module, shapes, rules, what):
    """The JAX parameter tree (nested dicts of numpy arrays) that
    `weights.load_flat(module, flatten(tree), rules, what)` loads back into
    `module`'s present tensors: the inverse of the port's loader, for a tree
    of the layout `shapes` (e.g. a `jax.eval_shape` of the JAX module's
    init, without its "params" level). Lets a test hand the port's random
    init to the JAX package without compiling the JAX init."""
    from pf3plat_tpu_torch.weights import jax_leaf

    paths = {}

    def walk(tree, prefix, names):
        for k, v in tree.items():
            name = str(k).replace("CheckpointUNetModel", "UNetModel")
            name = f"{names}.{name}" if names else name
            if isinstance(v, dict):
                walk(v, prefix + (k,), name)
            else:
                paths[name] = (prefix + (k,), tuple(v.shape))

    walk(shapes, (), "")
    zeros = {name: np.zeros(shape, np.float32) for name, (_, shape) in paths.items()}
    out: dict = {}
    filled = set()
    # where several port tensors load from one JAX leaf (LightGlue's
    # per-layer assignment heads), the last one gives it
    for name, tensor in module.state_dict().items():
        key, _ = jax_leaf(zeros, name, rules, what)
        arr = tensor.detach().cpu().numpy()
        if key.endswith(".kernel"):
            arr = arr.T if arr.ndim == 2 else arr.transpose(2, 3, 1, 0)
        path, shape = paths[key]
        assert arr.shape == shape, (what, name, arr.shape, shape)
        node = out
        for part in path[:-1]:
            node = node.setdefault(part, {})
        node[path[-1]] = np.array(arr)
        filled.add(key)
    missing = sorted(set(paths) - filled)
    assert not missing, f"{what}: JAX leaves without a port tensor: {missing[:4]}"
    return out
