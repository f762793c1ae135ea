"""Inputs from the seed: weights, serving scenes, training chunk files."""

import numpy as np
import torch

from pf3bench import inputs

TRAFFIC = {"views": 5, "image": [32, 32], "shift": 2, "near": 1.0, "far": 100.0,
           "intrinsics": {"fx": 0.86, "fy": 1.53, "cx": 0.5, "cy": 0.5}}
SEED = 2**31 + 12345  # past 32 signed bits: seeds of a run may be that large


def test_serve_scene_is_the_seeds():
    a = inputs.serve_scene(TRAFFIC, SEED, 3)
    b = inputs.serve_scene(TRAFFIC, SEED, 3)
    c = inputs.serve_scene(TRAFFIC, SEED, 4)
    assert a["images"].shape == (1, 5, 32, 32, 3) and a["images"].dtype == np.float32
    assert all(np.array_equal(a[k], b[k]) for k in a)
    assert not np.array_equal(a["images"], c["images"])
    # the camera pans: view i+1 is view i moved by `shift` pixels
    assert np.array_equal(a["images"][0, 1, :, :-2], a["images"][0, 0, :, 2:])
    assert a["intrinsics"][0, 0, 0, 0] == np.float32(0.86)


def test_weights_follow_the_leaf_statistics():
    lin = torch.nn.Sequential(torch.nn.Linear(64, 32), torch.nn.LayerNorm(32))
    st = inputs.leaf_statistics(lin)
    w = inputs.make_weights(st, SEED, "cpu")
    again = inputs.make_weights(st, SEED, "cpu")
    other = inputs.make_weights(st, SEED + 1, "cpu")
    assert all(torch.equal(w[k], again[k]) for k in w)
    assert not torch.equal(w["0.weight"], other["0.weight"])
    assert torch.equal(w["1.weight"], torch.ones(32))  # a constant leaf stays constant
    assert abs(float(w["0.weight"].std()) - st["0.weight"][2]) < 0.1 * st["0.weight"][2]
    inputs.load_weights(lin, w)
    assert torch.equal(lin[0].weight, w["0.weight"])


def test_chunks_are_read_by_the_ports_dataset(tmp_path):
    from pf3plat_tpu_torch.data.dataset import convert_poses, decode_images, load_chunk

    traffic = dict(TRAFFIC, chunks=1, scenes_per_chunk=2, frames=6, frame_shape=[72, 128],
                   jpeg_quality=90)
    root = inputs.write_chunks(tmp_path, traffic, SEED)
    assert inputs.write_chunks(tmp_path, traffic, SEED) == root  # reused
    chunk = load_chunk(next((root / "train").glob("*.torch")))
    assert len(chunk) == 2
    images = decode_images(chunk[0]["images"])
    assert images.shape[0] == 6 and images.shape[-3:] in ((72, 128, 3), (3, 72, 128))
    c2w, intr = convert_poses(np.asarray(chunk[0]["cameras"]))
    assert np.allclose(c2w[1, 0, 3] - c2w[0, 0, 3], 0.02)


def test_reservoir_samples_the_whole_window():
    from pf3bench.harness import Reservoir

    n, k, seeds = 40, 2, 3000
    hits = np.zeros(n)
    for seed in range(seeds):
        records = {}
        sample = Reservoir(k, seed, records)
        for i in range(n):
            if sample.take(i):
                records[i] = i
        assert len(records) == k and sorted(records) == sorted(sample.slots)
        hits[list(records)] += 1
    share = hits / seeds
    assert np.all(np.abs(share - k / n) < 0.025)  # uniform: early and late alike
