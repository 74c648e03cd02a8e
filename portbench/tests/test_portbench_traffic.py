"""The laps mix: lap k is lap 0, pose for pose and frame for frame; the
cells' mixes run the same frames on every seed."""

import numpy as np
import pytest
import torch

from portbench import spec, world
from portbench.traffic import laps

SMALL = dict(opening_frames=3, lap_frames=6)


@pytest.fixture(scope="module")
def rig():
    bench = spec.Benchmark(spec.HERE + "/..")
    return world.Rig(bench.config("lafida3_orb").dir, "cpu")


@pytest.mark.parametrize("mix", ["laps_batch", "laps_live"])
def test_lap_k_is_lap_0(mix):
    m = spec.traffic(mix)
    poses = laps.route(m)
    n_open, n_lap = m["opening_frames"], m["lap_frames"]
    assert poses.shape == (n_open + n_lap, 4, 4)
    # the lap closes on the opening's last pose
    np.testing.assert_allclose(poses[-1], poses[n_open - 1], atol=1e-12)
    steps = np.linalg.norm(np.diff(poses[n_open:, :3, 3], axis=0), axis=1)
    np.testing.assert_allclose(steps, 2 * np.pi * m["radius"] / n_lap * np.sinc(1 / n_lap),
                               rtol=1e-9)


def test_stream_repeats_the_lap(rig):
    m = dict(spec.traffic("laps_batch"), **SMALL)
    tr = laps.make(m, 2**31 + 11, rig)
    g = np.arange(0, 3 + 6 * 5)
    idx = tr.index(g)
    assert idx.tolist()[:9] == list(range(9))
    for k in range(1, 5):
        for i in range(6):
            a, b = 3 + i, 3 + 6 * k + i
            assert idx[b] == idx[a]
            np.testing.assert_array_equal(tr.pose(b), tr.pose(a))
    images, ts = tr.call(7, 5)
    assert torch.equal(images[2], tr.frames[tr.index(9)])
    np.testing.assert_allclose(ts, np.arange(7, 12) / m["fps"])


def test_the_mixes_run_the_same_frames_on_every_seed(rig):
    """The laps take nothing from the seed; the window begins at a lap's
    first frame; the texture lattice is the mix's."""
    m = dict(spec.traffic("laps_live"), **SMALL)
    a, c = (laps.make(m, s, rig) for s in (5, 2**31 + 6))
    assert torch.equal(a.frames, c.frames)
    np.testing.assert_array_equal(a.poses, c.poses)
    assert a.setup_frames == m["opening_frames"] + m["setup_laps"] * m["lap_frames"]
    assert a.frames.dtype == torch.uint8 and a.frames.shape[1:] == (3, 480, 754)
    d = laps.make(dict(m, texture_seed=8), 5, rig)
    assert not torch.equal(d.frames, a.frames)


def test_the_ports_room():
    """Texture seed 7 is the port's own lattice (``synthetic._lattice``)."""
    from multicol_slam_tpu_torch.utils import synthetic
    assert np.array_equal(world.lattice(7, "cpu").numpy(), synthetic._lattice(7))


def test_surface_distance():
    X = np.array([[3.9, 0, 0], [0, -4.05, 0], [0, 0, 0], [4.0, 4.0, 0]])
    np.testing.assert_allclose(world.surface_distance(X), [0.1, 0.05, 4.0, 0.0], atol=1e-12)
