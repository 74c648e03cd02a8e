"""The synthetic world, port against the JAX package: the two-room and
baffle tours, the baffle world's frames, and the dead reckoner.

Frames are rendered on a quarter-width copy of the in-repo rig (188x120)
and held to the JAX renderer's eager form (``jax.disable_jit()``). The
port's rays and sphere hits round differently in the last ulp: torch's
float32 sqrt on the CPU is not correctly rounded on about 0.6% of its
inputs, and XLA fuses the rays' norm and the ray-sphere dot product into
multiply-adds. So about 0.4-0.8% of the float pixels differ, most by
at most 2e-3; where a hit lies within an ulp of the step layer's
threshold the step flips and the pixel moves by up to 93. Measured over
the three worlds below: flips on 13 pixels of the plain room's frame at
gt[1] (1.9e-4 of a frame; 6.4e-5 of the batch of three), none in the
baffle worlds; the same 13 pixels and no others apart once rounded to
uint8; the rest within 1.1e-3. The
jitted form differs from the eager one on about 45% of pixels by at most
1e-3. Tests render with the port and feed the same uint8 frames to both
packages, so these pixels never part the packages' inputs.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multicol_slam_tpu.ops import rig as jrig
from multicol_slam_tpu.utils import config_io as jcio
from multicol_slam_tpu.utils import synthetic as jsyn
from multicol_slam_tpu_torch.utils import config_io as tcio
from multicol_slam_tpu_torch.utils import convert
from multicol_slam_tpu_torch.utils import synthetic as tsyn

# share of pixels whose value may flip (differ by more than FLIP), and the
# largest difference of the others (see the module docstring)
MAX_FLIP_SHARE = 3e-4
FLIP = 1e-2
MAX_ULP_DIFF = 2e-3

FIN = dict(x=0.3, z_lo=-0.5, z_hi=0.9, y_pass=0.4)
SPHERES = [dict(center=(0.5, 0.1, -1.0), velocity=(0.1, 0.0, 0.2), radius=0.3),
           dict(center=(-0.4, -0.2, -1.5), velocity=(-0.2, 0.05, 0.0), radius=0.25)]
WORLDS = {
    "plain room": {},
    "baffle, fin, place texture": dict(room_half=tsyn.BAFFLE_ROOM_HALF,
                                       door_wall=list(tsyn.BAFFLE_WALLS) + [FIN],
                                       place_texture=True),
    "baffle, distractors": dict(room_half=tsyn.BAFFLE_ROOM_HALF,
                                door_wall=list(tsyn.BAFFLE_WALLS), distractors=SPHERES),
    # tests/test_two_room.py's world: one door wall as a dict, not a list
    "two rooms": dict(room_half=(2.2, 2.2, 3.6),
                      door_wall=dict(z=0.0, door_half_x=0.8, door_half_y=1.3)),
}
# the poses each world is seen from: the two rooms from their own tour,
# before, in and after the door
POSES = {"two rooms": lambda: tsyn.two_room_loop_trajectory(64)[[10, 16, 40]]}


def _rigs():
    full = jcio.load_mcs(tcio.SYNTH_RIG_DIR, dtype=np.float32)[0]
    small = jrig.scale_rig(full, 0.25)
    return jax.tree.map(jnp.asarray, small), convert.rig_from_numpy(small)


@pytest.mark.parametrize("name", ["two_room_loop_trajectory", "two_room_revisit_trajectory",
                                  "baffle_revisit_trajectory",
                                  "baffle_revisit_trajectory_short"])
@pytest.mark.parametrize("n", [50, 112, 168])
def test_tours_are_the_same(name, n):
    np.testing.assert_array_equal(getattr(tsyn, name)(n), getattr(jsyn, name)(n))


def test_baffle_constants_are_the_same():
    assert tsyn.BAFFLE_ROOM_HALF == jsyn.BAFFLE_ROOM_HALF
    assert tsyn.BAFFLE_WALLS == jsyn.BAFFLE_WALLS


def _assert_close_frames(got, want):
    d = np.abs(got - want)
    flips = d > FLIP
    assert flips.mean() <= MAX_FLIP_SHARE, (flips.sum(), flips.size)
    assert d[~flips].max() <= MAX_ULP_DIFF
    assert (np.round(got) != np.round(want)).mean() <= MAX_FLIP_SHARE


@pytest.mark.parametrize("world", list(WORLDS))
def test_frames_match_the_eager_jax_renderer(world):
    """A batch of three poses at times 0, 0.5 and 1, and the second pose
    alone at time 0.5 against the batch's second frame: equal but for
    the last-ulp differences of the module docstring."""
    jr, tr = _rigs()
    kw = WORLDS[world]
    gt = POSES.get(world, lambda: tsyn.baffle_revisit_trajectory_short(112)[[4, 30, 56]])()
    with jax.enable_x64(False):
        render = jsyn.make_renderer(jr, **kw)
        with jax.disable_jit():
            want = np.asarray(render(jnp.asarray(gt, jnp.float32),
                                     jnp.asarray([0.0, 0.5, 1.0], jnp.float32)))
    render = tsyn.make_renderer(tr, **kw)
    got1 = render(torch.tensor(gt[1], dtype=torch.float32), 0.5).numpy()
    got3 = render(torch.tensor(gt, dtype=torch.float32), torch.tensor([0.0, 0.5, 1.0])).numpy()
    assert got1.shape == (3, 120, 188)
    assert got3.shape == want.shape == (3, 3, 120, 188)
    _assert_close_frames(got1, want[1])
    _assert_close_frames(got3, want)
    if "distractors" in kw:            # the spheres move between the times
        assert (got3[0] != render(torch.tensor(gt[0], dtype=torch.float32), 1.0).numpy()).any()


def _fake_slam():
    tracker = types.SimpleNamespace(last_reloc_frame=-1000, frame_id=0)
    return types.SimpleNamespace(tracker=tracker,
                                 loop_closer=types.SimpleNamespace(last_loop_kf=-10))


@pytest.mark.parametrize("stop", ["loop", "stop_fn"])
def test_dead_reckoner_matches_the_jax_harness(stop):
    """The port's make_dead_reckoner against the JAX package's harness
    (tests/test_organic_loop.py), both run in float64 on one sequence of
    tracked poses: anchoring, a relocalization re-base, the drift and the
    pulse, and the end of the override."""
    from test_organic_loop import make_dead_reckoner as jax_reckoner

    gt = tsyn.baffle_revisit_trajectory_short(112)
    flag = {"stop": False}
    out, fed = {}, []
    for name, make in (("jax", jax_reckoner), ("port", tsyn.make_dead_reckoner)):
        slam = _fake_slam()
        kw = dict(stop_fn=lambda: flag["stop"]) if stop == "stop_fn" else {}
        fn = make(slam, gt, 0.006, 0.004, 0.0135, (52, 67), **kw)
        flag["stop"] = False
        rng = np.random.default_rng(3)
        res = []
        for fid in range(3, 80):
            slam.tracker.frame_id = fid
            if fid == 40:
                slam.tracker.last_reloc_frame = fid
            if fid == 70:
                flag["stop"] = True
                slam.loop_closer.last_loop_kf = 5
            mt = np.concatenate([rng.normal(0, 0.05, 3), rng.normal(0, 1.0, 3)])
            fed.append(mt)
            res.append(np.asarray(fn(mt, fid), np.float64))
        out[name] = np.stack(res)
    np.testing.assert_allclose(out["port"], out["jax"], atol=1e-9, rtol=0)
    fed = np.stack(fed[-len(out["port"]):])
    replaced = np.abs(out["port"] - fed).max(1) > 0
    # anchored at frames 3 and 40 (the relocalization), replaced between,
    # handed back unchanged once the episode is over (frame 70 on)
    assert not replaced[[0, 37]].any() and replaced[1:37].all() and replaced[38:67].all()
    assert not replaced[67:].any()
