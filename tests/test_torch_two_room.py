"""The two-room occlusion-world tour in the port (opt-in: set
MCSLAM_SLOW_TESTS=1, as tests/test_two_room.py is; the port on the CPU at
full width takes several minutes).

tests/test_two_room.py's run on the in-repo rig at full width (the
reference's Lafida rig is absent): MultiColSLAM with loop closing on, at
SlamSettings(n_features=250, n_levels=4, fps=8.0), over 64 frames of the
two-room tour through the door wall. Its bars: WORKING on more than 90% of
the frames from the first WORKING one, at least 10 keyframes, more than
500 points, and no loop fired (noise-free tracking re-recognizes the old
landmarks through the doorway, so the loop trigger stays silent).
``chip_smoke.py`` phase 13 (a) runs the same tour on the card.
"""

import os

import numpy as np
import pytest
import torch

from multicol_slam_tpu_torch.models.system import MultiColSLAM
from multicol_slam_tpu_torch.models.tracking import TrackState
from multicol_slam_tpu_torch.utils import config_io, synthetic

pytestmark = pytest.mark.skipif(
    not os.environ.get("MCSLAM_SLOW_TESTS"),
    reason="slow integration test; set MCSLAM_SLOW_TESTS=1")


def test_two_room_tour():
    settings = config_io.SlamSettings(n_features=250, n_levels=4, fps=8.0)
    slam = MultiColSLAM(calib_dir=config_io.SYNTH_RIG_DIR, settings=settings,
                        capacity_pts=25000, capacity_kfs=96, enable_loop_closing=True,
                        device="cpu")
    render = synthetic.make_renderer(
        slam.rig, room_half=(2.2, 2.2, 3.6),
        door_wall=dict(z=0.0, door_half_x=0.8, door_half_y=1.3))
    n = 64
    gt = synthetic.two_room_loop_trajectory(n)
    states = []
    for t in range(n):
        frame = render(torch.tensor(gt[t], dtype=torch.float32)).round().to(torch.uint8)
        slam.track(frame, t / 8.0)
        states.append(slam.state)
    slam.shutdown()
    first = states.index(TrackState.WORKING)
    frac = np.mean([s == TrackState.WORKING for s in states[first:]])
    assert frac > 0.9, f"lost tracking through the door: {frac}"
    assert slam.map.n_keyframes() >= 10
    assert slam.map.n_points() > 500
    # no false loops in a drift-free world
    assert slam.loop_closer.last_loop_kf < 0
