"""Generator kind ``laps``: the rig driven round one closed route again
and again, fed to the system in a closed loop.

The route: ``opening_frames`` of lateral motion at ``opening_step`` m a
frame with no rotation (the bootstrap's parallax), then a circle of
``radius`` m in ``lap_frames`` frames whose yaw follows the tangent, so
that lap k's frame i is lap 0's frame i. Frame g of the stream is
distinct frame ``index(g)``, at time g / fps.

Set-up tracks the opening and ``setup_laps`` laps, so the window begins
at the lap's first frame. The room's texture lattice comes from
``texture_seed``. The run's seed does not change the frames: every seed
runs the same work.

The window then feeds the stream on, ``frames_per_call`` frames a call
through ``api`` (``track_batch`` with ``chunk``, or ``track`` frame by
frame), the next call when the last returns. The traced run profiles
``trace_laps`` laps from the window's first frame.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import world


def _yaw(a: float) -> np.ndarray:
    c, s = np.cos(a), np.sin(a)
    return np.array([[c, 0.0, s], [0.0, 1.0, 0.0], [-s, 0.0, c]])


def route(mix: dict) -> np.ndarray:
    """(opening_frames + lap_frames, 4, 4) body-to-world poses of the
    distinct frames: the opening, then one lap."""
    n_open, step = int(mix["opening_frames"]), float(mix["opening_step"])
    n_lap, r = int(mix["lap_frames"]), float(mix["radius"])
    poses = []
    for i in range(n_open):
        M = np.eye(4)
        M[:3, 3] = [step * i, 0.004 * i, 0.002 * i]
        poses.append(M)
    end = poses[-1]
    for i in range(1, n_lap + 1):
        th = 2.0 * np.pi * i / n_lap
        M = np.eye(4)
        M[:3, :3] = _yaw(th)
        M[:3, 3] = end[:3, 3] + np.array([r * np.sin(th), 0.0, r * (np.cos(th) - 1.0)])
        poses.append(M)
    return np.stack(poses)


class Traffic:
    """The distinct frames on the device, their poses, and the stream's
    schedule."""

    def __init__(self, mix: dict, rig: "world.Rig", render_chunk: int = 24):
        self.mix = mix
        self.api = mix["api"]
        self.chunk = int(mix.get("chunk", 8))
        self.per_call = int(mix["frames_per_call"])
        self.fps = float(mix["fps"])
        self.n_open, self.n_lap = int(mix["opening_frames"]), int(mix["lap_frames"])
        self.setup_frames = self.n_open + int(mix["setup_laps"]) * self.n_lap
        self.trace_frames = int(mix["trace_laps"]) * self.n_lap
        self.poses = route(mix)
        dev = rig.M_c.device
        render = world.make_renderer(rig, world.lattice(int(mix["texture_seed"]), dev))
        M = torch.tensor(self.poses, dtype=torch.float32, device=dev)
        self.frames = torch.cat([
            torch.round(render(M[s:s + render_chunk])).to(torch.uint8)
            for s in range(0, len(self.poses), render_chunk)])

    def index(self, g) -> np.ndarray:
        """The distinct frame of stream frames g."""
        g = np.asarray(g, np.int64)
        return np.where(g < self.n_open, g, self.n_open + (g - self.n_open) % self.n_lap)

    def pose(self, g) -> np.ndarray:
        return self.poses[self.index(g)]

    def call(self, g0: int, n: int):
        """Stream frames [g0, g0 + n): (images (n, C, H, W), timestamps)."""
        g = np.arange(g0, g0 + n)
        idx = torch.as_tensor(self.index(g), device=self.frames.device)
        return self.frames.index_select(0, idx), [float(x) / self.fps for x in g]

def make(mix: dict, seed: int, rig) -> Traffic:
    """The generator kind's entry; the laps take nothing from ``seed``."""
    return Traffic(mix, rig)
