"""Headless visualization: the cViewer / cMapPublisher /
cMultiFramePublisher equivalents.

Port of ``multicol_slam_tpu/utils/viz.py``. The reference draws a live
Pangolin window (map points, keyframe frusta for every rig camera, the
covisibility graph, the current pose; cMapPublisher.h:50-61) and a
keypoint mosaic per camera (cMultiFramePublisher.h:44-55). Here the same
content is drawn to PNG files with matplotlib, imported when a drawing is
made; without matplotlib a drawing raises and says so.
"""

from __future__ import annotations

import os
import threading
import traceback
from typing import Optional

import numpy as np

from ..ops import se3_np


def have_matplotlib() -> bool:
    try:
        import matplotlib  # noqa: F401
    except ImportError:
        return False
    return True


def _require_plt():
    try:
        import matplotlib
    except ImportError as exc:
        raise RuntimeError("drawing needs matplotlib, which is not installed") from exc
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


def map_view(map_store, draw_covisibility: bool = True) -> dict:
    """A copy of what ``draw_map`` draws: the valid points (n, 3), the
    keyframe poses {kf: (4, 4)} and the covisibility edges of weight >= 30
    as (kf, other) pairs. The arrays are read once each, so a pool that
    grows meanwhile tears no read."""
    valid, pos = map_store.pt_valid, map_store.pt_pos
    n = min(len(valid), len(pos))
    kf_valid, kf_pose = map_store.kf_valid, map_store.kf_pose
    kfs = np.nonzero(kf_valid[:len(kf_pose)])[0]
    poses = {int(kf): se3_np.cayley2hom(kf_pose[kf]) for kf in kfs}
    edges = []
    if draw_covisibility and len(poses) > 1:
        for kf in poses:
            for other, w in map_store.covisibility_weights(kf).items():
                if w >= 30 and other > kf and other in poses:
                    edges.append((kf, other))
    return dict(points=pos[:n][valid[:n]].copy(), poses=poses, edges=edges)


def _rig_extrinsics(rig) -> np.ndarray:
    """(C, 4, 4) camera-to-body matrices on the host."""
    return rig.M_c.detach().cpu().numpy().astype(np.float64)


def _draw_map(view: dict, M_c: np.ndarray, current_pose, trajectory, path: str) -> str:
    plt = _require_plt()
    fig, ax = plt.subplots(figsize=(9, 9))
    pts = view["points"]
    if len(pts):
        ax.scatter(pts[:, 0], pts[:, 2], s=1, c="#333333", alpha=0.5,
                   label=f"{len(pts)} map points")
    for M in view["poses"].values():
        # the rig's frusta: a short axis line per camera
        for Mc_c in M_c:
            Mc = M @ Mc_c
            o = Mc[:3, 3]
            d = Mc[:3, :3] @ np.array([0, 0, 0.12])
            ax.plot([o[0], o[0] + d[0]], [o[2], o[2] + d[2]], c="tab:blue", lw=0.8)
        ax.scatter([M[0, 3]], [M[2, 3]], s=14, c="tab:blue")
    for a, b in view["edges"]:
        pa, pb = view["poses"][a][:3, 3], view["poses"][b][:3, 3]
        ax.plot([pa[0], pb[0]], [pa[2], pb[2]], c="tab:green", lw=0.5, alpha=0.5)
    if trajectory:
        tr = np.stack([M[:3, 3] for M in trajectory])
        ax.plot(tr[:, 0], tr[:, 2], c="tab:red", lw=1.2, label="trajectory")
    if current_pose is not None:
        ax.scatter([current_pose[0, 3]], [current_pose[2, 3]], s=60, c="tab:red",
                   marker="*", label="current")
    ax.set_xlabel("x [m]")
    ax.set_ylabel("z [m]")
    ax.set_aspect("equal")
    if ax.get_legend_handles_labels()[0]:
        ax.legend(loc="upper right", fontsize=8)
    fig.tight_layout()
    fig.savefig(path, dpi=110)
    plt.close(fig)
    return path


def draw_map(map_store, rig, current_pose: Optional[np.ndarray] = None,
             trajectory: Optional[list] = None, path: str = "map.png",
             draw_covisibility: bool = True) -> str:
    """Top-down (x-z) render of the map: points, the keyframes' rig
    frusta, the covisibility graph, the trajectory and the current pose."""
    return _draw_map(map_view(map_store, draw_covisibility), _rig_extrinsics(rig),
                     current_pose, trajectory, path)


def draw_frame_mosaic(images, feats, frame_pt=None, path: str = "frame.png",
                      state_text: str = "") -> str:
    """Keypoint mosaic, one panel per camera (cMultiFramePublisher):
    keypoints with a landmark green, the others blue. ``images`` (C, H, W)
    and ``feats`` may be tensors on any device or numpy."""
    plt = _require_plt()
    images = _host(images)
    xy, valid = _host(feats.xy), _host(feats.valid)
    C = images.shape[0]
    fig, axes = plt.subplots(1, C, figsize=(5 * C, 4))
    if C == 1:
        axes = [axes]
    for c in range(C):
        ax = axes[c]
        ax.imshow(images[c], cmap="gray", vmin=0, vmax=255)
        v = valid[c]
        if frame_pt is not None:
            tracked = v & (frame_pt[c] >= 0)
            ax.scatter(xy[c, tracked, 0], xy[c, tracked, 1], s=6,
                       facecolors="none", edgecolors="lime", lw=0.8)
            un = v & ~tracked
        else:
            un = v
        ax.scatter(xy[c, un, 0], xy[c, un, 1], s=4, facecolors="none",
                   edgecolors="deepskyblue", lw=0.5)
        ax.set_title(f"cam {c}")
        ax.axis("off")
    if state_text:
        fig.suptitle(state_text)
    fig.tight_layout()
    fig.savefig(path, dpi=100)
    plt.close(fig)
    return path


def _host(a) -> np.ndarray:
    """A copy of a tensor or array on the host."""
    if hasattr(a, "detach"):
        return a.detach().cpu().numpy()
    return np.array(a)


class Viewer:
    """The live viewer loop, cViewer::Run (cViewer.cpp:72-144): where the
    reference redraws a Pangolin window until RequestFinish, this thread
    redraws ``live_map.png`` and ``live_frame.png`` in ``out_dir`` every
    ``period_s``, each swapped in whole.

    A refresh first copies what it draws (the map's arrays, the trajectory,
    the system's last-frame snapshot), so the tracker is never blocked and
    the drawing never reads state the tracker or the mapper is changing
    (the reference takes mMutexCamera and the map's mutex for the same,
    cViewer.cpp:84-120). A refresh that fails is counted in ``n_failures``
    and its traceback printed; the loop goes on."""

    def __init__(self, slam, out_dir: str = ".", period_s: float = 1.0):
        self.slam = slam
        self.out_dir = out_dir
        self.period_s = period_s
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, name="multicol-viewer",
                                        daemon=True)
        self.n_refreshes = 0
        self.n_failures = 0
        slam.keep_last_frame = True     # the system keeps the last frame for us

    def start(self) -> "Viewer":
        self._thread.start()
        return self

    def stop(self):
        """cViewer::RequestFinish, then join."""
        self._stop.set()
        if self._thread.is_alive():
            self._thread.join(timeout=30)

    def _run(self):
        os.makedirs(self.out_dir, exist_ok=True)
        while not self._stop.wait(self.period_s):
            self.refresh()

    def _atomic(self, draw_fn, name: str):
        tmp = os.path.join(self.out_dir, "." + name + ".tmp.png")
        draw_fn(tmp)
        os.replace(tmp, os.path.join(self.out_dir, name))

    def refresh(self) -> bool:
        """One redraw of both publishers; returns whether it succeeded."""
        slam = self.slam
        try:
            view = map_view(slam.map)
            trajectory = list(slam.tracker.all_poses)
            M_c = _rig_extrinsics(slam.rig)
            snap = slam.last_frame
            if snap is not None:
                images, feats, frame_pt, state = snap
                images = _host(images)
                feats = type(feats)(*(_host(t) for t in feats))
            pose = trajectory[-1] if trajectory else None
            self._atomic(lambda p: _draw_map(view, M_c, pose, trajectory, p), "live_map.png")
            if snap is not None:
                self._atomic(lambda p: draw_frame_mosaic(images, feats, frame_pt, path=p,
                                                         state_text=state),
                             "live_frame.png")
        except Exception:     # a failed redraw must not end the viewer loop
            traceback.print_exc()
            self.n_failures += 1
            return False
        self.n_refreshes += 1
        return True
