"""Trajectory export and evaluation.

Port of ``save_tum``, ``associate``, ``align_umeyama`` and ``ate_rmse`` of
``multicol_slam_tpu/utils/trajectory.py`` (cSystem::SaveMKFTrajectoryLAFIDA,
cSystem.cpp:260-290: TUM rows ``timestamp tx ty tz qx qy qz qw``).
"""

from __future__ import annotations

import numpy as np

from ..ops.se3_np import rot2quat


def save_tum(path: str, timestamps, poses) -> None:
    """poses: iterable of 4x4 body-to-world matrices."""
    with open(path, "w") as f:
        for t, M in zip(timestamps, poses):
            M = np.asarray(M)
            q = rot2quat(M[:3, :3])
            tx, ty, tz = M[:3, 3]
            f.write(f"{t:.6f} {tx:.6f} {ty:.6f} {tz:.6f} "
                    f"{q[0]:.6f} {q[1]:.6f} {q[2]:.6f} {q[3]:.6f}\n")


def align_umeyama(X: np.ndarray, Y: np.ndarray, with_scale: bool = True):
    """Similarity alignment Y ~ s R X + t (Umeyama). Returns (s, R, t)."""
    mx, my = X.mean(0), Y.mean(0)
    Xc, Yc = X - mx, Y - my
    cov = Yc.T @ Xc / len(X)
    U, D, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    var = (Xc ** 2).sum() / len(X)
    s = np.trace(np.diag(D) @ S) / var if with_scale else 1.0
    t = my - s * R @ mx
    return s, R, t


def associate(t_a: np.ndarray, t_b: np.ndarray, max_diff: float = 0.02):
    """Nearest-timestamp association (the TUM benchmark's associate
    step): index pairs (ia, ib) with |t_a - t_b| <= max_diff, each
    timestamp used at most once, greedy by closeness."""
    cands = []
    for ia, ta in enumerate(t_a):
        ib = int(np.argmin(np.abs(t_b - ta)))
        d = abs(t_b[ib] - ta)
        if d <= max_diff:
            cands.append((d, ia, ib))
    used_a, used_b, pairs = set(), set(), []
    for d, ia, ib in sorted(cands):
        if ia in used_a or ib in used_b:
            continue
        used_a.add(ia)
        used_b.add(ib)
        pairs.append((ia, ib))
    pairs.sort()
    return pairs


def ate_rmse(est_pos: np.ndarray, gt_pos: np.ndarray,
             with_scale: bool = True) -> float:
    """Absolute trajectory error RMSE after Sim3 (or SE3) alignment."""
    s, R, t = align_umeyama(est_pos, gt_pos, with_scale)
    aligned = (s * (R @ est_pos.T)).T + t
    return float(np.sqrt(((aligned - gt_pos) ** 2).sum(1).mean()))
