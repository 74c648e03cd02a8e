"""Trajectory export and evaluation.

Port of ``multicol_slam_tpu/utils/trajectory.py`` (cSystem::
SaveMKFTrajectoryLAFIDA, cSystem.cpp:260-290: TUM rows ``timestamp tx ty
tz qx qy qz qw``), host numpy: export, loading, association, Sim3
alignment, ATE and RPE, the evaluation the TUM benchmark's scripts make.
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


def load_tum(path: str):
    """(timestamps (N,), positions (N, 3), xyzw quaternions (N, 4)) of a
    TUM file."""
    data = np.loadtxt(path)
    if data.ndim == 1:
        data = data[None]
    return data[:, 0], data[:, 1:4], data[:, 4:8]


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


def quat2rot(q: np.ndarray) -> np.ndarray:
    """Unit quaternion (x, y, z, w) -> rotation matrix, the inverse of
    ``ops.se3_np.rot2quat``'s convention."""
    x, y, z, w = q / np.linalg.norm(q)
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
        [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
        [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
    ])


def tum_to_matrices(pos: np.ndarray, quat: np.ndarray) -> np.ndarray:
    """(N, 3) positions and (N, 4) xyzw quaternions -> (N, 4, 4) poses."""
    out = np.tile(np.eye(4), (len(pos), 1, 1))
    for i in range(len(pos)):
        out[i, :3, :3] = quat2rot(quat[i])
        out[i, :3, 3] = pos[i]
    return out


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


def rpe(est: np.ndarray, gt: np.ndarray, delta: int = 1):
    """Relative pose error over a fixed frame delta (the TUM benchmark's
    evaluate_rpe): per-step drift, free of the global alignment. est, gt:
    (N, 4, 4) associated poses. Returns (translation RMSE, rotation RMSE
    in degrees), NaN for fewer than delta + 1 poses."""
    dt, dr = [], []
    for i in range(len(est) - delta):
        j = i + delta
        E = (np.linalg.inv(np.linalg.inv(est[i]) @ est[j])
             @ (np.linalg.inv(gt[i]) @ gt[j]))
        dt.append(np.linalg.norm(E[:3, 3]))
        c = np.clip((np.trace(E[:3, :3]) - 1) / 2, -1, 1)
        dr.append(np.degrees(np.arccos(c)))
    if not dt:
        return float("nan"), float("nan")
    return (float(np.sqrt(np.mean(np.square(dt)))),
            float(np.sqrt(np.mean(np.square(dr)))))


def ate_rmse(est_pos: np.ndarray, gt_pos: np.ndarray,
             with_scale: bool = True) -> float:
    """Absolute trajectory error RMSE after Sim3 (or SE3) alignment."""
    s, R, t = align_umeyama(est_pos, gt_pos, with_scale)
    aligned = (s * (R @ est_pos.T)).T + t
    return float(np.sqrt(((aligned - gt_pos) ** 2).sum(1).mean()))
