"""Poses against the route that made the frames: a frozen copy of the
port's ``utils/trajectory.py`` Umeyama alignment (its ``ate_rmse``'s
first step), and each frame's position and rotation error after it."""

from __future__ import annotations

import numpy as np


def align_umeyama(X: np.ndarray, Y: np.ndarray):
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
    # estimates that never move (var 0) scale to a point: no NaN
    s = np.trace(np.diag(D) @ S) / var if var > 0 else 0.0
    return s, R, my - s * R @ mx


def pose_errors(est: np.ndarray, gt: np.ndarray) -> dict:
    """Body-to-world poses ``est`` (N, 4, 4) in the system's frame against
    ``gt`` (N, 4, 4): the Sim3 alignment of the positions, each frame's
    position error (m) and rotation error (degrees) after it."""
    s, R, t = align_umeyama(est[:, :3, 3], gt[:, :3, 3])
    pos = (s * (R @ est[:, :3, 3].T)).T + t
    d_pos = np.linalg.norm(pos - gt[:, :3, 3], axis=1)
    rel = np.einsum("nji,njk->nik", gt[:, :3, :3], R @ est[:, :3, :3])
    cos = np.clip((np.trace(rel, axis1=1, axis2=2) - 1.0) / 2.0, -1.0, 1.0)
    return dict(scale=float(s), R=R, t=t, pos_m=d_pos, rot_deg=np.degrees(np.arccos(cos)))
