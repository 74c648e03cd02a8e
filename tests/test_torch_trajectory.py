"""Scoring a run, port against the JAX package: ``load_tum``,
``quat2rot``, ``tum_to_matrices`` and ``rpe`` of utils/trajectory.py on
the same seeded inputs (host numpy in both, float64: equal to 1e-12), and
the port's ``python -m multicol_slam_tpu_torch.evaluate`` against the JAX
package's tools/evaluate_trajectory.py on the same files: the same JSON.
The CLI case mirrors tests/test_trajectory_eval.py::test_cli_end_to_end."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from multicol_slam_tpu.ops import se3_np as jse3
from multicol_slam_tpu.utils import trajectory as jtj
from multicol_slam_tpu_torch.ops import se3_np as tse3
from multicol_slam_tpu_torch.utils import trajectory as ttj

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _poses(rng, n, step=0.05, noise=0.0):
    """(n, 4, 4) poses along a yawing arc, with position and rotation noise."""
    out = np.tile(np.eye(4), (n, 1, 1))
    for i in range(n):
        w = np.array([0.0, 0.03 * i, 0.0]) + rng.standard_normal(3) * noise
        out[i, :3, :3] = tse3.cayley2rot(w)
        out[i, :3, 3] = [step * i, 0.01 * np.sin(i), 0.002 * i]
        out[i, :3, 3] += rng.standard_normal(3) * noise
    return out


def test_quat2rot_and_tum_to_matrices_match_jax():
    rng = np.random.default_rng(11)
    q = rng.standard_normal((40, 4))
    pos = rng.standard_normal((40, 3))
    for i in range(40):
        np.testing.assert_allclose(ttj.quat2rot(q[i]), jtj.quat2rot(q[i]), rtol=0, atol=1e-12)
    np.testing.assert_allclose(ttj.tum_to_matrices(pos, q), jtj.tum_to_matrices(pos, q),
                               rtol=0, atol=1e-12)
    # the inverse of rot2quat's convention
    R = tse3.cayley2rot(rng.standard_normal(3) * 0.5)
    np.testing.assert_allclose(ttj.quat2rot(tse3.rot2quat(R)), R, atol=1e-9)


@pytest.mark.parametrize("delta", [1, 3, 40])
def test_rpe_matches_jax(delta):
    rng = np.random.default_rng(delta)
    gt = _poses(rng, 30)
    est = _poses(rng, 30, noise=0.01)
    got, want = ttj.rpe(est, gt, delta), jtj.rpe(est, gt, delta)
    if delta >= 30:
        assert np.isnan(got).all() and np.isnan(want).all()
    else:
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)
        assert got[0] > 0.005


def test_load_tum_matches_jax(tmp_path):
    rng = np.random.default_rng(5)
    poses = _poses(rng, 12, noise=0.02)
    ts = np.arange(12) / 25.0
    path = str(tmp_path / "traj.txt")
    ttj.save_tum(path, ts, poses)
    for got, want in zip(ttj.load_tum(path), jtj.load_tum(path)):
        np.testing.assert_array_equal(got, want)
    one = str(tmp_path / "one.txt")
    jtj.save_tum(one, ts[:1], poses[:1])
    t, p, q = ttj.load_tum(one)
    assert t.shape == (1,) and p.shape == (1, 3) and q.shape == (1, 4)


def _circle(n, radius=1.0):
    out = []
    for i in range(n):
        a = 2 * np.pi * i / n
        M = np.eye(4)
        c, s = np.cos(a), np.sin(a)
        M[:3, :3] = [[c, -s, 0], [s, c, 0], [0, 0, 1]]
        M[:3, 3] = [radius * c, radius * s, 0.0]
        out.append(M)
    return np.stack(out)


def test_evaluate_matches_the_jax_tool(tmp_path):
    """tests/test_trajectory_eval.py's CLI case: a Sim3-transformed noisy
    estimate scores ATE ~ the noise; both tools print the same JSON."""
    gt = _circle(30)
    rng = np.random.default_rng(0)
    S = np.eye(4)
    S[:3, :3] = 1.7 * jse3.cayley2rot(np.array([0.2, -0.1, 0.4]))
    S[:3, 3] = [3.0, -2.0, 1.0]
    est = np.stack([S @ M for M in gt])
    est[:, :3, :3] /= 1.7
    est[:, :3, 3] += rng.standard_normal((30, 3)) * 0.005 * 1.7
    ts = np.arange(30) / 25.0
    pe, pg = str(tmp_path / "est.txt"), str(tmp_path / "gt.txt")
    ttj.save_tum(pe, ts, est)
    ttj.save_tum(pg, ts, gt)
    recs = {}
    for name, cmd in (("port", [sys.executable, "-m", "multicol_slam_tpu_torch.evaluate"]),
                      ("jax", [sys.executable, "tools/evaluate_trajectory.py"])):
        for extra in ([], ["--no-scale", "--rpe-delta", "2"]):
            out = subprocess.run(cmd + [pe, pg] + extra, capture_output=True, text=True,
                                 cwd=REPO, timeout=120,
                                 env=dict(os.environ, JAX_PLATFORMS="cpu"))
            assert out.returncode == 0, out.stderr
            recs[name, bool(extra)] = json.loads(out.stdout.strip().splitlines()[-1])
    assert recs["port", False] == recs["jax", False]
    assert recs["port", True] == recs["jax", True]
    rec = recs["port", False]
    assert rec["n_associated"] == 30 and rec["ate_rmse_m"] < 0.02
    assert rec["alignment"] == "sim3" and recs["port", True]["alignment"] == "se3"


def test_evaluate_refuses_too_few_pairs(tmp_path):
    pe, pg = str(tmp_path / "est.txt"), str(tmp_path / "gt.txt")
    ttj.save_tum(pe, [0.0, 0.04], _circle(2))
    ttj.save_tum(pg, [5.0, 5.04], _circle(2))
    out = subprocess.run([sys.executable, "-m", "multicol_slam_tpu_torch.evaluate", pe, pg],
                         capture_output=True, text=True, cwd=REPO, timeout=120)
    assert out.returncode == 1 and "associated pairs" in out.stderr
