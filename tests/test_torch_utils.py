"""The port's host utilities against the JAX package's: the numpy SE3
helpers (a copy), the synthetic trajectories, trajectory export and
scoring, the settings loader and the stage timers. All are numpy on both
sides, so the bar is equality (files byte-identical)."""

import numpy as np
import pytest

from multicol_slam_tpu.ops import se3_np as jse3
from multicol_slam_tpu.utils import config_io as jcio
from multicol_slam_tpu.utils import synthetic as jsyn
from multicol_slam_tpu.utils import timing as jtiming
from multicol_slam_tpu.utils import trajectory as jtraj
from multicol_slam_tpu_torch.ops import se3_np as tse3
from multicol_slam_tpu_torch.utils import config_io as tcio
from multicol_slam_tpu_torch.utils import synthetic as tsyn
from multicol_slam_tpu_torch.utils import timing as ttiming
from multicol_slam_tpu_torch.utils import trajectory as ttraj


@pytest.mark.parametrize("name", ["cayley2hom", "hom2cayley", "inv_se3", "skew",
                                  "cayley2rot", "rot2cayley"])
def test_se3_np_is_the_same(name):
    rng = np.random.default_rng(0)
    c6 = np.c_[rng.normal(0, 0.3, (5, 3)), rng.normal(0, 2, (5, 3))]
    arg = {"cayley2hom": c6, "hom2cayley": jse3.cayley2hom(c6),
           "inv_se3": jse3.cayley2hom(c6), "skew": c6[:, 3:],
           "cayley2rot": c6[:, :3], "rot2cayley": jse3.cayley2rot(c6[:, :3])}[name]
    np.testing.assert_array_equal(getattr(tse3, name)(arg), getattr(jse3, name)(arg))


def test_two_view_helpers_are_the_same():
    rng = np.random.default_rng(1)
    T1, T2 = (np.linalg.inv(jse3.cayley2hom(np.r_[rng.normal(0, 0.2, 3), rng.normal(0, 1, 3)]))
              for _ in range(2))
    np.testing.assert_array_equal(tse3.essential_from_poses(T1, T2),
                                  jse3.essential_from_poses(T1, T2))
    v1, v2 = rng.normal(size=(2, 20, 3))
    R, t = jse3.cayley2rot(rng.normal(0, 0.1, 3)), rng.normal(size=3)
    np.testing.assert_array_equal(tse3.triangulate_midpoint(t, R, v1, v2),
                                  jse3.triangulate_midpoint(t, R, v1, v2))


@pytest.mark.parametrize("n", [5, 30])
def test_trajectories_are_the_same(n):
    np.testing.assert_array_equal(tsyn.lateral_trajectory(n), jsyn.lateral_trajectory(n))
    np.testing.assert_array_equal(tsyn.bench_trajectory(n), jsyn.bench_trajectory(n))
    np.testing.assert_array_equal(tsyn.smooth_trajectory(n), jsyn.smooth_trajectory(n))


def test_trajectory_scoring_is_the_same(tmp_path):
    gt = jsyn.bench_trajectory(30)
    rng = np.random.default_rng(2)
    est = gt.copy()
    est[:, :3, 3] = 0.7 * gt[:, :3, 3] + rng.normal(0, 0.01, (30, 3)) + [0.1, 0, 0]
    for with_scale in (True, False):
        assert ttraj.ate_rmse(est[:, :3, 3], gt[:, :3, 3], with_scale) == \
            jtraj.ate_rmse(est[:, :3, 3], gt[:, :3, 3], with_scale)
        for a, b in zip(ttraj.align_umeyama(est[:, :3, 3], gt[:, :3, 3], with_scale),
                        jtraj.align_umeyama(est[:, :3, 3], gt[:, :3, 3], with_scale)):
            np.testing.assert_array_equal(a, b)
    ta, tb = np.arange(30) * 0.04, np.arange(0, 30, 2) * 0.04 + 0.005
    assert ttraj.associate(ta, tb) == jtraj.associate(ta, tb)
    ts = list(np.arange(30) * 0.04)
    ttraj.save_tum(str(tmp_path / "port.txt"), ts, est)
    jtraj.save_tum(str(tmp_path / "jax.txt"), ts, est)
    assert (tmp_path / "port.txt").read_text() == (tmp_path / "jax.txt").read_text()


def test_settings_loader_is_the_same(tmp_path):
    path = tmp_path / "Slam_Settings.yaml"
    path.write_text("%YAML:1.0\nCamera.fps: 20\nextractor.nFeatures: 500\n"
                    "extractor.nLevels: 6\nextractor.nScoreType: 1\n"
                    "UseMotionModel: 0\ntraj.StartFrame: 25\n")
    got, want = tcio.load_settings(str(path)), jcio.load_settings(str(path))
    assert got == tcio.SlamSettings(**{f: getattr(want, f) for f in
                                       want.__dataclass_fields__})
    assert (got.min_frames, got.max_frames) == (want.min_frames, want.max_frames) == (6, 13)


def test_stage_timers_summarize_alike():
    t, j = ttiming.StageTimers(), jtiming.StageTimers()
    for s in (0.01, 0.02, 0.5):
        t.record("stage", s)
        j.record("stage", s)
    assert t.summary() == j.summary()
    assert t.report() == j.report()
