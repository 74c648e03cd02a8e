"""The whole system from the first frame, port against the JAX package:
``MultiColSLAM(rig=...)`` in its default configuration (loop closing and
relocalization on; 754x480 x 3 cameras, 8 levels, 400 features) fed
frames 0-17 of ``bench_trajectory``, rendered once by the port and shared
as uint8, then frames 18-20 with a relocalization forced before frames 18
and 20 (``tracker.force_reloc``, as the loop closer sets it). Before frame
20 the tracker's BoW hooks are unset, as in a system built with
``enable_loop_closing=False``: that relocalization matches the ten most
recent keyframes by a window search over the whole image. The port's
RANSAC draws the JAX package's minimal sets
(``_torchutil.JaxMinimalSets``: the 5-point sets of the bootstrap and the
3-point sets of the relocalization's GP3P RANSAC), so both bootstrap and
relocalize from the same samples. One run per package, module-scoped.

Bars, with what was measured on the CPU:
  - the same init frame, leading camera and keyframe frames (measured:
    init at frame 8 from the pair (0, 8), lead camera 0, keyframes at
    frames 7, 8 and 16);
  - identical per-frame ``frame_path`` strings;
  - every tracked pose within 5 mm and 0.1 degree of the JAX package's
    (measured at most 1.2e-5 m and 6.4e-5 degree);
  - the map's point count within 3% (measured 586 and 586);
  - and both within 5 cm of ground truth after Sim3 alignment;
  - the same keyframes in both keyframe databases, and after the forced
    relocalization frame paths "reloc" then "reloc_recent" in both, the
    relocalized pose within 5 mm and 0.1 degree of the JAX package's;
  - with no BoW hooks, frame 20 relocalizes in both ("reloc"), its pose
    within 5 mm and 0.1 degree of the JAX package's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from multicol_slam_tpu.models import initializer as jinit
from multicol_slam_tpu.models import system as jsys
from multicol_slam_tpu_torch.models import initializer as tinit
from multicol_slam_tpu_torch.models import system as tsys
from multicol_slam_tpu_torch.ops import ransac as tr
from multicol_slam_tpu_torch.utils.trajectory import ate_rmse

import _torchutil as U

N_FRAMES = 18
N_RELOC = 3        # frames after N_FRAMES, the first and the last under force_reloc
NO_VOC_FRAME = N_FRAMES + 2     # relocalized with the tracker's BoW hooks unset


def _recording(mod, out):
    """Wrap ``mod.pick_leading_camera`` to record its accepted results."""
    f = mod.pick_leading_camera

    def wrapped(cand, rig):
        res = f(cand, rig)
        if res is not None:
            out.append(res)
        return res
    return wrapped


@pytest.fixture(scope="module")
def runs():
    gt, frames = U.bench_frames(N_FRAMES + N_RELOC)
    mp = pytest.MonkeyPatch()
    leads = {"jax": [], "port": []}
    mp.setattr(jinit, "pick_leading_camera", _recording(jinit, leads["jax"]))
    mp.setattr(tinit, "pick_leading_camera", _recording(tinit, leads["port"]))
    mp.setattr(tr, "sample_minimal_sets", U.JaxMinimalSets())

    def run(slam, frame):
        poses = []
        for i in range(N_FRAMES + N_RELOC):
            if i == NO_VOC_FRAME:
                slam.tracker.reloc_candidates_fn = slam.tracker.reloc_bow_match_fn = None
            slam.tracker.force_reloc |= i in (N_FRAMES, NO_VOC_FRAME)
            poses.append(slam.track(frame(i), i / 25.0))
        return poses

    try:
        with U.f32():
            js = jsys.MultiColSLAM(rig=jax.tree.map(jnp.asarray, U.full_jax_rig()))
            jposes = run(js, lambda i: jnp.asarray(frames[i].numpy()))
        ts = tsys.MultiColSLAM(rig=U.full_torch_rig())
        tposes = run(ts, lambda i: frames[i])
    finally:
        mp.undo()
    return gt, (js, jposes, leads["jax"]), (ts, tposes, leads["port"])


def _init_frame(poses):
    return next(i for i, p in enumerate(poses) if p is not None)


def test_same_bootstrap(runs):
    _, (js, jp, jl), (ts, tp, tl) = runs
    assert _init_frame(tp) == _init_frame(jp) < 12
    assert len(tl) == len(jl) == 1
    assert tl[0].lead_cam == jl[0].lead_cam
    np.testing.assert_array_equal(tl[0].ref_slots, jl[0].ref_slots)


def test_same_keyframes_and_frame_paths(runs):
    _, (js, _, _), (ts, _, _) = runs
    jm, tm = js.map, ts.map
    np.testing.assert_array_equal(tm.kf_frame_id[tm.kf_valid], jm.kf_frame_id[jm.kf_valid])
    assert tm.n_keyframes() >= 3
    assert ts.tracker.frame_path == js.tracker.frame_path
    assert ts.tracker.frame_path.count("fused") >= 6
    assert len(ts.mapping_ms) == tm.n_keyframes()


def test_poses_follow_jax(runs):
    _, (_, jp, _), (_, tp, _) = runs
    assert [p is None for p in tp] == [p is None for p in jp]
    errs = [U.pose_error_hom(a, b) for a, b in zip(tp, jp) if b is not None]
    assert max(t for t, _ in errs) <= 5e-3, errs
    assert max(r for _, r in errs) <= 0.1, errs


def test_map_size_and_accuracy(runs):
    gt, (js, jp, _), (ts, tp, _) = runs
    n_j, n_t = js.map.n_points(), ts.map.n_points()
    assert abs(n_t - n_j) <= 0.03 * n_j and n_t > 300
    k = _init_frame(tp)
    for poses in (tp, jp):
        est = np.stack([p[:3, 3] for p in poses[k:]])
        assert ate_rmse(est, gt[k:, :3, 3]) < 0.05


def test_loop_closer_and_forced_relocalization_follow_jax(runs):
    _, (js, jp, _), (ts, tp, _) = runs
    tm = ts.map
    assert js.loop_closer is not None and ts.loop_closer is not None
    kfs = sorted(tm.keyframe_ids().tolist())
    assert sorted(ts.loop_closer.db.kf_bow) == sorted(js.loop_closer.db.kf_bow) == kfs
    want = ["reloc", "reloc_recent"]
    assert ts.tracker.frame_path[N_FRAMES:NO_VOC_FRAME] == want
    assert js.tracker.frame_path[N_FRAMES:NO_VOC_FRAME] == want
    t, r = U.pose_error_hom(tp[N_FRAMES], jp[N_FRAMES])
    assert t <= 5e-3 and r <= 0.1, (t, r)


def test_relocalization_without_bow_hooks_follows_jax(runs):
    """The relocalization of a tracker with no loop closer wired: the
    window-search fallback in both packages."""
    _, (js, jp, _), (ts, tp, _) = runs
    assert ts.tracker.reloc_bow_match_fn is None and js.tracker.reloc_bow_match_fn is None
    assert ts.tracker.frame_path[NO_VOC_FRAME] == js.tracker.frame_path[NO_VOC_FRAME] == "reloc"
    assert ts.tracker.last_reloc_frame == js.tracker.last_reloc_frame == NO_VOC_FRAME
    assert not ts.tracker.force_reloc
    t, r = U.pose_error_hom(tp[NO_VOC_FRAME], jp[NO_VOC_FRAME])
    assert t <= 5e-3 and r <= 0.1, (t, r)
