"""The system at the reference's own extractor options, port against the
JAX package: ``MultiColSLAM(rig=..., settings=SlamSettings(use_mdbrief=True,
learn_masks=True, use_agast=True, fast_agast_type=2))`` (mdBRIEF with its
learned stability masks over AGAST 7_12 corners; loop closing on; 754x480
x 3 cameras, 8 levels, 400 features) fed frames 0-17 of
``bench_trajectory``, rendered once by the port and shared as uint8, then
frames 18-19 with a relocalization forced before frame 18. The port's
RANSAC draws the JAX package's minimal sets (``_torchutil.JaxMinimalSets``),
as in test_torch_system.py. The port runs twice: with its own extractor,
under a spy on its two kernel entries that records whether each call site
passed the stability masks, and on the JAX package's features of each
frame, which holds everything after extraction (the masked matching at
every site, the map, mapping, relocalization) to the JAX package alone.
One run of each, module-scoped.

The port's mdBRIEF bits are not the JAX package's bit for bit (ORB's are):
9 to 13 descriptor bits and 11 to 22 mask bits of 614,400 differ at the
init extractor on frames 0, 8, 12 and 18, the same slots everywhere
(tests/test_torch_extractor.py, tests/test_torch_dbrief.py:
float32 atan2, cos, sin and the pattern mean's summation order differ by an
ulp between the libraries, and a pattern point within an ulp of .5 rounds
the other way). At the bootstrap one match differs (505 against 504 map
points), so the two systems start 0.86 mm apart, and local BA and the
relocalization carry that on.

Bars, with what was measured on the CPU:
  - in both port runs: the same init frame and leading camera, keyframe
    frames and per-frame ``frame_path`` strings as the JAX package
    (measured: init at frame 8, lead camera 0, keyframes at frames 7, 8
    and 16);
  - on the JAX package's features, every pose within 5 mm and 0.1 degree
    of the JAX package's (measured at most 0.10 mm and 0.00084 degree);
  - with the port's own extractor, every tracked pose within 5 mm and 0.1
    degree (measured at most 3.7 mm and 0.020 degree), the two frames of
    the forced relocalization within 1 cm and 0.1 degree (measured 6.0
    and 4.7 mm, 0.037 and 0.026 degree); both packages within 5 cm of
    ground truth after Sim3 alignment;
  - the forced relocalization: "reloc" then "reloc_recent" in every run;
  - every call site where the JAX package takes the masked distance
    passed both masks on every call; both SearchByBoW sites passed none
    (the JAX package's SearchByBoW is unmasked, loop_closing.py:267, :308).
"""

import sys
from collections import defaultdict

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from multicol_slam_tpu.models import initializer as jinit
from multicol_slam_tpu.models import system as jsys
from multicol_slam_tpu.utils import config_io as jcio
from multicol_slam_tpu_torch.models import initializer as tinit
from multicol_slam_tpu_torch.models import matcher as tmatcher
from multicol_slam_tpu_torch.models import system as tsys
from multicol_slam_tpu_torch.ops import ransac as tr
from multicol_slam_tpu_torch.utils import config_io as tcio
from multicol_slam_tpu_torch.utils import convert
from multicol_slam_tpu_torch.utils.trajectory import ate_rmse

import _torchutil as U

N_FRAMES = 18
N_RELOC = 2            # frames after N_FRAMES, the first under force_reloc
SETTINGS = dict(use_mdbrief=True, learn_masks=True, use_agast=True, fast_agast_type=2)
# the innermost function on the call stack that names each call site, as
# chip_smoke.py names them
SITES = {"search_for_initialization": "init", "_track_previous_frame": "window_search",
         "_motion_track_core": "motion", "_local_map_core": "local_map",
         "triangulation_batch": "triangulation", "cross_camera_batch": "cross_camera",
         "fuse_targets_batch": "fuse", "_reloc_matches": "reloc_window",
         "bow_match_frame": "reloc_bow", "_reloc_project_candidate": "reloc_projection",
         "_matched_point_pairs": "loop_bow", "_guided_sim3_pairs": "guided_sim3",
         "_count_neighborhood_support": "support"}
UNMASKED_SITES = {"reloc_bow", "loop_bow"}
# the masked sites this run must reach
MUST_REACH = {"init", "window_search", "motion", "local_map", "triangulation",
              "cross_camera", "fuse", "reloc_projection", "reloc_bow"}


def _recording(mod, out):
    f = mod.pick_leading_camera

    def wrapped(cand, rig):
        res = f(cand, rig)
        if res is not None:
            out.append(res)
        return res
    return wrapped


class MaskSpy:
    """Stands in for the port matcher's two kernel entries: records, per
    call site, how many calls passed the masks and how many did not."""

    def __init__(self):
        self.calls = defaultdict(lambda: [0, 0])     # site -> [masked, unmasked]
        self.entry = {"dense": tmatcher.hamming_nn, "radius": tmatcher.hamming_nn_radius}

    def _call(self, kind, args):
        n_plain = 3 if kind == "dense" else 10
        names, f = [], sys._getframe(2)
        while f is not None:
            names.append(f.f_code.co_name)
            f = f.f_back
        site = next(SITES[n] for n in names if n in SITES)
        self.calls[site][0 if len(args) == n_plain + 2 else 1] += 1
        return self.entry[kind](*args)

    def install(self, mp):
        mp.setattr(tmatcher, "hamming_nn", lambda *a: self._call("dense", a))
        mp.setattr(tmatcher, "hamming_nn_radius", lambda *a: self._call("radius", a))


@pytest.fixture(scope="module")
def runs():
    """(ground truth, JAX run, port run, port run on the JAX features, spy);
    a run is (system, poses, accepted leading-camera results)."""
    gt, frames = U.bench_frames(N_FRAMES + N_RELOC)
    mp = pytest.MonkeyPatch()
    leads = {"jax": [], "port": []}
    mp.setattr(jinit, "pick_leading_camera", _recording(jinit, leads["jax"]))
    mp.setattr(tinit, "pick_leading_camera", _recording(tinit, leads["port"]))
    spy = MaskSpy()

    def run(slam, frame):
        mp.setattr(tr, "sample_minimal_sets", U.JaxMinimalSets())
        poses = []
        for i in range(N_FRAMES + N_RELOC):
            slam.tracker.force_reloc |= i == N_FRAMES
            poses.append(slam.track(frame(i), i / 25.0))
        return poses

    def jax_extractor(fn):
        def extract(images):
            with U.f32():
                return convert.features_from_numpy(fn(jnp.asarray(images.numpy())))
        return extract

    def port_run(settings, leads_out, on_jax_features=False):
        n = len(leads["port"])
        ts = tsys.MultiColSLAM(rig=U.full_torch_rig(), settings=settings)
        if on_jax_features:
            ts.extract = jax_extractor(js.extract)
            ts.extract_init = jax_extractor(js.extract_init)
        poses = run(ts, lambda i: frames[i])
        leads_out.extend(leads["port"][n:])
        return ts, poses

    try:
        with U.f32():
            js = jsys.MultiColSLAM(rig=jax.tree.map(jnp.asarray, U.full_jax_rig()),
                                   settings=jcio.SlamSettings(**SETTINGS))
            jposes = run(js, lambda i: jnp.asarray(frames[i].numpy()))
        settings = tcio.SlamSettings(**SETTINGS)
        own, fed = [], []
        ts_fed, tp_fed = port_run(settings, fed, on_jax_features=True)
        spy.install(mp)
        ts, tp = port_run(settings, own)
    finally:
        mp.undo()
    return (gt, (js, jposes, leads["jax"]), (ts, tp, own), (ts_fed, tp_fed, fed), spy)


def _init_frame(poses):
    return next(i for i, p in enumerate(poses) if p is not None)


def _errors(tp, jp, frames):
    return [U.pose_error_hom(tp[i], jp[i]) for i in frames if jp[i] is not None]


def test_mdbrief_configuration_in_both(runs):
    _, (js, _, _), (ts, _, _), _, _ = runs
    for slam in (js, ts):
        assert slam.tracker.params.masked and slam.mapper.params.masked
    assert ts.tracker.params == ts.mapper.params
    assert (ts.tracker.params.th_high, ts.tracker.params.th_low) == (48, 32)


@pytest.mark.parametrize("which", ["own_extractor", "jax_features"])
def test_same_bootstrap_keyframes_and_frame_paths(runs, which):
    _, (js, jp, jl), own, fed, _ = runs
    ts, tp, tl = own if which == "own_extractor" else fed
    assert _init_frame(tp) == _init_frame(jp) < 12
    assert len(tl) == len(jl) == 1 and tl[0].lead_cam == jl[0].lead_cam
    jm, tm = js.map, ts.map
    np.testing.assert_array_equal(tm.kf_frame_id[tm.kf_valid], jm.kf_frame_id[jm.kf_valid])
    assert tm.n_keyframes() >= 3
    assert ts.tracker.frame_path == js.tracker.frame_path
    assert ts.tracker.frame_path[N_FRAMES:] == ["reloc", "reloc_recent"]


def test_poses_on_the_jax_features_follow_jax(runs):
    _, (_, jp, _), _, (_, tp, _), _ = runs
    assert [p is None for p in tp] == [p is None for p in jp]
    errs = _errors(tp, jp, range(len(jp)))
    assert max(t for t, _ in errs) <= 5e-3, errs
    assert max(r for _, r in errs) <= 0.1, errs


def test_poses_follow_jax_and_ground_truth(runs):
    gt, (_, jp, _), (_, tp, _), _, _ = runs
    assert [p is None for p in tp] == [p is None for p in jp]
    for frames, max_t in ((range(N_FRAMES), 5e-3), (range(N_FRAMES, N_FRAMES + N_RELOC), 1e-2)):
        errs = _errors(tp, jp, frames)
        assert max(t for t, _ in errs) <= max_t, errs
        assert max(r for _, r in errs) <= 0.1, errs
    k = _init_frame(tp)
    for poses in (tp, jp):
        est = np.stack([p[:3, 3] for p in poses[k:N_FRAMES]])
        assert ate_rmse(est, gt[k:N_FRAMES, :3, 3]) < 0.05


def test_masked_sites_pass_masks_and_bow_sites_do_not(runs):
    *_, spy = runs
    calls = dict(spy.calls)
    assert MUST_REACH <= set(calls), calls
    for site, (masked, unmasked) in calls.items():
        if site in UNMASKED_SITES:
            assert masked == 0 and unmasked > 0, (site, calls)
        else:
            assert unmasked == 0 and masked > 0, (site, calls)
