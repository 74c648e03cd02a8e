"""The chunked throughput path, port against the JAX package:
``MultiColSLAM.track_batch(frames, timestamps, chunk=8)`` over frames 0-17
of ``bench_trajectory`` at full width and the default settings (loop
closing on), as tests/test_torch_system.py runs ``track``. The first
frames go through the per-frame fallback (bootstrap at frame 8, the
velocity frame 9), then ``Tracker.track_chunk`` takes frames 10-17 in one
chunk: ``working_scan_chunk`` over the 8 frames and one fetch, the
bookkeeping replayed on the host, a keyframe fired inside the chunk. The
port's RANSAC draws the JAX package's minimal sets
(``_torchutil.JaxMinimalSets``), so both bootstrap from the same samples.

Bars, with what was measured on the CPU:
  - the same accepted prefix from every ``track_chunk`` call (measured:
    None on the ten calls to frame 9, then all 8), the same
    ``frame_path`` and ``dispatches_per_frame`` per frame (1 on a chunk's
    first frame, 0 after), the keyframes at the same frames (measured 7,
    8 and 16, the last at chunk position 6);
  - every pose within 5 mm and 0.1 degree of the JAX package's, the bar
    of tests/test_torch_system.py (measured at most 1.6e-5 m and 1.3e-4
    degree);
  - and ``track_chunk``'s preconditions returning None in the port as in
    the JAX package.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multicol_slam_tpu.models import system as jsys
from multicol_slam_tpu_torch.models import system as tsys
from multicol_slam_tpu_torch.ops import ransac as tr

import _torchutil as U

N_FRAMES = 18
CHUNK = 8


def _recording_chunks(tracker, out):
    f = tracker.track_chunk

    def wrapped(images, timestamps):
        r = f(images, timestamps)
        out.append(None if r is None else r[0])
        return r
    tracker.track_chunk = wrapped


@pytest.fixture(scope="module")
def runs():
    _, frames = U.bench_frames(N_FRAMES)
    ts = [i / 25.0 for i in range(N_FRAMES)]
    mp = pytest.MonkeyPatch()
    mp.setattr(tr, "sample_minimal_sets", U.JaxMinimalSets())
    chunks = {"jax": [], "port": []}
    try:
        with U.f32():
            js = jsys.MultiColSLAM(rig=jax.tree.map(jnp.asarray, U.full_jax_rig()))
            _recording_chunks(js.tracker, chunks["jax"])
            jposes = js.track_batch(jnp.asarray(frames.numpy()), ts, chunk=CHUNK)
        tslam = tsys.MultiColSLAM(rig=U.full_torch_rig())
        _recording_chunks(tslam.tracker, chunks["port"])
        tposes = tslam.track_batch(frames, ts, chunk=CHUNK)
    finally:
        mp.undo()
    return (js, jposes, chunks["jax"]), (tslam, tposes, chunks["port"])


def test_same_chunks_paths_and_keyframes(runs):
    (js, _, jc), (ts, _, tc) = runs
    assert tc == jc
    assert CHUNK in tc                       # a whole chunk was accepted
    assert ts.tracker.frame_path == js.tracker.frame_path
    assert ts.tracker.frame_path.count("chunk") >= CHUNK
    assert ts.tracker.dispatches_per_frame == js.tracker.dispatches_per_frame
    jm, tm = js.map, ts.map
    np.testing.assert_array_equal(tm.kf_frame_id[tm.kf_valid], jm.kf_frame_id[jm.kf_valid])
    chunk_frames = [i for i, p in enumerate(ts.tracker.frame_path) if p == "chunk"]
    assert set(tm.kf_frame_id[tm.kf_valid]) & set(chunk_frames), \
        "no keyframe was fired inside a chunk"
    assert len(ts.mapping_ms) == tm.n_keyframes()


def test_poses_follow_jax(runs):
    (_, jp, _), (_, tp, _) = runs
    assert len(tp) == len(jp) == N_FRAMES
    assert [p is None for p in tp] == [p is None for p in jp]
    errs = [U.pose_error_hom(a, b) for a, b in zip(tp, jp) if b is not None]
    assert max(t for t, _ in errs) <= 5e-3, errs
    assert max(r for _, r in errs) <= 0.1, errs


def test_track_batch_checks_lengths(runs):
    (_, _, _), (ts, _, _) = runs
    with pytest.raises(ValueError, match="timestamps"):
        ts.track_batch(torch.zeros((2, 3, 4, 4), dtype=torch.uint8), [0.0])


@pytest.mark.parametrize("condition", ["not_working", "force_reloc", "no_velocity",
                                       "no_motion_model", "perturbed", "recent_reloc",
                                       "thin_carry"])
def test_chunk_preconditions_return_none(runs, condition):
    """Each streaming precondition of track_chunk refuses the chunk in
    both packages, before any device work."""
    (js, _, _), (ts, _, _) = runs
    for tracker in (js.tracker, ts.tracker):
        saved = {k: getattr(tracker, k) for k in ("state", "force_reloc", "velocity",
                                                  "perturb_pose_fn", "last_reloc_frame",
                                                  "last_outlier")}
        use_motion = tracker.cfg.use_motion_model
        try:
            if condition == "not_working":
                tracker.state = type(tracker.state).LOST
            elif condition == "force_reloc":
                tracker.force_reloc = True
            elif condition == "no_velocity":
                tracker.velocity = None
            elif condition == "no_motion_model":
                tracker.cfg.use_motion_model = False
            elif condition == "perturbed":
                tracker.perturb_pose_fn = lambda mt, i: mt
            elif condition == "recent_reloc":
                tracker.last_reloc_frame = tracker.frame_id - 1
            else:
                tracker.last_outlier = np.ones_like(tracker.last_outlier)
            n_disp = len(tracker.dispatches_per_frame)
            assert tracker.track_chunk(np.zeros((CHUNK, 3, 4, 4), np.uint8),
                                       [0.0] * CHUNK) is None
            assert len(tracker.dispatches_per_frame) == n_disp
        finally:
            tracker.cfg.use_motion_model = use_motion
            for k, v in saved.items():
                setattr(tracker, k, v)
