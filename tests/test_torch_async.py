"""Async mapping, port against the JAX package: the mapper thread behind a
keyframe queue (the reference's tracking / local-mapping thread split,
cSystem.cpp:96-110), its back-pressure and InterruptBA
(cTracking.cpp:922-935, cLocalMapping.cpp:512-515), and reset
propagation (cTracking.cpp:1327-1375).

- ``TestInterruptBA`` and ``TestResetPropagation`` of tests/test_reset.py
  mirrored on both packages, on the in-repo rig: the same stages run,
  the same state is left after ``reset()``.
- The port with ``async_mapping=True`` and the queue joined after every
  ``track()`` gives exactly the poses and the map of its synchronous run
  over the same frames (the same work in the same order, in another
  thread).
- tests/test_async_mapping.py's bars on the port, free-running.
- Where the port differs from the JAX package, by design: a failure in
  the mapper thread is raised on the tracking thread at the next
  ``track()``, ``track_batch()`` or ``shutdown()`` (the JAX package prints
  it and carries on), and ``reset()`` waits for a pass in flight before
  the map is cleared (the JAX package clears the map under it).
- The kernel wrapper across threads: the library is built once however
  many threads reach it first, and no launch count is lost.

The systems run at full width (754x480 x 3 cameras) with the default
settings over frames of ``bench_trajectory``, as tests/test_torch_system.py.
"""

import queue
import sys
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multicol_slam_tpu.models import matcher as jmatcher
from multicol_slam_tpu.models import system as jsys
from multicol_slam_tpu.models import vocabulary as jvoc
from multicol_slam_tpu.models.keyframe_database import KeyFrameDatabase as JKeyFrameDatabase
from multicol_slam_tpu.models.local_mapping import LocalMapper as JLocalMapper
from multicol_slam_tpu.models.loop_closing import LoopCloser as JLoopCloser
from multicol_slam_tpu.models.map import MapStore as JMapStore
from multicol_slam_tpu.utils import config_io as jcio
from multicol_slam_tpu_torch.kernels import hamming_nn as knn
from multicol_slam_tpu_torch.models import matcher as tmatcher
from multicol_slam_tpu_torch.models import system as tsys
from multicol_slam_tpu_torch.models import vocabulary as tvoc
from multicol_slam_tpu_torch.models.keyframe_database import KeyFrameDatabase
from multicol_slam_tpu_torch.models.local_mapping import LocalMapper
from multicol_slam_tpu_torch.models.loop_closing import LoopCloser
from multicol_slam_tpu_torch.models.map import MapStore
from multicol_slam_tpu_torch.models.tracking import TrackState
from multicol_slam_tpu_torch.utils import config_io as tcio

import _torchutil as U

N_FRAMES = 17
STAGES = ["_update_point_stats_for_kf", "_cull_map_points", "_create_new_map_points",
          "_create_cross_camera_points", "_fuse_in_neighbors", "_local_bundle_adjustment",
          "_cull_keyframes"]


def _jax_rig():
    return jax.tree.map(jnp.asarray, U.full_jax_rig())


# -- InterruptBA -----------------------------------------------------------

def _recorded_pass(package, interrupted):
    """The stages a mapping pass of keyframe 0 runs in ``package``, with
    ``interrupt_check`` reporting a pending keyframe or unset."""
    if package == "jax":
        m = JMapStore(capacity_pts=64, capacity_kfs=4, n_cams=3, k_per_cam=16)
        mapper = JLocalMapper(_jax_rig(), m, jmatcher.MatchParams(desc_bytes=32))
    else:
        m = MapStore(capacity_pts=64, capacity_kfs=4, n_cams=3, k_per_cam=16)
        mapper = LocalMapper(U.full_torch_rig(), m, tmatcher.MatchParams(desc_bytes=32))
    m.alloc_keyframe(np.zeros(6), None, 0)
    calls = []
    for name in STAGES:
        setattr(mapper, name, (lambda n: lambda kf: calls.append(n))(name))
    if interrupted:
        mapper.interrupt_check = lambda: True
    mapper.process_keyframe(0)
    return calls


class TestInterruptBA:
    @pytest.mark.parametrize("package", ["jax", "port"])
    def test_uninterrupted_runs_all_stages(self, package):
        calls = _recorded_pass(package, interrupted=False)
        assert calls == STAGES
        assert calls == _recorded_pass("jax", interrupted=False)

    @pytest.mark.parametrize("package", ["jax", "port"])
    def test_pending_keyframe_aborts_ba(self, package):
        """A pending keyframe skips fuse, local BA and keyframe culling;
        the front stages always run."""
        calls = _recorded_pass(package, interrupted=True)
        assert calls == STAGES[:4]
        assert calls == _recorded_pass("jax", interrupted=True)


# -- reset propagation -------------------------------------------------------

def _fabricate_stale_state(slam, voc_mod, closer_cls, db_cls, words_dtype):
    """tests/test_reset.py's state of a "previous map": probation points, a
    loop closer with a database entry, BoW caches, a consistency group
    and a last loop, and a keyframe queued for the mapper."""
    slam.mapper.recent_pts.extend([(3, 0), (5, 1)])
    rng = np.random.default_rng(0)
    voc = voc_mod.train_vocabulary(rng.integers(0, 2 ** 32, (64, 8)).astype(np.uint32),
                                   k=4, levels=2)
    slam.loop_closer = closer_cls(slam.rig, slam.map, voc, db_cls(), slam._loop_params)
    slam.loop_closer.db.add(0, {1: 0.5, 2: 0.25})
    slam.loop_closer.kf_words[0] = np.zeros(4, words_dtype)
    slam.loop_closer.consistent_groups.append(({0}, 2))
    slam.loop_closer.last_loop_kf = 7
    slam._kf_queue.put(3)


def _state_after_reset(slam):
    lc = slam.loop_closer
    try:
        slam._kf_queue.get_nowait()
        queued = True
    except queue.Empty:
        queued = False
    return dict(recent_pts=list(slam.mapper.recent_pts), kf_bow=dict(lc.db.kf_bow),
                kf_words=dict(lc.kf_words), groups=list(lc.consistent_groups),
                last_loop_kf=lc.last_loop_kf, queued=queued,
                n_keyframes=slam.map.n_keyframes())


class TestResetPropagation:
    def test_reset_clears_mapper_loopcloser_and_queue(self):
        settings_j = jcio.SlamSettings(n_features=64, n_levels=2)
        with U.f32():
            js = jsys.MultiColSLAM(rig=_jax_rig(), settings=settings_j, capacity_pts=256,
                                   capacity_kfs=8, enable_loop_closing=True,
                                   async_mapping=True)
            try:
                _fabricate_stale_state(js, jvoc, JLoopCloser, JKeyFrameDatabase, np.int32)
                js.reset()
                want = _state_after_reset(js)
            finally:
                js.shutdown()

        ts = tsys.MultiColSLAM(rig=U.full_torch_rig(),
                               settings=tcio.SlamSettings(n_features=64, n_levels=2),
                               capacity_pts=256, capacity_kfs=8, enable_loop_closing=True,
                               async_mapping=True)
        # a pass in flight holds the mapper, so the stale keyframe is still
        # queued when reset() drains the queue; reset waits for the pass
        release = threading.Event()
        started = threading.Event()
        ts._process_kf = lambda kf: (started.set(), release.wait(30))
        try:
            ts._kf_queue.put(0)
            assert started.wait(30)
            _fabricate_stale_state(ts, tvoc, LoopCloser, KeyFrameDatabase, np.int32)
            threading.Timer(0.2, release.set).start()
            ts.reset()
            assert release.is_set() and not ts._mapper_busy.is_set()
            got = _state_after_reset(ts)
        finally:
            release.set()
            ts.shutdown()
        assert got == want
        assert got == dict(recent_pts=[], kf_bow={}, kf_words={}, groups=[],
                           last_loop_kf=want["last_loop_kf"], queued=False, n_keyframes=0)
        assert got["last_loop_kf"] < 0


# -- the port's async runs ---------------------------------------------------

def _port_run(async_mapping, join_each=False, n=N_FRAMES):
    """The port's system over the first n frames of ``bench_trajectory``;
    returns (system after shutdown, poses, states)."""
    _, frames = U.bench_frames(n)
    slam = tsys.MultiColSLAM(rig=U.full_torch_rig(), async_mapping=async_mapping)
    poses, states = [], []
    try:
        for i in range(n):
            poses.append(slam.track(frames[i], i / 25.0))
            if join_each:
                slam._kf_queue.join()
            states.append(slam.state)
    finally:
        slam.shutdown()
    return slam, poses, states


@pytest.fixture(scope="module")
def sync_run():
    return _port_run(False)


def test_async_joined_after_every_frame_equals_sync(sync_run):
    """The same passes in the same order, in the mapper thread: poses and
    map equal exactly."""
    ss, sp, _ = sync_run
    aa, ap, _ = _port_run(True, join_each=True)
    assert [p is None for p in ap] == [p is None for p in sp]
    for a, b in zip(ap, sp):
        if b is not None:
            np.testing.assert_array_equal(a, b)
    assert aa.tracker.frame_path == ss.tracker.frame_path
    assert len(aa.mapping_ms) == len(ss.mapping_ms) == ss.map.n_keyframes() >= 3
    for name in ("kf_valid", "kf_pose", "kf_pt", "pt_valid", "pt_pos", "pt_visible",
                 "pt_found"):
        np.testing.assert_array_equal(getattr(aa.map, name), getattr(ss.map, name))
    assert sorted(aa.loop_closer.db.kf_bow) == sorted(ss.loop_closer.db.kf_bow)


def test_async_mapping_tracks_free_running():
    """tests/test_async_mapping.py's bars: WORKING on > 80% of the frames
    after the first WORKING one, >= 2 keyframes, > 100 points."""
    slam, _, states = _port_run(True)
    assert TrackState.WORKING in states
    first = states.index(TrackState.WORKING)
    frac = np.mean([s == TrackState.WORKING for s in states[first:]])
    assert frac > 0.8, frac
    assert slam.map.n_keyframes() >= 2
    assert slam.map.n_points() > 100
    assert slam._kf_queue.unfinished_tasks == 0


# -- failures and reset with a pass in flight ----------------------------------

def _small_async_system():
    from multicol_slam_tpu_torch.ops.rig import scale_rig
    rig = scale_rig(tcio.load_mcs(tcio.SYNTH_RIG_DIR)[0], 0.25)
    return tsys.MultiColSLAM(rig=rig, async_mapping=True, enable_loop_closing=False)


@pytest.mark.parametrize("where", ["track", "track_batch", "shutdown"])
def test_mapper_failure_is_raised_on_the_tracking_thread(where):
    slam = _small_async_system()

    def boom(kf):
        raise ValueError(f"stage failed on keyframe {kf}")

    slam.mapper.process_keyframe = boom
    frame = torch.zeros((3, 120, 188), dtype=torch.uint8)
    slam._enqueue_kf(0)
    slam._kf_queue.join()
    try:
        with pytest.raises(RuntimeError, match="mapper thread failed") as info:
            if where == "track":
                slam.track(frame, 0.0)
            elif where == "track_batch":
                slam.track_batch(frame[None], [0.0])
            else:
                slam.shutdown()
        assert isinstance(info.value.__cause__, ValueError)
        assert slam.tracker.frame_id == -1        # no frame was tracked
    finally:
        slam.shutdown()


def test_reset_waits_for_a_pass_in_flight():
    """The reference's RequestReset waits for the mapper: the pass in
    flight ends on the map as it was, then the map is cleared."""
    slam = _small_async_system()
    slam.map.alloc_keyframe(np.zeros(6), None, 0)
    started, seen = threading.Event(), []

    def slow_pass(kf):
        started.set()
        time.sleep(0.3)
        seen.append(slam.map.n_keyframes())

    slam.mapper.process_keyframe = slow_pass
    try:
        slam._enqueue_kf(0)
        slam._enqueue_kf(0)               # queued behind the pass: drained
        assert started.wait(30) and slam._mapper_busy.is_set()
        slam.reset()
        assert seen == [1]
        assert slam.map.n_keyframes() == 0 and slam._kf_queue.unfinished_tasks == 0
        assert not slam._mapper_busy.is_set() and len(slam.mapping_ms) == 1
    finally:
        slam.shutdown()


# -- the kernel wrapper across threads ---------------------------------------

def test_library_is_built_once_by_racing_threads(monkeypatch):
    builds = []

    def build():
        builds.append(threading.get_ident())
        time.sleep(0.1)
        return object()

    monkeypatch.setattr(knn, "_lib", None)
    monkeypatch.setattr(knn, "_build_and_load", build)
    got, barrier = [], threading.Barrier(8)

    def first_use():
        barrier.wait()
        got.append(knn.load_library())

    threads = [threading.Thread(target=first_use) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    assert len(builds) == 1 and len(got) == 8 and all(g is got[0] for g in got)


def test_launch_counts_lose_no_update_across_threads(monkeypatch):
    """Eight threads launch entry B 400 times each, with the interpreter
    switching threads every microsecond; the launch path is stubbed (no
    card here), the counting is the wrapper's own."""
    monkeypatch.setattr(knn, "_kernel_ready", lambda *a: None)
    monkeypatch.setattr(knn, "_run", lambda *a: None)
    monkeypatch.setattr(knn, "load_library", lambda: type("Lib", (), {"hamming_nn_launch": None}))
    meta = lambda *shape, dtype=torch.int32: torch.zeros(shape, dtype=dtype, device="meta")
    q, db, gate = meta(1, 16, 8), meta(1, 16, 8), meta(1, 16, 16, dtype=torch.bool)
    monkeypatch.setattr(knn.hamming_nn, "launches", 0)
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: [knn.hamming_nn(q, db, gate)
                                                    for _ in range(400)])
                   for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(switch)
    assert not any(t.is_alive() for t in threads)
    assert knn.hamming_nn.launches == 8 * 400
