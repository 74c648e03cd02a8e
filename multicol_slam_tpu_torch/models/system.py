"""System orchestration (cSystem.{h,cpp}): tracking wired to local mapping
and loop closing, calibration loading, the per-frame and chunked APIs,
the viewer, trajectory export and global BA.

Port of ``multicol_slam_tpu/models/system.py``. By default the mapper and
the loop closer run on keyframe insertion, in the tracking thread
(deterministic). ``async_mapping=True`` moves them to a mapper thread
behind a keyframe queue, as the reference's thread split does
(cSystem.cpp:96-110, the mlNewMultiKeyFrames deque of
cLocalMapping.cpp:131-151). On the card that thread issues its work on a
CUDA stream of its own.

Where the port differs from the JAX package under async mapping:
- a failure in the mapper thread is kept and raised on the tracking
  thread at the next ``track``, ``track_batch`` or ``shutdown``; the JAX
  package prints it and carries on;
- a reset waits for a pass in flight before the map is cleared, as the
  reference's RequestReset waits for the mapper (cTracking.cpp:1327-1375);
  the JAX package clears the map first and lets the pass run on it.
"""

from __future__ import annotations

import contextlib
import queue
import threading
import time
from typing import Optional

import numpy as np
import torch

from ..ops.camera import make_extraction_masks
from ..ops.pyramid import level_sizes
from ..utils import config_io, graphs
from ..utils.trajectory import save_tum
from . import matcher
from . import optimizer as opt
from . import vocabulary as vocab_mod
from .extractor import ExtractorConfig, Features, make_extractor
from .global_ba import run_global_ba
from .keyframe_database import KeyFrameDatabase
from .local_mapping import LocalMapper
from .loop_closing import LoopCloser
from .map import MapStore
from .tracking import Tracker, TrackerConfig, TrackState, fetch


class MultiColSLAM:
    """The cSystem equivalent: construct from a calibration directory (or
    a rig) and settings, feed synchronized image sets, read back poses.

    The system runs on ``device``: by default the card ("cuda"), or the
    device of a ``rig`` passed in. A rig loaded from ``calib_dir`` goes
    onto the device, and so does a passed rig when ``device`` is named.
    Without a CUDA device the default raises; ``device="cpu"`` runs the
    system on the CPU (the Hamming-NN kernel's plain version)."""

    def __init__(self, calib_dir: Optional[str] = None,
                 settings_path: Optional[str] = None,
                 settings: Optional[config_io.SlamSettings] = None,
                 async_mapping: bool = False,
                 capacity_pts: int = 30000, capacity_kfs: int = 256,
                 enable_loop_closing: bool = True,
                 vocabulary_path: Optional[str] = None,
                 rig=None, device=None):
        self.settings = settings or (
            config_io.load_settings(settings_path) if settings_path
            else config_io.SlamSettings())
        s = self.settings
        if device is None:
            device = rig.M_c.device if rig is not None else "cuda"
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "MultiColSLAM runs on the card by default and no CUDA device is "
                "available: pass device='cpu' to run on the CPU")
        if rig is None:
            rig, _ = config_io.load_mcs(calib_dir)
        self.rig = rig.to(self.device)
        C = self.rig.n_cams
        cams = self.rig.cams
        w = int(float(cams.width[0]))
        h = int(float(cams.height[0]))

        # extraction masks at pyramid sizes: the fisheye circle only for
        # cameras whose calibration sets mirrorMask (cSystem.cpp:164-171)
        masks = []
        for c in range(C):
            if float(cams.mirror[c]) > 0.5:
                masks.append(make_extraction_masks(
                    float(cams.u0[c]), float(cams.v0[c]), w, h, s.n_levels,
                    s.scale_factor))
            else:
                masks.append([np.full(sz, 255, np.uint8) for sz in
                              level_sizes(h, w, s.n_levels, s.scale_factor)])
        masks_lvl = [np.stack([m[lvl] for m in masks]) for lvl in range(s.n_levels)]

        # extractor.useAgast + fastAgastType -> detector mask
        # (cv::AgastFeatureDetector types 0..3; 3 = OAST_9_16, FAST's ring)
        mask = "fast_9_16"
        if s.use_agast:
            mask = {0: "agast_5_8", 1: "agast_7_12", 2: "agast_7_12"}.get(
                s.fast_agast_type, "fast_9_16")
        ecfg = ExtractorConfig(
            n_features=s.n_features, scale_factor=s.scale_factor,
            n_levels=s.n_levels, fast_th=s.fast_th, desc_bytes=s.desc_size,
            use_dbrief=s.use_mdbrief, learn_masks=s.learn_masks,
            detector_mask=mask, use_harris=s.score_harris)
        self.extract = make_extractor(ecfg, self.rig.cams, masks_lvl, (h, w))
        # init extractor: 2x features, FAST threshold 5 (cTracking.cpp:206-235)
        ecfg_init = ecfg._replace(n_features=2 * s.n_features, fast_th=5)
        self.extract_init = make_extractor(ecfg_init, self.rig.cams,
                                           masks_lvl, (h, w))

        self.map = MapStore(capacity_pts=capacity_pts,
                            capacity_kfs=capacity_kfs, n_cams=C,
                            k_per_cam=2 * s.n_features,
                            desc_words=s.desc_size // 4)

        tcfg = TrackerConfig(
            n_features=s.n_features, desc_bytes=s.desc_size,
            masked=s.use_mdbrief and s.learn_masks,
            scale_factor=s.scale_factor, n_levels=s.n_levels, fps=s.fps,
            use_motion_model=s.use_motion_model)
        self.tracker = Tracker(self.rig, self._extract_padded,
                               self._extract_init_padded, self.map, tcfg)
        params = matcher.MatchParams(
            desc_bytes=s.desc_size, masked=s.use_mdbrief and s.learn_masks,
            scale_factor=s.scale_factor)
        self.mapper = LocalMapper(self.rig, self.map, params,
                                  scale_factor=s.scale_factor,
                                  n_levels=s.n_levels)
        # global_bundle_adjustment runs on the caller's thread: on the card
        # its BA graphs in the tracker's shared pool
        self._global_adjust = (graphs.jit(opt.bundle_adjustment)
                               if self.device.type == "cuda" else opt.bundle_adjustment)
        # loop closing: the vocabulary is loaded from ``vocabulary_path`` or
        # trained from the first keyframe's descriptors, then retrained on
        # VOCAB_RETRAIN_KFS keyframes with per-document idf
        self.loop_closer = None
        self._loop_params = params
        self._enable_loops = enable_loop_closing
        self._vocabulary_path = vocabulary_path
        self._voc_corpus: list[np.ndarray] = []
        self._voc_retrained = False
        # wall clock of each local-mapping pass, ms
        self.mapping_ms: list[float] = []
        # the frame publisher's snapshot for a viewer (keep_last_frame)
        self.keep_last_frame = False
        self.last_frame = None
        self._viewer = None

        self.async_mapping = async_mapping
        self._kf_queue: "queue.Queue[Optional[int]]" = queue.Queue()
        self._mapper_thread: Optional[threading.Thread] = None
        self._interrupt_ba = False
        # set by the mapper thread while a pass runs
        self._mapper_busy = threading.Event()
        self._mapper_error: Optional[BaseException] = None
        # on the card: the mapper's stream, and per queued keyframe an event
        # on the tracker's stream after the keyframe's features were made
        self._mapper_stream = None
        self._kf_ready: dict[int, torch.cuda.Event] = {}
        if async_mapping:
            if self.device.type == "cuda":
                # a stream no graph pool's capture runs on (graphs.own_stream)
                self._mapper_stream = graphs.own_stream(self.device)
            self._mapper_thread = threading.Thread(
                target=self._mapper_loop, name="multicol-mapper", daemon=True)
            self._mapper_thread.start()
            self.tracker.on_new_keyframe = self._enqueue_kf
            # AcceptMultiKeyFrames: a keyframe is inserted only while none
            # is queued or being mapped (cTracking.cpp:922-935); otherwise
            # InterruptBA, and the running pass yields its tail stages
            # (cLocalMapping.cpp:512-515)
            self.tracker.mapper_idle_fn = lambda: self._kf_queue.unfinished_tasks == 0
            self.tracker.interrupt_ba_fn = self._request_ba_interrupt
            self.mapper.interrupt_check = (
                lambda: not self._kf_queue.empty() or self._interrupt_ba)
        else:
            self.tracker.on_new_keyframe = self._process_kf
        # the two bootstrap keyframes are mapped inline in the tracking
        # thread (cTracking::CreateInitialMap, cTracking.cpp:439-722): their
        # first BA fixes the metric scale before the next frame
        self.tracker.on_init_keyframes = self._process_init_kfs
        self.tracker.on_reset = self._on_reset

    # ------------------------------------------------------------------

    def _pad_features(self, feats: Features, k_target: int) -> Features:
        """Pad a Features batch to the map's slot capacity, so init (2x
        features) and normal frames share one slot space."""
        k = feats.xy.shape[1]
        if k == k_target:
            return feats
        pad = k_target - k

        def padf(a, fill=0):
            return torch.cat([a, torch.full((a.shape[0], pad) + tuple(a.shape[2:]),
                                            fill, dtype=a.dtype, device=a.device)], 1)

        return feats._replace(
            xy=padf(feats.xy), level=padf(feats.level), angle=padf(feats.angle),
            response=padf(feats.response), ray=padf(feats.ray),
            desc=padf(feats.desc), desc_mask=padf(feats.desc_mask),
            valid=padf(feats.valid, False))

    def _extract_padded(self, images):
        return self._pad_features(self.extract(images), self.map.kf_pt.shape[2])

    def _extract_init_padded(self, images):
        return self._pad_features(self.extract_init(images),
                                  self.map.kf_pt.shape[2])

    # ------------------------------------------------------------------

    def _kf_descriptors(self, kf: int) -> np.ndarray:
        """The valid descriptors of keyframe kf, (n, W) uint32 on the host."""
        f = self.map.kf_features[kf]
        desc, valid = fetch(f.desc, f.valid)
        return desc.reshape(-1, desc.shape[-1])[valid.reshape(-1)].view(np.uint32)

    def _ensure_loop_closer(self, kf: int):
        if self.loop_closer is not None or not self._enable_loops:
            return
        if self._vocabulary_path:
            # DBoW2 OpenCV-YAML (the reference's, cSystem.cpp:60-63) or the
            # npz format, by extension
            if self._vocabulary_path.endswith((".yml", ".yaml")):
                voc = vocab_mod.load_dbow2_yaml(self._vocabulary_path)
            else:
                voc = vocab_mod.load_vocabulary(self._vocabulary_path)
        else:
            # k = 10 x 4 levels = 10^4 leaves, scaled down from the
            # reference's k = 9, L = 6: at 512 words every multi-frame
            # fills most of the word space and L1 scores flatten; at 10^4
            # same-place pairs score about 0.10 above others
            voc = vocab_mod.train_vocabulary(self._kf_descriptors(kf), k=10, levels=4)
        # the metric rig observes Sim3 scale: hold it in OptimizeSim3 and
        # the essential graph. The closer's units graph in the mapper's pool
        # (it runs on the mapper's thread, or with the mapper's units on
        # the tracker's), and its global BA shares the mapper's graphed BA
        lc = LoopCloser(self.rig, self.map, voc, KeyFrameDatabase(), self._loop_params,
                        fix_scale=True, fuser=self.mapper,
                        scale_factor=self.settings.scale_factor,
                        n_levels=self.settings.n_levels, pool=self.mapper.pool,
                        bundle_adjust=self.mapper._bundle_adjust,
                        frame_transform=self.tracker.bow_transform)
        # the tracker reads the vocabulary on its own stream: the copy to
        # the device lands before the closer is published
        self._stream_sync()
        self.loop_closer = lc
        self.loop_closer.on_loop = self._after_loop
        # cMultiKeyFrame::SetBadFlag -> KeyFrameDatabase::erase
        self.map.on_kf_removed = self.loop_closer.forget_keyframe
        self.tracker.reloc_candidates_fn = self._reloc_candidates
        self.tracker.reloc_bow_match_fn = self.loop_closer.bow_match_frame
        self.tracker.reloc_transform_ahead_fn = self._reloc_transforms

    def _frame_words(self, feats: Features):
        """A frame's BoW words (and nodes two levels up) through the
        tracker's transform (its graph on the card)."""
        W = feats.desc.shape[-1]
        return self.tracker.bow_transform(self.loop_closer.voc, feats.desc.reshape(-1, W),
                                          feats.valid.reshape(-1))

    def _reloc_transforms(self, feats: Features):
        """Both BoW transforms a relocalization runs on a frame: the
        candidates' words and SearchByBoW's nodes (the tracker's
        capture-ahead)."""
        self._frame_words(feats)
        self.loop_closer._transform(feats, self.tracker.bow_transform)

    def _reloc_candidates(self, feats: Features) -> list[int]:
        """BoW relocalization candidates (DetectRelocalisationCandidates,
        cMultiKeyFrameDatabase.cpp:213-330) from the live inverted file."""
        lc = self.loop_closer
        if lc is None or not lc.db.kf_bow:
            return []
        words, _ = self._frame_words(feats)
        return lc.db.detect_reloc_candidates(vocab_mod.bow_vector(lc.voc, fetch(words)[0]),
                                             self.map)

    def _on_reset(self):
        """Reset fan-out (cTracking::Reset clears the mapper, the loop
        closer and the keyframe database, cTracking.cpp:1327-1375), on both
        an explicit reset and the tracker's young-map reset, before the
        tracker clears the map. Under async mapping the queue is drained
        first and a pass in flight is waited for."""
        if self._mapper_thread is not None:
            try:
                while True:
                    self._kf_queue.get_nowait()
                    self._kf_queue.task_done()
            except queue.Empty:
                pass
            self._kf_queue.join()
            self._kf_ready.clear()
        self.mapper.reset()
        if self.loop_closer is not None:
            self.loop_closer.reset()

    def _after_loop(self, kf: int, loop_kf: int):
        # the map moved under the tracker (cLoopClosing calls
        # ForceRelocalisation, cLoopClosing.cpp:575)
        self.tracker.force_reloc = True
        self.tracker.map_dirty = True

    # keyframes in the corpus before the vocabulary retrain (>= 20, so the
    # idf weights come from a spread of views)
    VOCAB_RETRAIN_KFS = 20

    def _maybe_retrain_vocabulary(self, kf: int):
        """Keep each keyframe's descriptors; at VOCAB_RETRAIN_KFS keyframes
        retrain the vocabulary on the corpus with per-document idf and
        rebuild the loop closer's BoW state. A tree quantized from one
        frame ranks places poorly across a loop's change of viewpoint; the
        reference's is trained offline (cSystem.cpp:60-63)."""
        if self._vocabulary_path or self._voc_retrained:
            return
        if self.map.kf_features[kf] is None:
            return
        self._voc_corpus.append(self._kf_descriptors(kf))
        if len(self._voc_corpus) < self.VOCAB_RETRAIN_KFS:
            return
        doc_ids = np.concatenate([np.full(len(d), i, np.int32)
                                  for i, d in enumerate(self._voc_corpus)])
        voc = vocab_mod.train_vocabulary(np.concatenate(self._voc_corpus, 0), k=10,
                                         levels=4, doc_ids=doc_ids).to(self.device)
        # the tracker reads the vocabulary on its own stream
        self._stream_sync()
        self.loop_closer.set_vocabulary(voc)
        self._voc_retrained = True
        self._voc_corpus.clear()

    def _process_kf(self, kf: int):
        t0 = time.perf_counter()
        self.mapper.process_keyframe(kf)
        self.mapping_ms.append((time.perf_counter() - t0) * 1e3)
        # the pass moved the map: the tracker's snapshot cache is stale
        self.tracker.map_dirty = True
        if self._enable_loops:
            self._ensure_loop_closer(kf)
            self._maybe_retrain_vocabulary(kf)
            self.loop_closer.insert_keyframe(kf)

    # -- async mapping ---------------------------------------------------

    def _stream_sync(self):
        """Wait for this thread's stream (a no-op on the CPU)."""
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()

    def _share_with_mapper(self, kf: int):
        """Keyframe kf's features, made on the tracker's stream, are read
        on the mapper's: ``record_stream`` keeps the caching allocator from
        reusing their memory while the mapper's stream may still read it."""
        for t in self.map.kf_features[kf]:
            t.record_stream(self._mapper_stream)

    def _enqueue_kf(self, kf: int):
        """Hand keyframe kf to the mapper thread; on the card an event
        after its features orders the mapper's stream behind them."""
        if self._mapper_stream is not None:
            self._share_with_mapper(kf)
            ev = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(self.device))
            self._kf_ready[kf] = ev
        self._kf_queue.put(kf)

    def _request_ba_interrupt(self):
        self._interrupt_ba = True

    def _process_init_kfs(self, kf0: int, kf1: int):
        # the bootstrap keyframes are mapped inline; under async mapping
        # the mapper's stream reads their features later, and the local
        # BA's next buckets are captured here, not on the mapper's thread
        # beside the tracker's frames
        if self._mapper_stream is not None:
            self._share_with_mapper(kf0)
            self._share_with_mapper(kf1)
        self._process_kf(kf0)
        self._process_kf(kf1)
        if self._mapper_thread is not None:
            self.mapper.capture_ahead()

    def _mapper_loop(self):
        """The mapper thread: a mapping pass and the loop closer's
        insertion per queued keyframe, on the mapper's stream, until the
        shutdown sentinel. The pass's device work is finished before the
        keyframe counts as done. A failure is kept for the tracking thread
        to raise; later keyframes are still consumed, so no wait hangs."""
        on_stream = (torch.cuda.stream(self._mapper_stream)
                     if self._mapper_stream is not None else contextlib.nullcontext())
        with on_stream:
            while True:
                kf = self._kf_queue.get()
                try:
                    if kf is None:          # shutdown sentinel
                        return
                    ev = self._kf_ready.pop(kf, None)
                    if ev is not None:
                        torch.cuda.current_stream(self.device).wait_event(ev)
                    if self._mapper_error is None:
                        self._mapper_busy.set()
                        try:
                            self._process_kf(kf)
                            self._stream_sync()
                        except Exception as exc:    # raised on the tracking thread
                            self._mapper_error = exc
                        finally:
                            self._mapper_busy.clear()
                finally:
                    self._interrupt_ba = False
                    self._kf_queue.task_done()

    def _raise_mapper_error(self):
        """Raise a failure of the mapper thread on the calling thread."""
        err, self._mapper_error = self._mapper_error, None
        if err is not None:
            raise RuntimeError("the mapper thread failed") from err

    # ------------------------------------------------------------------

    def track(self, images, timestamp: float) -> Optional[np.ndarray]:
        """cSystem::TrackMultiColSLAM: one synchronized image set (C, H, W);
        returns the body pose (4, 4) or None while not tracking. Raises a
        failure of the mapper thread."""
        self._raise_mapper_error()
        M = self.tracker.track(images, timestamp)
        if self.keep_last_frame:
            # the frame publisher's snapshot (cMultiFramePublisher::Update):
            # a viewer draws from it, never from the tracker's live state
            tr = self.tracker
            self.last_frame = (images, tr.cur_feats,
                               None if tr.cur_pt is None else tr.cur_pt.copy(),
                               tr.state.name)
        return M

    def track_batch(self, images, timestamps, chunk: int = 8) -> list:
        """Track B consecutive frames, in chunks of ``chunk`` steady-state
        frames where ``Tracker.track_chunk`` accepts them (one fetch a
        chunk), and per frame (``track``) for the frame that
        broke a chunk, wherever the chunk's preconditions fail
        (initialization, relocalization) and where fewer than ``chunk``
        frames are left. The throughput mode; ``track`` is the latency
        mode. ``images``: (B, C, H, W), a tensor (slices stay on its
        device) or numpy; ``timestamps``: B floats. Returns B entries, a
        (4, 4) body pose or None."""
        n = int(images.shape[0])
        if len(timestamps) != n:
            raise ValueError(f"{len(timestamps)} timestamps for {n} frames")
        self._raise_mapper_error()
        out: list = []
        i = 0
        while i < n:
            if n - i >= chunk:
                r = self.tracker.track_chunk(images[i:i + chunk],
                                             list(timestamps[i:i + chunk]))
                if r is not None:
                    acc, poses = r
                    out.extend(poses)
                    i += acc
                    if acc == chunk:
                        continue
                    # the frame that broke the chunk runs per frame
            out.append(self.track(images[i], timestamps[i]))
            i += 1
        return out

    def attach_viewer(self, out_dir: str = ".", period_s: float = 1.0):
        """Start the live viewer (cSystem spawns cViewer::Run,
        cSystem.cpp:96-110) and return it; ``shutdown`` or its ``stop``
        ends it."""
        from ..utils.viz import Viewer
        self._viewer = Viewer(self, out_dir=out_dir, period_s=period_s)
        return self._viewer.start()

    @property
    def state(self) -> TrackState:
        return self.tracker.state

    def reset(self):
        """cSystem/cTracking::Reset (cTracking.cpp:1327-1375)."""
        self.tracker.reset()

    def shutdown(self):
        """cSystem::Shutdown: stop the viewer, let the mapper thread finish
        the queued keyframes and join it (cSystem.cpp:242-258). Raises if
        the join times out or the mapper thread failed."""
        if self._viewer is not None:
            self._viewer.stop()
            self._viewer = None
        if self._mapper_thread is not None:
            self._kf_queue.put(None)
            self._mapper_thread.join(timeout=120)
            if self._mapper_thread.is_alive():
                raise RuntimeError("the mapper thread did not stop within 120 s")
            self._mapper_thread = None
            if self._mapper_stream is not None:
                graphs.release_stream(self._mapper_stream)
                self._mapper_stream = None
        self._raise_mapper_error()

    def save_trajectory(self, path: str):
        """cSystem::SaveMKFTrajectoryLAFIDA (TUM format)."""
        save_tum(path, self.tracker.timestamps, self.tracker.all_poses)

    def global_bundle_adjustment(self, iters: int = 10) -> float:
        """cOptimizer::GlobalBundleAdjustment (cOptimizer.cpp:57-257): joint
        LM over every keyframe pose and point, the first keyframe fixed as
        the gauge, on one device or sharded over a mesh of cards (on the
        card CUDA graphs in the shared pool, on the caller's thread); then
        the points' viewing rays and distance ranges are refreshed. Returns
        the final summed chi2."""
        m = self.map
        kfs = m.keyframe_ids().tolist()
        if len(kfs) < 2:
            return 0.0
        cost = run_global_ba(self.rig, m, [min(kfs)], self.settings.scale_factor,
                             iters=iters, bundle_adjust=self._global_adjust,
                             pool=graphs.SHARED)
        if cost < 0:
            return 0.0
        m.update_point_stats(np.nonzero(m.pt_valid)[0].astype(np.int64),
                             self.tracker._M_c_np, self.settings.scale_factor,
                             self.settings.n_levels)
        return cost
