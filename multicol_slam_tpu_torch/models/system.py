"""System orchestration (cSystem.{h,cpp}): tracking wired to local mapping,
calibration loading, the per-frame API and trajectory export.

Port of ``multicol_slam_tpu/models/system.py`` in its synchronous form:
the mapper runs on keyframe insertion, in the tracking thread. Loop
closing, the asynchronous mapper, ``track_batch``, the viewer and global
BA are not ported yet (ROADMAP queue 1); asking for them raises.
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from ..ops.camera import make_extraction_masks
from ..ops.pyramid import level_sizes
from ..utils import config_io
from ..utils.trajectory import save_tum
from . import matcher
from .extractor import ExtractorConfig, Features, make_extractor
from .local_mapping import LocalMapper
from .map import MapStore
from .tracking import Tracker, TrackerConfig, TrackState


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
        if async_mapping:
            raise NotImplementedError(
                "async_mapping=True is not ported yet (ROADMAP queue 1, item "
                "7): pass async_mapping=False to map synchronously")
        if enable_loop_closing:
            raise NotImplementedError(
                "loop closing is not ported yet (ROADMAP queue 1, item 9): "
                "pass enable_loop_closing=False")
        if vocabulary_path is not None:
            raise NotImplementedError(
                "vocabularies serve loop closing, which is not ported yet: "
                "leave vocabulary_path unset")
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

        if s.use_mdbrief or s.use_agast:
            raise NotImplementedError(
                "dBRIEF/mdBRIEF and AGAST are not ported yet (ROADMAP queue 1, "
                "item 2): use ORB with FAST (use_mdbrief=False, use_agast=False)")
        ecfg = ExtractorConfig(
            n_features=s.n_features, scale_factor=s.scale_factor,
            n_levels=s.n_levels, fast_th=s.fast_th, desc_bytes=s.desc_size,
            use_harris=s.score_harris)
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
        # wall clock of each local-mapping pass, ms
        self.mapping_ms: list[float] = []
        self.tracker.on_new_keyframe = self._process_kf
        # the two bootstrap keyframes are mapped inline (cTracking::
        # CreateInitialMap, cTracking.cpp:439-722)
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

    def _on_reset(self):
        """Reset fan-out (cTracking::Reset clears the mapper,
        cTracking.cpp:1327-1375), on both an explicit reset and the
        tracker's young-map reset."""
        self.mapper.reset()

    def _process_init_kfs(self, kf0: int, kf1: int):
        self._process_kf(kf0)
        self._process_kf(kf1)

    def _process_kf(self, kf: int):
        t0 = time.perf_counter()
        self.mapper.process_keyframe(kf)
        self.mapping_ms.append((time.perf_counter() - t0) * 1e3)
        # the pass moved the map: the tracker's snapshot cache is stale
        self.tracker.map_dirty = True

    # ------------------------------------------------------------------

    def track(self, images, timestamp: float) -> Optional[np.ndarray]:
        """cSystem::TrackMultiColSLAM: one synchronized image set (C, H, W);
        returns the body pose (4, 4) or None while not tracking."""
        return self.tracker.track(images, timestamp)

    def track_batch(self, images, timestamps, chunk: int = 8):
        raise NotImplementedError(
            "track_batch is not ported yet (ROADMAP queue 1, item 10): call "
            "track() per frame")

    @property
    def state(self) -> TrackState:
        return self.tracker.state

    def reset(self):
        """cSystem/cTracking::Reset (cTracking.cpp:1327-1375)."""
        self.tracker.reset()

    def shutdown(self):
        """cSystem::Shutdown; synchronous mapping leaves nothing running."""

    def save_trajectory(self, path: str):
        """cSystem::SaveMKFTrajectoryLAFIDA (TUM format)."""
        save_tum(path, self.tracker.timestamps, self.tracker.all_poses)
