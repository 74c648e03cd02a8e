"""The system under test: ``multicol_slam_tpu_torch.MultiColSLAM`` built
from a configuration's files, fed by the traffic, read through its own
counters. The only module of the benchmark that imports the program."""

from __future__ import annotations

import numpy as np
import torch


class System:
    """One ``MultiColSLAM`` on the card at a configuration's settings,
    calibration and system options (``config.json``'s ``system``)."""

    def __init__(self, config, device):
        from multicol_slam_tpu_torch.models.system import MultiColSLAM

        self.device = torch.device(device)
        self.slam = MultiColSLAM(calib_dir=config.dir, settings_path=config.settings_path,
                                 device=self.device, **config.system)
        # each keyframe the system allocated: (frame id, its features on
        # the device), read after every call, before culling can drop them
        self.keyframes: list[tuple[int, object]] = []
        self._seen_kf = 0
        self.fed = 0

    def feed(self, api: str, images: torch.Tensor, timestamps: list, chunk: int) -> list:
        """One call of ``api`` on (B, C, H, W) uint8 frames; the B poses
        (4, 4) or None, the card synchronised."""
        if api == "track_batch":
            out = self.slam.track_batch(images, timestamps, chunk=chunk)
        elif api == "track":
            out = [self.slam.track(images[i], timestamps[i]) for i in range(len(timestamps))]
        else:
            raise ValueError(f"unknown api {api!r}")
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.fed += len(timestamps)
        if self.slam.tracker.frame_id != self.fed - 1:
            raise RuntimeError(f"the tracker counts frame {self.slam.tracker.frame_id} after "
                               f"{self.fed} frames fed")
        m = self.slam.map
        while self._seen_kf < m._next_kf:
            kf = self._seen_kf
            feats = m.kf_features[kf]
            if feats is not None:
                self.keyframes.append((int(m.kf_frame_id[kf]), feats))
            self._seen_kf += 1
        return out

    @property
    def frame_id(self) -> int:
        return self.slam.tracker.frame_id

    def counters(self) -> dict:
        """The program's counters, as plain copies: the tracker's stage
        seconds, its chunk scans (frames, seconds, captured), its frame
        paths and late captures, the mapping passes' ms, the graph
        captures and replays."""
        from multicol_slam_tpu_torch.utils import graphs

        tr = self.slam.tracker
        g = graphs.stats()
        return dict(
            timers={k: list(v) for k, v in tr.timers.samples.items()},
            chunk_scans=list(tr.chunk_scans), frame_path=list(tr.frame_path),
            late_captures=list(tr.late_captures), mapping_ms=list(self.slam.mapping_ms),
            captures=int(g["captures"]), replays=int(g["replays"]),
            keyframes=int(self.slam.map.n_keyframes()), points=int(self.slam.map.n_points()))

    def span_targets(self) -> list:
        """(object, attribute, span) of each call into a layer that the
        traced run wraps in a span: the system's entries, the tracker's
        chunk scan, frame, relocalization and keyframe insertion, a local
        mapping pass and the loop closer's insertion."""
        s, tr = self.slam, self.slam.tracker
        return [(s, "track_batch", "system.track_batch"), (s, "track", "system.track"),
                (tr, "track_chunk", "tracker.chunk"), (tr, "track", "tracker.frame"),
                (tr, "_relocalize", "tracker.relocalize"),
                (tr, "_create_new_keyframe", "tracker.new_keyframe"),
                (s.mapper, "process_keyframe", "local_mapping.pass"),
                (s.loop_closer, "insert_keyframe", "loop_closing.insert")]

    def map_points(self) -> np.ndarray:
        """(N, 3) float64 positions of the map's live landmarks."""
        m = self.slam.map
        return np.asarray(m.pt_pos[np.nonzero(m.pt_valid)[0]], np.float64)

    def shutdown(self):
        self.slam.shutdown()

