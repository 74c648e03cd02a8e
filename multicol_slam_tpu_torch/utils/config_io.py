"""Config IO: OpenCV-FileStorage-style YAML and typed SLAM settings.

Port of ``multicol_slam_tpu/utils/config_io.py`` (reference
cSystem::LoadMCS, cSystem.cpp:125-180, and the settings parsing of
cTracking.cpp:87-165).
"""

from __future__ import annotations

import dataclasses
import os
import re
from typing import Dict, List

import numpy as np
import torch

from ..ops.camera import CameraModel, make_camera, make_mirror_masks, stack_cameras
from ..ops.rig import rig_from_cayley

# The in-repo synthetic rig (tools/make_synth_rig.py writes it).
SYNTH_RIG_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "data", "synth_rig3")


def load_opencv_yaml(path: str) -> Dict[str, float]:
    """Parse a flat cv::FileStorage YAML of scalar ``key: value`` entries."""
    out: Dict[str, float] = {}
    pat = re.compile(r"^\s*([A-Za-z0-9_.]+)\s*:\s*(\S+)")
    with open(path) as f:
        for line in f:
            if line.lstrip().startswith(("%", "#")):
                continue
            m = pat.match(line)
            if not m:
                continue
            key, val = m.group(1), m.group(2)
            try:
                out[key] = float(val)
            except ValueError:
                out[key] = val
    return out


@dataclasses.dataclass(frozen=True)
class SlamSettings:
    fps: float = 25.0
    rgb: bool = True
    use_mdbrief: bool = False
    learn_masks: bool = False
    use_agast: bool = False
    fast_agast_type: int = 2
    desc_size: int = 32
    n_features: int = 400
    scale_factor: float = 1.2
    n_levels: int = 8
    fast_th: int = 20
    score_harris: bool = True
    use_motion_model: bool = True
    start_frame: int = 0
    end_frame: int = -1

    # keyframe rates derived from fps (cTracking.cpp:93-94)
    @property
    def min_frames(self) -> int:
        return int(self.fps / 3.0)

    @property
    def max_frames(self) -> int:
        return int(2.0 * self.fps / 3.0)


def load_settings(path: str) -> SlamSettings:
    """Slam_Settings_*.yaml -> SlamSettings (cTracking.cpp:87-165)."""
    d = load_opencv_yaml(path)
    g = lambda k, dflt: d.get(k, dflt)
    return SlamSettings(
        fps=float(g("Camera.fps", 25.0)),
        rgb=bool(int(g("Camera.RGB", 1))),
        use_mdbrief=bool(int(g("extractor.usemdBRIEF", 0))),
        learn_masks=bool(int(g("extractor.masks", 0))),
        use_agast=bool(int(g("extractor.useAgast", 0))),
        fast_agast_type=int(g("extractor.fastAgastType", 2)),
        desc_size=int(g("extractor.descSize", 32)),
        n_features=int(g("extractor.nFeatures", 400)),
        scale_factor=float(g("extractor.scaleFactor", 1.2)),
        n_levels=int(g("extractor.nLevels", 8)),
        fast_th=int(g("extractor.fastTh", 20)),
        score_harris=int(g("extractor.nScoreType", 0)) == 0,
        use_motion_model=bool(int(g("UseMotionModel", 1))),
        start_frame=int(g("traj.StartFrame", 0)),
        end_frame=int(g("traj.EndFrame", -1)),
    )


def load_interior_orientation(path: str, dtype=torch.float32) -> tuple[CameraModel, bool]:
    """One InteriorOrientationFisheye{c}.yaml -> (CameraModel, mirror flag)."""
    d = load_opencv_yaml(path)
    n_pol = int(d["Camera.nrpol"])
    n_inv = int(d["Camera.nrinvpol"])
    want_mask = bool(int(d.get("Camera.mirrorMask", 0)))
    cam = make_camera(
        c=d["Camera.c"], d=d["Camera.d"], e=d["Camera.e"],
        u0=d["Camera.u0"], v0=d["Camera.v0"],
        poly=[d[f"Camera.a{i}"] for i in range(n_pol)],
        inv_poly=[d[f"Camera.pol{i}"] for i in range(n_inv)],
        width=d["Camera.Iw"], height=d["Camera.Ih"], dtype=dtype,
        mirror=want_mask)
    return cam, want_mask


def load_mcs(calib_dir: str, dtype=torch.float32, n_mask_levels: int = 4):
    """Load a rig: MultiCamSys_Calibration.yaml + InteriorOrientationFisheye
    {c}.yaml. Returns (Rig on the CPU, per-level (N, H_l, W_l) uint8 masks).
    A loader, not an entry point: it stays on the CPU, where the tests hold
    the port against the JAX package; ``MultiColSLAM`` moves the rig onto
    its device, the card by default."""
    d = load_opencv_yaml(os.path.join(calib_dir, "MultiCamSys_Calibration.yaml"))
    n_cams = int(d["CameraSystem.nrCams"])
    m_c_min = np.zeros((n_cams, 6), np.float64)
    for c in range(n_cams):
        for p in range(6):
            m_c_min[c, p] = d[f"CameraSystem.cam{c + 1}_{p + 1}"]

    cams: List[CameraModel] = []
    masks_per_cam = []
    for c in range(n_cams):
        cam, want_mask = load_interior_orientation(
            os.path.join(calib_dir, f"InteriorOrientationFisheye{c}.yaml"), dtype)
        cams.append(cam)
        w, h = int(cam.width), int(cam.height)
        if want_mask:
            masks_per_cam.append(make_mirror_masks(float(cam.u0), float(cam.v0),
                                                   w, h, n_mask_levels))
        else:
            ones = []
            for lvl in range(n_mask_levels):
                if lvl:
                    w, h = (w + 1) // 2, (h + 1) // 2
                ones.append(np.full((h, w), 255, np.uint8))
            masks_per_cam.append(ones)

    np_dtype = torch.empty((), dtype=dtype).numpy().dtype
    rig = rig_from_cayley(m_c_min.astype(np_dtype), stack_cameras(cams))
    masks_by_level = [np.stack([masks_per_cam[c][lvl] for c in range(n_cams)], 0)
                      for lvl in range(n_mask_levels)]
    return rig, masks_by_level
