"""Multi-camera rig: body pose x fixed extrinsics x camera models.

Port of ``multicol_slam_tpu/ops/rig.py`` (reference cam_system_omni.h:
54-199). ``M_t`` maps body to world and ``M_c[c]`` camera to body, so a
world point projects into camera c via ``(M_t M_c)^-1 X``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import camera as cam_ops
from .camera import CameraModel
from .geometry import cayley2hom, hom2cayley


class Rig(NamedTuple):
    """Calibrated multi-camera system (no pose). Leading camera axis N."""

    M_c: torch.Tensor        # (N, 4, 4) camera-to-body extrinsics
    cams: CameraModel        # batched camera models, leading dim N

    @property
    def n_cams(self) -> int:
        return self.M_c.shape[0]

    @property
    def M_c_min(self) -> torch.Tensor:
        """(N, 6) cayley+t minimal extrinsics."""
        return hom2cayley(self.M_c)

    def to(self, device) -> "Rig":
        return Rig(M_c=self.M_c.to(device), cams=self.cams.to(device))


def rig_from_cayley(M_c_min, cams: CameraModel) -> Rig:
    """Rig from (N, 6) minimal extrinsics (cSystem.cpp:129-144), built in
    the input's dtype on the cameras' device."""
    return Rig(M_c=cayley2hom(torch.as_tensor(M_c_min, device=cams.c.device)),
               cams=cams)


def scale_rig(rig: Rig, k: float) -> Rig:
    """Rig with every camera rescaled to a k-times image resolution."""
    return rig._replace(cams=cam_ops.scale_camera(rig.cams, k))


def mt_mc(M_t: torch.Tensor, M_c: torch.Tensor) -> torch.Tensor:
    """(4,4) x (N,4,4) -> (N,4,4) composed camera-to-world."""
    return torch.einsum("ij,njk->nik", M_t, M_c)
