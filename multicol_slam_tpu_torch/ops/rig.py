"""Multi-camera rig: body pose x fixed extrinsics x camera models.

Port of ``multicol_slam_tpu/ops/rig.py`` (reference cam_system_omni.h:
54-199). ``M_t`` maps body to world and ``M_c[c]`` camera to body, so a
world point projects into camera c via ``(M_t M_c)^-1 X``. The batched
helpers lead with the camera axis N, as the JAX package's ``vmap`` over
cameras does.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import torch

from . import camera as cam_ops
from .camera import CameraModel
from .geometry import cayley2hom, hom2cayley, inv_se3


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


def make_rig(M_c_list: Sequence, cams: Sequence[CameraModel]) -> Rig:
    """Rig from per-camera (4, 4) extrinsics and single-camera models, on
    the cameras' device."""
    dev = cams[0].c.device
    return Rig(M_c=torch.stack([torch.as_tensor(m, device=dev) for m in M_c_list], 0),
               cams=cam_ops.stack_cameras(cams))


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


def world_to_cam_frame(M_t: torch.Tensor, M_c: torch.Tensor,
                       X_w: torch.Tensor) -> torch.Tensor:
    """World points (..., 3) -> (N, ..., 3) in each camera's frame,
    X_cam = (M_t M_c)^-1 X_w (cam_system_omni.h:104-106)."""
    T = inv_se3(mt_mc(M_t, M_c))
    Xc = torch.einsum("nij,...j->n...i", T[:, :3, :3], X_w)
    return Xc + T[:, :3, 3].reshape((T.shape[0],) + (1,) * (X_w.dim() - 1) + (3,))


def world_to_img_rig(rig: Rig, M_t: torch.Tensor, X_w: torch.Tensor):
    """World points (..., 3) projected into every camera: (uv (N, ..., 2),
    z > 0 per camera (N, ...))."""
    Xc = world_to_cam_frame(M_t, rig.M_c, X_w)
    uv = cam_ops.world_to_img(rig.cams.expand(X_w.dim() - 1), Xc)
    return uv, Xc[..., 2] > 0.0


def img_to_world_rig(rig: Rig, uv: torch.Tensor) -> torch.Tensor:
    """Per-camera pixels (N, ..., 2) -> unit rays in each camera's frame."""
    return cam_ops.img_to_world(rig.cams.expand(uv.dim() - 2), uv)


def rays_to_body(rig: Rig, rays_cam: torch.Tensor) -> torch.Tensor:
    """Per-camera rays (N, ..., 3) rotated into the body frame by M_c."""
    return torch.einsum("nij,n...j->n...i", rig.M_c[:, :3, :3], rays_cam)


def cam_centers_world(M_t: torch.Tensor, M_c: torch.Tensor) -> torch.Tensor:
    """(N, 3) optical centres in the world frame: (M_t M_c)[:, :3, 3]."""
    return mt_mc(M_t, M_c)[:, :3, 3]
