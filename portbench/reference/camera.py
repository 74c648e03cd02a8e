"""Frozen copy of the port's ``multicol_slam_tpu_torch/ops/camera.py``
(the plain extraction chain), kept here so that the benchmark's reference
imports nothing of the program. Do not edit: it is the yardstick.

Scaramuzza omnidirectional camera model on tensors.

Port of ``multicol_slam_tpu/ops/camera.py`` (reference cam_model_omni.cpp:
ImgToWorld :29-87, WorldToImg :90-161, mirror masks :181-220;
undistort/distortPointsOcam cam_model_omni.h:127-145). A rig is
one ``CameraModel`` whose fields lead with the camera axis; the
projection functions broadcast the fields against the points, so
``expand`` lines a batched camera up with (C, ...) point tensors in place
of the JAX package's ``vmap``.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np
import torch


POLY_PAD = 8
INVPOLY_PAD = 16
MIRROR_OFFSETS = (22.0, 10.0, 5.0, 1.0)


class CameraModel(NamedTuple):
    """Scaramuzza parameters as tensors; batches over leading dims."""

    c: torch.Tensor
    d: torch.Tensor
    e: torch.Tensor
    u0: torch.Tensor
    v0: torch.Tensor
    poly: torch.Tensor       # (..., POLY_PAD) forward poly, zero padded
    inv_poly: torch.Tensor   # (..., INVPOLY_PAD) inverse poly, zero padded
    width: torch.Tensor
    height: torch.Tensor
    mirror: torch.Tensor     # 1.0 = fisheye circle applies, 0.0 = full image

    @property
    def inv_affine(self) -> torch.Tensor:
        return self.c - self.d * self.e

    @property
    def p1(self) -> torch.Tensor:
        """First forward poly coefficient a0 (cam_model_omni.h:100)."""
        return self.poly[..., 0]

    def to_vector17(self) -> torch.Tensor:
        """[c, d, e, u0, v0, inv_poly[:12]] (..., 17): the 17 intrinsics
        bundle adjustment refines (cam_model_omni.h:189-204 toVector)."""
        return torch.cat([torch.stack([self.c, self.d, self.e, self.u0, self.v0], -1),
                          self.inv_poly[..., :12]], -1)

    def with_vector17(self, v: torch.Tensor) -> "CameraModel":
        """A new model carrying ``v``'s 17 intrinsics; this model's
        ``inv_poly`` is not written (a fresh tensor, as JAX's ``.at[].set``)."""
        inv_poly = torch.cat([v[..., 5:17].to(self.inv_poly.dtype),
                              self.inv_poly[..., 12:]], -1)
        return self._replace(c=v[..., 0], d=v[..., 1], e=v[..., 2], u0=v[..., 3],
                             v0=v[..., 4], inv_poly=inv_poly)

    def to(self, device) -> "CameraModel":
        return CameraModel(*(f.to(device) for f in self))

    def index(self, i) -> "CameraModel":
        """Select cameras along the leading axis (an int or an index tensor)."""
        return CameraModel(*(f[i] for f in self))

    def expand(self, extra: int) -> "CameraModel":
        """Append ``extra`` unit dims after the camera axis so the fields
        broadcast against (C, d1, .., d_extra) point tensors."""
        def one(f, vec):
            lead = f.shape[:-1] if vec else f.shape
            shape = tuple(lead) + (1,) * extra + (tuple(f.shape[-1:]) if vec else ())
            return f.reshape(shape)
        return CameraModel(*(one(f, name in ("poly", "inv_poly"))
                             for name, f in zip(self._fields, self)))


def make_camera(c, d, e, u0, v0, poly, inv_poly, width, height,
                dtype=torch.float32, mirror: bool = True,
                device=None) -> CameraModel:
    """Build a CameraModel from scalars and coefficient lists."""
    p = np.zeros(POLY_PAD, np.float64)
    p[: len(poly)] = np.asarray(poly, np.float64)
    ip = np.zeros(INVPOLY_PAD, np.float64)
    ip[: len(inv_poly)] = np.asarray(inv_poly, np.float64)
    arr = lambda x: torch.as_tensor(np.asarray(x, np.float64), dtype=dtype,
                                    device=device)
    return CameraModel(
        c=arr(c), d=arr(d), e=arr(e), u0=arr(u0), v0=arr(v0),
        poly=arr(p), inv_poly=arr(ip), width=arr(width), height=arr(height),
        mirror=arr(1.0 if mirror else 0.0),
    )


def stack_cameras(cams: Sequence[CameraModel]) -> CameraModel:
    """Stack N CameraModels into one with a leading camera axis."""
    return CameraModel(*(torch.stack(fs, 0) for fs in zip(*cams)))


def scale_camera(cam: CameraModel, k: float) -> CameraModel:
    """The same camera at a k-times image resolution: a_i' = a_i k^(1-i),
    inverse poly and principal point scale by k (rays stay identical).
    The arithmetic runs in float64 and rounds once, like the reference."""
    k = float(k)
    f64 = lambda t: t.detach().cpu().double().numpy()
    poly = f64(cam.poly)
    exps = np.arange(poly.shape[-1], dtype=np.float64)
    poly = poly * k ** (1.0 - exps)
    dtype, device = cam.c.dtype, cam.c.device
    arr = lambda x: torch.as_tensor(x, dtype=dtype, device=device)
    return cam._replace(
        u0=arr(f64(cam.u0) * k), v0=arr(f64(cam.v0) * k), poly=arr(poly),
        inv_poly=arr(f64(cam.inv_poly) * k),
        width=arr(np.rint(f64(cam.width) * k)),
        height=arr(np.rint(f64(cam.height) * k)),
    )


def img_to_world(cam: CameraModel, uv: torch.Tensor) -> torch.Tensor:
    """Pixel (..., 2) -> unit bearing ray (..., 3) (cam_model_omni.cpp:49-67)."""
    u_t = uv[..., 0] - cam.u0
    v_t = uv[..., 1] - cam.v0
    inv_aff = cam.inv_affine
    x = (u_t - cam.d * v_t) / inv_aff
    y = (-cam.e * u_t + cam.c * v_t) / inv_aff
    rho = torch.sqrt(x * x + y * y)
    z = -horner(cam.poly, rho)
    X = torch.stack([x, y, z], -1)
    return X / torch.linalg.norm(X, dim=-1, keepdim=True)


def world_to_img(cam: CameraModel, X: torch.Tensor) -> torch.Tensor:
    """Camera-frame point (..., 3) -> pixel (..., 2) (cam_model_omni.cpp:146-161)."""
    x, y, z = X[..., 0], X[..., 1], X[..., 2]
    norm = torch.sqrt(x * x + y * y)
    norm = torch.where(norm == 0.0, torch.full_like(norm, 1e-14), norm)
    theta = torch.atan2(-z, norm)
    rho = horner(cam.inv_poly, theta)
    uu = x / norm * rho
    vv = y / norm * rho
    u = uu * cam.c + vv * cam.d + cam.u0
    v = uu * cam.e + vv + cam.v0
    return torch.stack([u, v], -1)


def undistort_points(cam: CameraModel, uv: torch.Tensor, scale) -> torch.Tensor:
    """Pixel (..., 2) -> ideal-plane point -x/z*s, -y/z*s
    (cam_model_omni.h:127-138). ``scale`` broadcasts against uv[..., :1]."""
    X = img_to_world(cam, uv)
    return -X[..., :2] / X[..., 2:3] * scale


def distort_points(cam: CameraModel, xy: torch.Tensor) -> torch.Tensor:
    """Ideal-plane point (..., 2) -> pixel: WorldToImg(x, y, -p1)
    (cam_model_omni.h:140-145)."""
    z = torch.broadcast_to(-cam.p1, xy[..., 0].shape)
    return world_to_img(cam, torch.stack([xy[..., 0], xy[..., 1], z], -1))


def make_mirror_masks(cam_u0: float, cam_v0: float, width: int, height: int,
                      n_levels: int = 4) -> list[np.ndarray]:
    """Per-level circular masks (uint8 0/255) at pyrDown sizes, with the
    reference's u0/v0 naming swap (cam_model_omni.cpp:185-217)."""
    masks = []
    u0 = float(cam_v0)
    v0 = float(cam_u0)
    w, h = int(width), int(height)
    for lvl in range(n_levels):
        if lvl != 0:
            w = (w + 1) // 2
            h = (h + 1) // 2
            u0 = float(np.ceil(u0 / 2.0))
            v0 = float(np.ceil(v0 / 2.0))
        ii, jj = np.mgrid[0:h, 0:w].astype(np.float32)
        ans = np.sqrt((ii - u0) ** 2 + (jj - v0) ** 2)
        masks.append(np.where(ans < (u0 + MIRROR_OFFSETS[min(lvl, 3)]),
                              255, 0).astype(np.uint8))
    return masks


def make_extraction_masks(cam_u0: float, cam_v0: float, width: int,
                          height: int, n_levels: int,
                          scale: float) -> list[np.ndarray]:
    """Mirror masks at the extraction pyramid's sizes: the level-0 circle
    (centre swapped per the CreateMirrorMask quirk, radius Get_v0 + 22,
    cam_model_omni.cpp:187-188) scaled by 1/scale^level."""
    from .pyramid import level_sizes

    cy = float(cam_v0)
    cx = float(cam_u0)
    r0 = cy + MIRROR_OFFSETS[0]
    masks = []
    for lvl, (h, w) in enumerate(level_sizes(height, width, n_levels, scale)):
        s = 1.0 / (scale ** lvl)
        ii, jj = np.mgrid[0:h, 0:w].astype(np.float32)
        d = np.sqrt((ii - cy * s) ** 2 + (jj - cx * s) ** 2)
        masks.append((d < r0 * s).astype(np.uint8) * 255)
    return masks


def is_in_mirror_mask(mask: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """isPointInMirrorMask (cam_model_omni.cpp:163-178) for pixel
    coordinates uv (..., 2) against an (H, W) uint8 mask: rounded half to
    even (cvRound), inside 0 < u < W, 0 < v < H, and the mask set there."""
    h, w = mask.shape
    ur = torch.round(uv[..., 0]).to(torch.int64)
    vr = torch.round(uv[..., 1]).to(torch.int64)
    in_bounds = (ur > 0) & (ur < w) & (vr > 0) & (vr < h)
    return in_bounds & (mask[vr.clamp(0, h - 1), ur.clamp(0, w - 1)] > 0)


def horner(coeffs: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """sum_i coeffs[..., i] * x^i, lowest order first (a copy of
    ``ops/geometry.py::horner``)."""
    cs = coeffs.unbind(-1)
    res = torch.zeros_like(x) + cs[-1]
    for c in cs[-2::-1]:
        res = res * x + c
    return res
