"""Synthetic multi-fisheye frames and a ground-truth map for the WORKING
frame.

Port of the plain-room parts of ``multicol_slam_tpu/utils/synthetic.py``:
a procedurally textured cubic room (the same 64^3 value-noise lattice
from the same numpy seed) seen through the rig along a smooth arc. Walls,
fins, distractors and the place-texture layer are not ported.
``gt_bootstrap`` lifts a frame's keypoints to their wall points at the
true pose, the map the WORKING frame tracks against when mapping is not
in the loop.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..ops import camera as cam_ops
from ..ops.geometry import hom2cayley
from ..ops.rig import Rig, mt_mc

ROOM_HALF = 4.0     # half-extent of the cubic room (meters)
LATTICE = 64        # noise lattice resolution


@functools.lru_cache()
def _lattice(seed: int = 7) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.uniform(40.0, 220.0, (LATTICE, LATTICE, LATTICE)).astype(np.float32)


def _texture3d(pts: torch.Tensor, lat: torch.Tensor) -> torch.Tensor:
    """Trilinear 3-D value noise at world points (..., 3) -> (...,): a
    coarse octave, a fine corner-rich one and a quantized step layer."""
    flat = lat.reshape(-1)

    def octave(p, freq):
        q = torch.remainder((p / (2 * ROOM_HALF) + 0.5) * freq, LATTICE - 1)
        q0 = torch.floor(q)
        f = q - q0
        q0 = torch.clamp(q0.to(torch.int64), 0, LATTICE - 2)

        def at(dx, dy, dz):
            return flat[((q0[..., 0] + dx) * LATTICE + q0[..., 1] + dy) * LATTICE
                        + q0[..., 2] + dz]

        fx, fy, fz = f[..., 0], f[..., 1], f[..., 2]
        c00 = at(0, 0, 0) * (1 - fx) + at(1, 0, 0) * fx
        c01 = at(0, 0, 1) * (1 - fx) + at(1, 0, 1) * fx
        c10 = at(0, 1, 0) * (1 - fx) + at(1, 1, 0) * fx
        c11 = at(0, 1, 1) * (1 - fx) + at(1, 1, 1) * fx
        c0 = c00 * (1 - fy) + c10 * fy
        c1 = c01 * (1 - fy) + c11 * fy
        return c0 * (1 - fz) + c1 * fz

    fine = octave(pts, 97.0)
    steps = torch.where(fine > 130.0, 60.0, -60.0)
    base = (0.45 * octave(pts, 11.0) + 0.35 * octave(pts, 53.0)
            + 0.2 * fine + 30.0)
    return torch.clamp(base + steps * 0.5, 0.0, 255.0)


def _ray_box_exit(origin: torch.Tensor, direction: torch.Tensor,
                  half=(ROOM_HALF, ROOM_HALF, ROOM_HALF)) -> torch.Tensor:
    """Distance to the room wall along ``direction`` from an interior
    ``origin``: min over axes of the positive boundary hit."""
    half = torch.tensor(half, dtype=direction.dtype, device=direction.device)
    d = torch.where(direction.abs() < 1e-9, torch.full_like(direction, 1e-9),
                    direction)
    t = (torch.sign(d) * half - origin) / d
    return t.min(-1).values


def make_renderer(rig: Rig):
    """render(M_t) -> (C, H, W) float32 in [0, 255] for a (4, 4) pose, or
    (B, C, H, W) for (B, 4, 4) poses, on the rig's device. Per-pixel rays
    are computed once."""
    h = int(rig.cams.height[0])
    w = int(rig.cams.width[0])
    dev = rig.M_c.device
    vv, uu = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=dev),
                            torch.arange(w, dtype=torch.float32, device=dev),
                            indexing="ij")
    uv = torch.stack([uu, vv], -1).reshape(-1, 2)
    rays = cam_ops.img_to_world(rig.cams.expand(1), uv[None])
    rays = rays.reshape(rig.n_cams, h, w, 3)
    lat = torch.from_numpy(_lattice()).to(dev)

    def render(M_t: torch.Tensor) -> torch.Tensor:
        M_t = M_t.to(device=dev, dtype=torch.float32)
        T = torch.einsum("bij,njk->bnik", M_t.reshape(-1, 4, 4), rig.M_c)
        R = T[..., :3, :3]
        o = T[..., None, None, :3, 3]
        rays_w = torch.einsum("bnij,nhwj->bnhwi", R, rays)
        t = _ray_box_exit(o, rays_w)
        img = _texture3d(o + t[..., None] * rays_w, lat)
        img = torch.clamp(img, 0.0, 255.0)
        return img.reshape(M_t.shape[:-2] + img.shape[1:])

    return render


def smooth_trajectory(n_frames: int, radius: float = 1.0,
                      height_amp: float = 0.2) -> np.ndarray:
    """(n_frames, 4, 4) body-to-world poses: a slow arc with yaw."""
    out = np.zeros((n_frames, 4, 4))
    for i in range(n_frames):
        s = i / max(n_frames - 1, 1)
        ang = 0.9 * np.sin(2 * np.pi * s * 0.5)
        c, sn = np.cos(ang), np.sin(ang)
        R = np.array([[c, 0, sn], [0, 1, 0], [-sn, 0, c]])
        t = np.array([radius * np.sin(2 * np.pi * s * 0.5),
                      height_amp * np.sin(2 * np.pi * s),
                      radius * (np.cos(2 * np.pi * s * 0.5) - 1.0)])
        out[i, :3, :3] = R
        out[i, :3, 3] = t
        out[i, 3, 3] = 1.0
    return out


def wall_points(rig: Rig, M_t: torch.Tensor, rays: torch.Tensor):
    """Ground-truth wall point behind each bearing ray (C, K, 3) at body
    pose M_t. Returns (X (C, K, 3), camera centres (C, 3))."""
    T = mt_mc(M_t, rig.M_c)
    R, Cw = T[:, :3, :3], T[:, :3, 3]
    rays_w = torch.einsum("nij,nkj->nki", R, rays)
    t = _ray_box_exit(Cw[:, None, :], rays_w)
    return Cw[:, None, :] + t[..., None] * rays_w, Cw


def gt_bootstrap(rig: Rig, M0: torch.Tensor, feats0, n_levels: int,
                 scale_factor: float) -> dict:
    """Map and slot state for ``working_scan_chunk`` from frame-0 features
    and the true pose M0 (4, 4), the way tests/test_e2e_slice.py and
    bench.py bootstrap: every valid keypoint becomes a map point at its
    wall hit, with the unit normal from its camera, the x0.8 / x1.2
    distance range of map.py's update_point_stats, its own descriptor and
    an all-ones mask. Points are padded to cap = bucket(P, 256)."""
    from ..models.tracking import bucket

    M0 = M0.to(torch.float32)
    X, Cw = wall_points(rig, M0, feats0.ray)
    valid = feats0.valid
    C, K = valid.shape
    P = int(valid.sum())
    cap = bucket(P, 256)
    dev = X.device
    PO = X - Cw[:, None, :]
    dist = torch.linalg.norm(PO, dim=-1)
    max_d = dist * scale_factor ** feats0.level.to(torch.float32)
    min_d = max_d / scale_factor ** (n_levels - 1)

    def pack(a, fill):
        out = torch.full((cap,) + tuple(a.shape[2:]), fill, dtype=a.dtype,
                         device=dev)
        out[:P] = a[valid]
        return out

    slot_lp0 = torch.full((C, K), -1, dtype=torch.int32, device=dev)
    slot_lp0[valid] = torch.arange(P, dtype=torch.int32, device=dev)
    cand_base = torch.zeros(cap, dtype=torch.bool, device=dev)
    cand_base[:P] = True
    return dict(
        last=feats0,
        slot_X0=torch.where(valid[..., None], X, torch.zeros_like(X)),
        slot_lp0=slot_lp0, slot_has0=valid.clone(),
        X=pack(X, 0.0), normal=pack(PO / dist[..., None], 0.0),
        mind=pack(min_d * 0.8, 0.0), maxd=pack(max_d * 1.2, 1.0),
        cand_base=cand_base, pt_desc=pack(feats0.desc, 0),
        pt_mask=pack(torch.full_like(feats0.desc, -1), 0),
        mt0=hom2cayley(M0), V0=torch.eye(4, dtype=torch.float32, device=dev),
        P=P)
