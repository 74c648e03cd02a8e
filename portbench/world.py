"""The rendered world the traffic is made in: the rig read from a
configuration's calibration files, the textured room, and the renderer.

A frozen copy of the port's ``utils/synthetic.py`` renderer, the room
alone (its interior walls, moving spheres and place texture left out),
with one change: the rays come from the benchmark's own copy of the
camera model, and the lattice's seed is a parameter of the mix. The
program never sees any of this: it receives only the images.
"""

from __future__ import annotations

import os
import re

import numpy as np
import torch

from .reference import camera as cam_ops

ROOM_HALF = 4.0     # half-extent of the cubic room (meters)
LATTICE = 64        # noise lattice resolution


def load_opencv_yaml(path: str) -> dict:
    """A flat cv::FileStorage YAML of scalar ``key: value`` entries."""
    out: dict = {}
    pat = re.compile(r"^\s*([A-Za-z0-9_.]+)\s*:\s*(\S+)")
    with open(path) as f:
        for line in f:
            if line.lstrip().startswith(("%", "#")):
                continue
            m = pat.match(line)
            if not m:
                continue
            try:
                out[m.group(1)] = float(m.group(2))
            except ValueError:
                out[m.group(1)] = m.group(2)
    return out


def cayley2hom(c6: np.ndarray) -> np.ndarray:
    """(..., 6) [cayley(3), t(3)] -> (..., 4, 4) homogeneous, float64."""
    c6 = np.asarray(c6, np.float64)
    c1, c2, c3 = c6[..., 0], c6[..., 1], c6[..., 2]
    a, b, c = c1 * c1, c2 * c2, c3 * c3
    R = np.stack([
        np.stack([1.0 + a - b - c, 2.0 * (c1 * c2 - c3), 2.0 * (c1 * c3 + c2)], -1),
        np.stack([2.0 * (c1 * c2 + c3), 1.0 - a + b - c, 2.0 * (c2 * c3 - c1)], -1),
        np.stack([2.0 * (c1 * c3 - c2), 2.0 * (c2 * c3 + c1), 1.0 - a - b + c], -1)], -2)
    M = np.zeros(c6.shape[:-1] + (4, 4))
    M[..., :3, :3] = R / (1.0 + a + b + c)[..., None, None]
    M[..., :3, 3] = c6[..., 3:6]
    M[..., 3, 3] = 1.0
    return M


class Rig:
    """The calibration of a configuration: stacked cameras and each
    camera-to-body matrix (C, 4, 4), on ``device``."""

    def __init__(self, calib_dir: str, device):
        d = load_opencv_yaml(os.path.join(calib_dir, "MultiCamSys_Calibration.yaml"))
        n = int(d["CameraSystem.nrCams"])
        m_c = np.array([[d[f"CameraSystem.cam{c + 1}_{p + 1}"] for p in range(6)]
                        for c in range(n)])
        cams = []
        for c in range(n):
            e = load_opencv_yaml(os.path.join(calib_dir, f"InteriorOrientationFisheye{c}.yaml"))
            cams.append(cam_ops.make_camera(
                c=e["Camera.c"], d=e["Camera.d"], e=e["Camera.e"], u0=e["Camera.u0"],
                v0=e["Camera.v0"], poly=[e[f"Camera.a{i}"] for i in range(int(e["Camera.nrpol"]))],
                inv_poly=[e[f"Camera.pol{i}"] for i in range(int(e["Camera.nrinvpol"]))],
                width=e["Camera.Iw"], height=e["Camera.Ih"],
                mirror=bool(int(e.get("Camera.mirrorMask", 0)))))
        self.n_cams = n
        self.cams = cam_ops.stack_cameras(cams).to(device)
        self.M_c = torch.tensor(cayley2hom(m_c), dtype=torch.float32, device=device)
        self.height, self.width = int(float(self.cams.height[0])), int(float(self.cams.width[0]))


def lattice(seed: int, device) -> torch.Tensor:
    """The (64, 64, 64) value-noise lattice, uniform in [40, 220), drawn
    from ``seed`` by numpy's generator on the host, as the port's
    ``utils/synthetic.py::_lattice`` draws it (seed 7 is the port's own
    room), then moved to ``device`` (1 MiB)."""
    rng = np.random.default_rng(int(seed))
    lat = rng.uniform(40.0, 220.0, (LATTICE, LATTICE, LATTICE)).astype(np.float32)
    return torch.from_numpy(lat).to(device)


def _texture3d(pts, lat):
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

    coarse = 0.45 * octave(pts, 11.0) + 0.35 * octave(pts, 53.0)
    fine = octave(pts, 97.0)
    steps = torch.where(fine > 130.0, 60.0, -60.0)
    return torch.clamp(coarse + 0.2 * fine + 30.0 + steps * 0.5, 0.0, 255.0)


def _ray_box_exit(origin, direction):
    """Distance along each ray to the room's walls."""
    d = torch.where(direction.abs() < 1e-9, torch.full_like(direction, 1e-9), direction)
    return ((torch.sign(d) * ROOM_HALF - origin) / d).min(-1).values


def make_renderer(rig: Rig, lat: torch.Tensor):
    """render(M (B, 4, 4)) -> (B, C, H, W) float32 in [0, 255]: the rig at
    body-to-world poses M in the textured 4 m cube."""
    h, w, dev = rig.height, rig.width, rig.M_c.device
    vv, uu = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=dev),
                            torch.arange(w, dtype=torch.float32, device=dev), indexing="ij")
    uv = torch.stack([uu, vv], -1).reshape(-1, 2)
    rays = cam_ops.img_to_world(rig.cams.expand(1), uv[None]).reshape(rig.n_cams, h, w, 3)

    def render(M):
        M = M.to(device=dev, dtype=torch.float32)
        T = torch.einsum("bij,njk->bnik", M, rig.M_c)
        o = T[..., None, None, :3, 3]
        rays_w = torch.einsum("bnij,nhwj->bnhwi", T[..., :3, :3], rays)
        hits = o + _ray_box_exit(o, rays_w)[..., None] * rays_w
        return torch.clamp(_texture3d(hits, lat), 0.0, 255.0)

    return render


def surface_distance(X: np.ndarray) -> np.ndarray:
    """Each world point's (N, 3) distance to the nearest wall of the room,
    the world's only surface."""
    q = np.abs(np.asarray(X, np.float64)) - ROOM_HALF       # > 0 outside along an axis
    outside = np.linalg.norm(np.maximum(q, 0.0), axis=1)
    inside = -np.max(q, axis=1)
    return np.where(np.all(q <= 0, axis=1), inside, outside)
