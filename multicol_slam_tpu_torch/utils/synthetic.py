"""Synthetic multi-fisheye frames and a ground-truth map for the WORKING
frame.

Port of ``multicol_slam_tpu/utils/synthetic.py``: a procedurally
textured room (the same 64^3 value-noise lattice from the same numpy
seed, optionally with a place-distinctive layer) seen through the rig
along a smooth arc, a lateral path or the benchmark sequence (a lateral
opening, then the arc); interior walls with doors, fins and moving
spheres; the two-room and baffle tours whose revisit a loop closer must
detect; and ``make_dead_reckoner``, the simulated odometry that drifts
the tracker on such a tour; ``make_ba_problem``, a map-scale global-BA
problem for the sharded BA.
``gt_bootstrap`` lifts a frame's keypoints to their wall points at the
true pose, the map the WORKING frame tracks against when mapping is not
in the loop.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..ops import camera as cam_ops
from ..ops import se3_np
from ..ops.geometry import cayley2hom, hom2cayley
from ..ops.rig import Rig, mt_mc

ROOM_HALF = 4.0     # half-extent of the cubic room (meters)
LATTICE = 64        # noise lattice resolution


@functools.lru_cache()
def _lattice(seed: int = 7) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.uniform(40.0, 220.0, (LATTICE, LATTICE, LATTICE)).astype(np.float32)


def _texture3d(pts: torch.Tensor, lat: torch.Tensor,
               place_texture: bool = False) -> torch.Tensor:
    """Trilinear 3-D value noise at world points (..., 3) -> (...,): a
    coarse octave, a fine corner-rich one and a quantized step layer.

    ``place_texture=True`` adds a place-distinctive layer: a coarse
    style field (about 1 m cells) switches the fine structure between two
    frequencies, flips and gates the step layer's contrast and shifts the
    brightness, so that views of different regions quantize to different
    BoW words, as real rooms do (loop detection needs it)."""
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
    if not place_texture:
        steps = torch.where(fine > 130.0, 60.0, -60.0)
        return torch.clamp(coarse + 0.2 * fine + 30.0 + steps * 0.5, 0.0, 255.0)
    style = octave(pts, 5.0)
    pick = style > 130.0
    fine2 = torch.where(pick, fine, octave(pts, 61.0))
    steps2 = torch.where(fine2 > 130.0, 60.0, -60.0)
    sign = torch.where(pick, 1.0, -1.0)
    on = torch.where(octave(pts, 7.0) > 110.0, 1.0, 0.35)
    return torch.clamp(coarse + 0.2 * fine2 + 30.0 + sign * on * steps2 * 0.5
                       + 0.35 * (style - 130.0), 0.0, 255.0)


def _safe(d: torch.Tensor) -> torch.Tensor:
    """``d`` with entries under 1e-9 in magnitude set to 1e-9 (a safe
    divisor, as the JAX renderer's)."""
    return torch.where(d.abs() < 1e-9, torch.full_like(d, 1e-9), d)


def _ray_box_exit(origin: torch.Tensor, direction: torch.Tensor,
                  half=None) -> torch.Tensor:
    """Distance to the room wall along ``direction`` from an interior
    ``origin``: min over axes of the positive boundary hit. ``half`` is
    the per-axis half-extent (default: the ROOM_HALF cube)."""
    if half is None:
        half = (ROOM_HALF, ROOM_HALF, ROOM_HALF)
    half = torch.tensor(half, dtype=direction.dtype, device=direction.device)
    d = _safe(direction)
    t = (torch.sign(d) * half - origin) / d
    return t.min(-1).values


def make_renderer(rig: Rig, room_half=None, door_wall=None,
                  place_texture: bool = False, distractors=None):
    """render(M_t, time=None) -> (C, H, W) float32 in [0, 255] for a
    (4, 4) pose, or (B, C, H, W) for (B, 4, 4) poses in one call, on the
    rig's device. Per-pixel rays are computed once.

    ``room_half``: the room's per-axis half-extent (default the
    ROOM_HALF cube).

    ``door_wall``: one dict or a list of them. A dict without an ``x`` key
    is an interior wall normal to z with a rectangular door,
    {z, door_half_x, door_half_y, door_cx, door_cy}; two walls with
    offset doors leave no straight sightline between the rooms either
    side. A dict with an ``x`` key is a solid fin normal to x,
    {x, z_lo, z_hi[, y_pass]}, spanning all of y but an aperture
    |y| < y_pass. Interior walls and fins sample the texture offset by
    +-0.04 m along their normal by approach side, so their two faces do
    not render the same texture.

    ``distractors``: moving rigid textured spheres, each {center (3,),
    velocity (3,), radius}, at center + time * velocity; the texture is
    sampled in the sphere's own frame (plus a per-sphere offset), so it
    moves with the sphere. ``time`` is a scalar, or (B,) for a batch
    (default 0)."""
    h = int(rig.cams.height[0])
    w = int(rig.cams.width[0])
    dev = rig.M_c.device
    vv, uu = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=dev),
                            torch.arange(w, dtype=torch.float32, device=dev),
                            indexing="ij")
    uv = torch.stack([uu, vv], -1).reshape(-1, 2)
    rays = cam_ops.img_to_world(rig.cams.expand(1), uv[None]).reshape(rig.n_cams, h, w, 3)
    lat = torch.from_numpy(_lattice()).to(dev)
    walls = list(door_wall) if isinstance(door_wall, (list, tuple)) else (
        [door_wall] if door_wall else [])
    spheres = list(distractors or [])

    def render(M_t: torch.Tensor, time=None) -> torch.Tensor:
        M_t = torch.as_tensor(M_t).to(device=dev, dtype=torch.float32)
        lead = M_t.shape[:-2]
        M = M_t.reshape(-1, 4, 4)
        B = M.shape[0]
        tt = torch.zeros(B, dtype=torch.float32, device=dev) if time is None \
            else torch.as_tensor(time, dtype=torch.float32).to(dev).reshape(-1).expand(B)
        T = torch.einsum("bij,njk->bnik", M, rig.M_c)
        R = T[..., :3, :3]
        o = T[..., None, None, :3, 3]
        rays_w = torch.einsum("bnij,nhwj->bnhwi", R, rays)
        t = _ray_box_exit(o, rays_w, room_half)
        zero = torch.zeros_like(rays_w[..., 0])
        bias = torch.zeros_like(rays_w)
        for wall in walls:
            if "x" in wall:
                t_f = (wall["x"] - o[..., 0]) / _safe(rays_w[..., 0])
                pz = o[..., 2] + t_f * rays_w[..., 2]
                solid = ((t_f > 1e-4) & (pz >= wall.get("z_lo", 0.0))
                         & (pz <= wall.get("z_hi", 0.8)))
                if "y_pass" in wall:
                    pyf = o[..., 1] + t_f * rays_w[..., 1]
                    solid &= pyf.abs() >= wall["y_pass"]
                won = solid & (t_f < t)
                t = torch.where(won, t_f, t)
                off = torch.stack([0.04 * torch.sign(rays_w[..., 0]), zero, zero], -1)
                bias = torch.where(won[..., None], off, bias)
                continue
            dz = rays_w[..., 2]
            t_wall = (wall.get("z", 0.0) - o[..., 2]) / _safe(dz)
            px = o[..., 0] + t_wall * rays_w[..., 0]
            py = o[..., 1] + t_wall * rays_w[..., 1]
            door = (((px - wall.get("door_cx", 0.0)).abs() < wall.get("door_half_x", 0.7))
                    & ((py - wall.get("door_cy", 0.0)).abs() < wall.get("door_half_y", 1.2)))
            won = (t_wall > 1e-4) & ~door & (t_wall < t)
            t = torch.where(won, t_wall, t)
            off = torch.stack([zero, zero, 0.04 * torch.sign(dz)], -1)
            bias = torch.where(won[..., None], off, bias)
        for i, dsc in enumerate(spheres):
            c = (torch.tensor(dsc["center"], dtype=torch.float32, device=dev)
                 + tt[:, None] * torch.tensor(dsc["velocity"], dtype=torch.float32,
                                              device=dev))
            c = c[:, None, None, None, :]
            r = float(dsc["radius"])
            oc = o - c
            b = (rays_w * oc).sum(-1)
            cq = (oc * oc).sum(-1) - r * r
            disc = b * b - cq
            t_s = -b - torch.sqrt(torch.clamp(disc, min=0.0))
            won = (disc > 0) & (t_s > 1e-4) & (t_s < t)
            t = torch.where(won, t_s, t)
            off = torch.tensor([7.1 * (i + 1), -3.3 * (i + 1), 1.7],
                               dtype=torch.float32, device=dev)
            bias = torch.where(won[..., None], off - c, bias)
        hits = o + t[..., None] * rays_w + bias
        img = torch.clamp(_texture3d(hits, lat, place_texture), 0.0, 255.0)
        return img.reshape(lead + img.shape[1:])

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


def lateral_trajectory(n_frames: int, step: float = 0.05,
                       yaw_rate: float = 0.004) -> np.ndarray:
    """(n_frames, 4, 4) poses: constant lateral translation and a slow
    yaw, the parallax-friendliest motion for monocular initialization."""
    out = np.zeros((n_frames, 4, 4))
    for i in range(n_frames):
        ang = yaw_rate * i
        c, s = np.cos(ang), np.sin(ang)
        out[i, :3, :3] = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])
        out[i, :3, 3] = [step * i, 0.004 * i, 0.002 * i]
        out[i, 3, 3] = 1.0
    return out


def bench_trajectory(n_frames: int, radius: float = 0.8,
                     opening: int = 12, step: float = 0.05) -> np.ndarray:
    """Benchmark sequence: a lateral opening segment (sideways
    translation, no rotation: parallax to bootstrap from) followed by the
    :func:`smooth_trajectory` arc, continued from the opening's end pose,
    as the reference's Lafida run starts after the operator's
    initialization motion (Slam_Settings_indoor1.yaml:54-56)."""
    lat = lateral_trajectory(opening, step=step, yaw_rate=0.0)
    arc = smooth_trajectory(max(n_frames - opening + 1, 2), radius=radius)
    tail = np.einsum("ij,njk->nik", lat[-1], arc[1:])
    return np.concatenate([lat, tail])[:n_frames]


def _tour(wps, n_frames: int) -> np.ndarray:
    """(n_frames, 4, 4) identity-rotation poses at equal arc-length steps
    along the (x, z) waypoints ``wps``, at height 0."""
    wps = np.array(wps)
    seg = np.linalg.norm(np.diff(wps, axis=0), axis=1)
    cum = np.concatenate([[0], np.cumsum(seg)])
    s = np.linspace(0, cum[-1], n_frames)
    x = np.interp(s, cum, wps[:, 0])
    z = np.interp(s, cum, wps[:, 1])
    out = np.zeros((n_frames, 4, 4))
    for i in range(n_frames):
        out[i] = np.eye(4)
        out[i][:3, 3] = [x[i], 0.0, z[i]]
    return out


def two_room_loop_trajectory(n_frames: int, depth: float = 1.6,
                             width: float = 1.4) -> np.ndarray:
    """Start in room A (z < 0) near the door, pass through the door (at
    z = 0, x = 0), tour room B and return through the door to the start:
    a revisit with covisibility broken by the wall (render with
    ``make_renderer(door_wall=...)``)."""
    return _tour([
        [0.0, -depth], [0.0, -0.4], [0.0, 0.5], [width * 0.7, depth * 0.7],
        [0.0, depth * 1.2], [-width * 0.7, depth * 0.7], [0.0, 0.5],
        [0.0, -0.4], [0.0, -depth],
    ], n_frames)


def two_room_revisit_trajectory(n_frames: int, depth: float = 1.6,
                                width: float = 1.4) -> np.ndarray:
    """The two-room tour with a lateral opening (parallax to bootstrap
    from) and, after the return through the door, a dwell circuit in
    room A, so that keyframes keep coming after the revisit: the loop
    closer needs CONSISTENCY_TH consecutive detections
    (cLoopClosing.cpp:166-241)."""
    return _tour([
        [0.0, -depth], [0.45, -depth * 1.05], [0.0, -0.9],
        [0.0, -0.4], [0.0, 0.5], [width * 0.7, depth * 0.7],
        [0.0, depth * 1.2], [-width * 0.7, depth * 0.7], [0.0, 0.5],
        [0.0, -0.4], [0.0, -depth],
        [width * 0.5, -depth * 1.2], [0.0, -depth * 1.5],
        [-width * 0.5, -depth * 1.2], [0.0, -depth],
    ], n_frames)


# The baffle world: two interior walls with offset doors. A fisheye rig
# of nearly 180 degrees sees through a single doorway, so one wall never
# breaks covisibility; two offset doors leave no straight sightline
# between room A (z < 0) and room B (z > 0.8), so revisiting room A is a
# loop-closure event. The default has no corridor fin: a fin's passage
# is a visual pinch the tracker cannot thread at tour pace.
BAFFLE_ROOM_HALF = (2.2, 2.2, 3.6)
BAFFLE_WALLS = (
    dict(z=0.0, door_half_x=0.5, door_half_y=1.2, door_cx=-0.9),
    dict(z=0.8, door_half_x=0.5, door_half_y=1.2, door_cx=0.9),
)

# the corridor between the offset doors, with rounded corners (a sharp
# turn breaks the constant-velocity motion model)
_BAFFLE_CORRIDOR = [
    [-0.9, -0.9], [-0.9, -0.3], [-0.85, 0.1], [-0.4, 0.42],
    [0.4, 0.42], [0.85, 0.7], [0.9, 1.3],
]


def baffle_revisit_trajectory(n_frames: int) -> np.ndarray:
    """Tour room A, the corridor, room B, back, and re-tour room A (1.5
    laps of a smooth circuit), so that keyframes keep coming after the
    revisit and DetectLoop can reach CONSISTENCY_TH consecutive
    detections. The opening is lateral, for bootstrap parallax."""
    return _tour([
        [0.0, -2.2], [0.5, -2.35], [-0.2, -1.5],
        *_BAFFLE_CORRIDOR,
        [0.3, 2.0], [-0.3, 2.2], [-0.8, 1.6],
        *_BAFFLE_CORRIDOR[::-1],
        [-0.3, -1.4], [0.3, -1.7], [0.5, -2.2], [0.0, -2.5],
        [-0.6, -2.1], [-0.4, -1.6], [0.1, -1.5], [0.4, -1.9],
        [0.1, -2.3], [-0.4, -2.1],
    ], n_frames)


def baffle_revisit_trajectory_short(n_frames: int) -> np.ndarray:
    """The baffle world's short tour (about 19 m, 112 frames at its
    pace): a full lap of room A, so the revisited era holds many
    keyframes spread over the room (DetectLoop excludes every keyframe
    connected to the query, and a few long-lived doorway landmarks bridge
    the eras, so a sparse era is excluded whole), the corridor, a brief
    dip into room B, the corridor back, and the lap retraced in reverse,
    so the candidates score like near-duplicates."""
    lap = [
        [0.0, -2.2], [0.6, -2.05], [0.85, -1.5], [0.35, -1.15],
        [-0.45, -1.3], [-0.85, -1.85], [-0.35, -2.25],
    ]
    return _tour([
        *lap,
        [-0.2, -1.5],
        *_BAFFLE_CORRIDOR,
        [0.35, 2.0], [-0.3, 2.05],
        *_BAFFLE_CORRIDOR[::-1],
        [-0.5, -1.3], [0.35, -1.15], [0.85, -1.5], [0.6, -2.05],
        [0.0, -2.2], [-0.35, -2.25], [-0.85, -1.85],
    ], n_frames)


# dead reckoning (the harness's simulated odometry)
DRIFT_STEP = 0.004     # m a frame of translation bias, in the body frame
YAW_STEP = 0.002       # rad a frame of heading bias
DRIFT_START = 10       # frames left to the bootstrap before drift starts


def make_dead_reckoner(slam, gt: np.ndarray, drift_step: float = DRIFT_STEP,
                       yaw_step: float = YAW_STEP, yaw_pulse: float = 0.0,
                       pulse_frames=(0, 0), stop_fn=None):
    """Simulated noisy odometry for ``Tracker.perturb_pose_fn``: the
    counterpart of ``make_dead_reckoner`` in tests/test_organic_loop.py
    (lines 73-139), the harness of the JAX package's organic loop.

    The tracked pose of frame k is replaced by A M(k), with
    M(k) = M(k-1) rel_true(k) N(k): rel_true is ground truth's relative
    body motion ``gt`` (n, 4, 4), N(k) a per-frame noise transform (a yaw
    of ``yaw_step``, plus ``yaw_pulse`` over ``pulse_frames`` = [a, b),
    and ``drift_step`` m along a fixed body direction) from frame
    DRIFT_START on, and A the ground-truth-to-map anchor, locked at the
    first call and re-based after every relocalization. The error
    compounds in the body frame, as wheel or inertial odometry's does.
    The override ends once ``stop_fn()`` is true, or, without a
    ``stop_fn``, once the loop closer has fired
    (``slam.loop_closer.last_loop_kf >= 0``). ``slam`` is a MultiColSLAM
    of either package: only ``tracker.last_reloc_frame``,
    ``tracker.frame_id`` and ``loop_closer.last_loop_kf`` are read, and
    poses are (6,) Cayley vectors."""
    drift_dir = np.array([1.0, 0.3, 0.0])
    drift_dir /= np.linalg.norm(drift_dir)

    def noise(fid):
        yaw = yaw_step + (yaw_pulse if pulse_frames[0] <= fid < pulse_frames[1]
                          else 0.0)
        c, s = np.cos(yaw), np.sin(yaw)
        N = np.eye(4)
        N[:3, :3] = [[c, 0.0, s], [0.0, 1.0, 0.0], [-s, 0.0, c]]
        N[:3, 3] = drift_step * drift_dir
        return N

    odo = {"A": None, "M": None, "prev": None}

    def perturb(mt6, fid):
        if stop_fn is not None:
            if stop_fn():
                return mt6
        elif slam.loop_closer is not None and slam.loop_closer.last_loop_kf >= 0:
            return mt6
        if odo["A"] is None or slam.tracker.last_reloc_frame == slam.tracker.frame_id:
            M_slam = se3_np.cayley2hom(np.asarray(mt6, np.float64))
            odo["A"] = M_slam @ np.linalg.inv(gt[fid])
            odo["M"] = np.array(gt[fid], np.float64)
            odo["prev"] = fid
            return mt6
        rel = np.linalg.inv(gt[odo["prev"]]) @ gt[fid]
        odo["prev"] = fid
        if fid >= DRIFT_START:
            rel = rel @ noise(fid)
        odo["M"] = odo["M"] @ rel
        return se3_np.hom2cayley(odo["A"] @ odo["M"])

    return perturb


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


def make_ba_problem(rig: Rig, n_kf: int, n_pt: int, *, max_obs_per_pt: int = 8,
                    noise_px: float = 0.5, seed: int = 0):
    """A synthetic global-BA problem at map scale (cOptimizer::
    GlobalBundleAdjustment's workload, cOptimizer.cpp:57-257: every
    keyframe against every point), the input of the sharded BA's runs.

    Keyframe poses along a slow arc with yaw, points in a 2-5 m shell;
    every (keyframe, point) pair projected through the rig in one
    ``world_to_img_rig`` call over keyframes x cameras, kept 40 px inside
    the image in the first camera that sees it; per point up to
    ``max_obs_per_pt`` observing keyframes spread over its visible span
    (entry r of n visible kept iff it opens its stride bucket
    floor(r M / n): the first M would starve later keyframes and
    ill-condition the reduced system); pixel noise. The numpy draws are the
    JAX package's, in its order. Returns numpy (mt_true (N, 6), X_true
    (P, 3), uv (K+1, 2), kf, cam, pt, valid (K+1,), pt_obs (P, M)) with the
    optimizer's convention of one invalid pad row K."""
    from ..ops.rig import world_to_img_rig

    rng = np.random.default_rng(seed)
    ang = np.linspace(0, 1.5 * np.pi, n_kf)
    mt_true = np.zeros((n_kf, 6))
    mt_true[:, 1] = np.tan(ang / 4.0)             # cayley yaw = tan(th/2)
    mt_true[:, 3] = 0.8 * np.sin(ang)
    mt_true[:, 5] = 0.8 * (np.cos(ang) - 1.0)
    mt_true[:, 4] = 0.1 * np.sin(3 * ang)
    X = rng.standard_normal((n_pt, 3))
    X /= np.linalg.norm(X, axis=1, keepdims=True)
    X *= rng.uniform(2.0, 5.0, (n_pt, 1))

    # keyframes x cameras as the cameras of one rig at the identity pose
    dev, dt = rig.M_c.device, rig.M_c.dtype
    C = rig.n_cams
    M_t = cayley2hom(torch.as_tensor(mt_true, dtype=dt, device=dev))
    per_kf = Rig(M_c=(M_t[:, None] @ rig.M_c[None]).reshape(-1, 4, 4),
                 cams=rig.cams.index(torch.arange(n_kf * C, device=dev) % C))
    uv_all, zpos = world_to_img_rig(per_kf, torch.eye(4, dtype=dt, device=dev),
                                    torch.as_tensor(X, dtype=dt, device=dev))
    uv_all = uv_all.reshape(n_kf, C, n_pt, 2).cpu().numpy()
    zpos = zpos.reshape(n_kf, C, n_pt).cpu().numpy()
    w = rig.cams.width.cpu().numpy().astype(np.float32)[None, :, None]
    h = rig.cams.height.cpu().numpy().astype(np.float32)[None, :, None]
    ok = (zpos & (uv_all[..., 0] > 40) & (uv_all[..., 0] < w - 40)
          & (uv_all[..., 1] > 40) & (uv_all[..., 1] < h - 40))
    first_cam = np.argmax(ok, axis=1)              # (N, P)
    vis_pn = ok.any(axis=1).T                      # (P, N)
    Mo = max_obs_per_pt
    rank = np.cumsum(vis_pn, axis=1) - 1
    n_vis = np.maximum(vis_pn.sum(axis=1, keepdims=True), 1)
    bucket_id = rank * Mo // n_vis
    prev_bucket = (rank - 1) * Mo // n_vis
    keep = vis_pn & ((bucket_id != prev_bucket) | (rank == 0)) \
        & (rank < n_vis) & (bucket_id < Mo)
    pt_idx, kf_idx = np.nonzero(keep)
    cam_idx = first_cam[kf_idx, pt_idx]
    K = len(pt_idx)
    uv = np.zeros((K + 1, 2))
    uv[:K] = uv_all[kf_idx, cam_idx, pt_idx] + rng.normal(0, noise_px, (K, 2))
    kf = np.zeros(K + 1, np.int32)
    kf[:K] = kf_idx
    cam = np.zeros(K + 1, np.int32)
    cam[:K] = cam_idx
    pt = np.zeros(K + 1, np.int32)
    pt[:K] = pt_idx
    valid = np.zeros(K + 1, bool)
    valid[:K] = True
    pt_obs = np.full((n_pt, Mo), K, np.int32)       # pad -> the invalid row
    # rank among the kept observations (<= M a point), not the visible ones
    keep_rank = np.cumsum(keep, axis=1) - 1
    pt_obs[pt_idx, keep_rank[pt_idx, kf_idx]] = np.arange(K)
    return mt_true, X, uv, kf, cam, pt, valid, pt_obs
