"""Frozen copy of the port's ``multicol_slam_tpu_torch/ops/brief.py``
(the plain extraction chain), kept here so that the benchmark's reference
imports nothing of the program. Do not edit: it is the yardstick.

Oriented binary descriptors: ORB, dBRIEF and mdBRIEF from per-keypoint
patches.

Port of ``multicol_slam_tpu/ops/brief.py`` (reference
mdBRIEFextractorOct.cpp: IC_Angle :221-248, rotateAndDistortPattern
:250-283, compute_ORB :303-354, compute_dBRIEF :356-408, compute_mdBRIEF
:410-554). The JAX package samples pattern points with one-hot bf16
matmuls because gathers are slow on a TPU; here a direct gather reads the
same values. Callers still pass integer-valued blurred patches, as the
extractor's rounding guarantees (the reference blurs a uint8 image).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .camera import CameraModel, distort_points

HALF_PATCH = 15           # IC_Angle patch radius (31x31)
INT32_MAX = 2 ** 31 - 1
# the largest float32 below 2**31: it casts to int32 exactly
_F32_BELOW_2_31 = 2147483520.0
MDBRIEF_ROT = float(np.float32(np.deg2rad(20.0)))   # the mask's +-20 degrees
PATCH = 48                # descriptor sampling window (covers +-23 px)
PATCH_R = PATCH // 2


@functools.lru_cache()
def make_pattern(n_pairs: int = 512, seed: int = 20160901) -> np.ndarray:
    """(2*n_pairs, 2) int32 Gaussian test points inside the radius-15
    disc; the same seed and draw order as the JAX package, so the same
    pattern."""
    rng = np.random.default_rng(seed)
    pts = np.empty((2 * n_pairs, 2), np.int64)
    got = 0
    while got < 2 * n_pairs:
        cand = np.round(rng.normal(0.0, 31 / 5.0, (4 * n_pairs, 2))).astype(np.int64)
        ok = (cand[:, 0] ** 2 + cand[:, 1] ** 2) <= HALF_PATCH ** 2
        cand = cand[ok]
        take = min(len(cand), 2 * n_pairs - got)
        pts[got:got + take] = cand[:take]
        got += take
    return pts.astype(np.int32)


def extract_patches(img: torch.Tensor, yx: torch.Tensor, radius: int) -> torch.Tensor:
    """Square (2r+1) patches centred at integer yx from batched images.

    img: (B, H, W); yx: (B, K, 2). Returns (B, K, 2r+1, 2r+1). Window
    starts clamp so the window stays inside the image, the semantics of
    ``lax.dynamic_slice`` (only padding slots ever reach the clamp)."""
    b, h, w = img.shape
    size = 2 * radius + 1
    y0 = (yx[..., 0].long() - radius).clamp(0, h - size)
    x0 = (yx[..., 1].long() - radius).clamp(0, w - size)
    ar = torch.arange(size, device=img.device)
    rows = (y0[..., None] + ar)[..., :, None]                 # (B,K,S,1)
    cols = (x0[..., None] + ar)[..., None, :]                 # (B,K,1,S)
    flat = img.reshape(b, h * w)
    idx = (rows * w + cols).reshape(b, -1)
    return torch.gather(flat, 1, idx).reshape(yx.shape[:-1] + (size, size))


@functools.lru_cache()
def _ic_weights() -> tuple[np.ndarray, np.ndarray]:
    """(31,31) u- and v-coordinate weights inside the circular patch."""
    v, u = np.mgrid[-HALF_PATCH:HALF_PATCH + 1, -HALF_PATCH:HALF_PATCH + 1]
    umax = np.round(np.sqrt(HALF_PATCH ** 2 - np.arange(HALF_PATCH + 1) ** 2.0))
    inside = np.abs(u) <= umax[np.abs(v)]
    return (u * inside).astype(np.float32), (v * inside).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _ic_weights_on(device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    return tuple(torch.from_numpy(a).to(device) for a in _ic_weights())


def moment_sum(terms: torch.Tensor) -> torch.Tensor:
    """The sum of a moment's float32 products (..., R, R) in the port's own
    order: each product widened to float64, each row summed left to right,
    the row sums added top to bottom, then rounded once to float32. Every
    step is an elementwise IEEE operation, so the bits are the same on the
    CPU and on CUDA whatever PyTorch's reductions do (the descriptor
    kernel, csrc/orb_describe.cu, sums in this order too)."""
    t = terms.to(torch.float64)
    rows = t[..., 0]
    for i in range(1, t.shape[-1]):
        rows = rows + t[..., i]
    total = rows[..., 0]
    for j in range(1, rows.shape[-1]):
        total = total + rows[..., j]
    return total.to(torch.float32)


def ic_angle_patches(patches: torch.Tensor) -> torch.Tensor:
    """IC angle atan2(m01, m10) from raw square patches (..., P, P), P >= 31
    odd, over the central circular 31x31 window, the moments summed by
    ``moment_sum``."""
    p = patches.shape[-1]
    r = (p - 1) // 2
    lo, hi = r - HALF_PATCH, r + HALF_PATCH + 1
    wu, wv = _ic_weights_on(patches.device)
    ctr = patches[..., lo:hi, lo:hi]
    m10 = moment_sum(ctr * wu)
    m01 = moment_sum(ctr * wv)
    return torch.atan2(m01, m10)


def ic_angle(img: torch.Tensor, yx: torch.Tensor) -> torch.Tensor:
    """Intensity-centroid angle (radians, [-pi, pi]) of each keypoint yx
    (B, K, 2) in images (B, H, W): atan2(m01, m10) over the circular
    31x31 patch."""
    return ic_angle_patches(extract_patches(img, yx, HALF_PATCH))


def blur_patches_valid(patches: torch.Tensor, size: int = 5) -> torch.Tensor:
    """'valid'-mode normalised box filter on (..., P, P) -> (..., P-s+1, P-s+1),
    summed in the JAX package's order."""
    out_w = patches.shape[-1] - size + 1
    acc_h = sum(patches[..., :, i:i + out_w] for i in range(size))
    acc = sum(acc_h[..., i:i + out_w, :] for i in range(size))
    return acc / (size * size)


def rotate_pattern_int(pattern_xy: torch.Tensor, angle: torch.Tensor) -> torch.Tensor:
    """Rotate integer pattern points (2B, 2) (x, y) by per-keypoint angles
    (...,) and round half to even: (..., 2B, 2) int32 (dy, dx) offsets
    (x' = x cos - y sin, y' = x sin + y cos)."""
    ax, ay = torch.cos(angle)[..., None], torch.sin(angle)[..., None]
    x, y = pattern_xy[:, 0], pattern_xy[:, 1]
    xr = torch.round(x * ax - y * ay).to(torch.int32)
    yr = torch.round(x * ay + y * ax).to(torch.int32)
    return torch.stack([yr, xr], -1)


def _sample_patch_values(patches: torch.Tensor, offsets: torch.Tensor) -> torch.Tensor:
    """patches (..., P, P); offsets (..., S, 2) (dy, dx) from the centre,
    clamped inside the window like the JAX version. Returns (..., S)."""
    p = patches.shape[-1]
    off = offsets.long().clamp(-(p // 2) + 1, p // 2 - 1) + p // 2
    flat = patches.reshape(patches.shape[:-2] + (p * p,))
    return torch.gather(flat, -1, off[..., 0] * p + off[..., 1])


def _bits(patches_blur: torch.Tensor, offsets: torch.Tensor) -> torch.Tensor:
    """The binary tests I(p0_b) < I(p1_b) at the pattern offsets (..., 2B, 2)."""
    vals = _sample_patch_values(patches_blur, offsets)
    return vals[..., 0::2] < vals[..., 1::2]


def orb_from_patches(patches_blur: torch.Tensor, angle: torch.Tensor,
                     pattern: torch.Tensor) -> torch.Tensor:
    """ORB from pre-blurred patches (..., P, P) centred on the keypoint:
    bit b = I(p0_b) < I(p1_b), packed LSB-first into int32 words."""
    offsets = rotate_pattern_int(pattern.to(torch.float32), angle)
    return pack_bits_u32(_bits(patches_blur, offsets))


def compute_orb(img_blur: torch.Tensor, yx: torch.Tensor, angle: torch.Tensor,
                pattern: torch.Tensor) -> torch.Tensor:
    """ORB on whole blurred images: img_blur (B, H, W), yx (B, K, 2) integer
    keypoints, angle (B, K). Returns (B, K, n_pairs // 32) int32."""
    return orb_from_patches(extract_patches(img_blur, yx, PATCH_R), angle, pattern)


def round_to_int32(x: torch.Tensor) -> torch.Tensor:
    """Round half to even and cast to int32 as XLA does: NaN to 0, values
    beyond the int32 range (infinities too) saturate to its ends. A bare
    ``.to(torch.int32)`` sends NaN, +-inf and out-of-range values to
    INT_MIN on the CPU and saturates on the card."""
    r = torch.round(x)
    out = torch.nan_to_num(r, nan=0.0).clamp(-2.0 ** 31, _F32_BELOW_2_31).to(torch.int32)
    return out.masked_fill(r >= 2.0 ** 31, INT32_MAX)


def distorted_pattern_offsets(cam: CameraModel, undist_kp: torch.Tensor,
                              pattern: torch.Tensor, angle: torch.Tensor) -> torch.Tensor:
    """rotateAndDistortPattern (mdBRIEFextractorOct.cpp:250-283): the
    pattern (2B, 2) (x, y) rotated by each keypoint's angle (...,) in the
    undistorted plane around its undistorted point undist_kp (..., 2),
    every point distorted through the camera, the mean subtracted, rounded
    half to even. ``cam``'s fields broadcast against (..., 2B) (for (C, K)
    keypoints, ``cams.expand(2)``). Returns (..., 2B, 2) int32 (dy, dx)."""
    ax, ay = torch.cos(angle)[..., None], torch.sin(angle)[..., None]
    x, y = pattern[:, 0].to(torch.float32), pattern[:, 1].to(torch.float32)
    xr = x * ax - y * ay + undist_kp[..., 0:1]
    yr = x * ay + y * ax + undist_kp[..., 1:2]
    uv = distort_points(cam, torch.stack([xr, yr], -1))      # (..., 2B, 2)
    uv = round_to_int32(uv - uv.mean(-2, keepdim=True))
    return torch.stack([uv[..., 1], uv[..., 0]], -1)


def dbrief_from_patches(patches_blur: torch.Tensor, angle: torch.Tensor,
                        undist_kp: torch.Tensor, cam: CameraModel,
                        pattern: torch.Tensor) -> torch.Tensor:
    """dBRIEF from pre-blurred patches (..., P, P) centred on the keypoint."""
    offsets = distorted_pattern_offsets(cam, undist_kp, pattern, angle)
    return pack_bits_u32(_bits(patches_blur, offsets))


def mdbrief_from_patches(patches_blur: torch.Tensor, angle: torch.Tensor,
                         undist_kp: torch.Tensor, cam: CameraModel,
                         pattern: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """mdBRIEF (descriptor, stability mask) from pre-blurred patches: the
    dBRIEF bits at the keypoint's angle, and a mask bit of 1 where the
    tests at the angle +-20 degrees both agree with them
    (mdBRIEFextractorOct.cpp:460-554)."""
    def bits_at(a):
        return _bits(patches_blur, distorted_pattern_offsets(cam, undist_kp, pattern, a))

    b0 = bits_at(angle)
    stable = (bits_at(angle + MDBRIEF_ROT) == b0) & (bits_at(angle - MDBRIEF_ROT) == b0)
    return pack_bits_u32(b0), pack_bits_u32(stable)


def compute_dbrief(img_blur: torch.Tensor, yx: torch.Tensor, angle: torch.Tensor,
                   undist_kp: torch.Tensor, cam: CameraModel,
                   pattern: torch.Tensor) -> torch.Tensor:
    """dBRIEF on whole blurred images (B, H, W) at keypoints yx (B, K, 2)."""
    return dbrief_from_patches(extract_patches(img_blur, yx, PATCH_R), angle,
                               undist_kp, cam, pattern)


def compute_mdbrief(img_blur: torch.Tensor, yx: torch.Tensor, angle: torch.Tensor,
                    undist_kp: torch.Tensor, cam: CameraModel,
                    pattern: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(descriptor, stability mask), both (B, K, n_pairs // 32) int32, on
    whole blurred images (B, H, W) at keypoints yx (B, K, 2)."""
    return mdbrief_from_patches(extract_patches(img_blur, yx, PATCH_R), angle,
                                undist_kp, cam, pattern)


def pack_bits_u32(bits: torch.Tensor) -> torch.Tensor:
    """(..., B) {0,1} -> (..., B//32) int32 uint32-bit-patterns, LSB-first
    (a copy of ``ops/hamming.py::pack_bits_u32``)."""
    B = bits.shape[-1]
    if B % 32:
        raise ValueError(f"{B} bits do not fill 32-bit words")
    b = bits.to(torch.int64).reshape(bits.shape[:-1] + (B // 32, 32))
    shifts = torch.arange(32, dtype=torch.int64, device=bits.device)
    v = (b << shifts).sum(-1)
    return torch.where(v >= 2 ** 31, v - 2 ** 32, v).to(torch.int32)
