"""Oriented binary descriptors: ORB from per-keypoint patches.

Port of ``multicol_slam_tpu/ops/brief.py`` (reference
mdBRIEFextractorOct.cpp: IC_Angle :221-248, compute_ORB :303-354). The
JAX package samples pattern points with one-hot bf16 matmuls because
gathers are slow on a TPU; here a direct gather reads the same values.
Callers still pass integer-valued blurred patches, as the extractor's
rounding guarantees (the reference blurs a uint8 image).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .hamming import pack_bits_u32

HALF_PATCH = 15           # IC_Angle patch radius (31x31)
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


def ic_angle_patches(patches: torch.Tensor) -> torch.Tensor:
    """IC angle atan2(m01, m10) from raw square patches (..., P, P), P >= 31
    odd, over the central circular 31x31 window."""
    p = patches.shape[-1]
    r = (p - 1) // 2
    lo, hi = r - HALF_PATCH, r + HALF_PATCH + 1
    wu, wv = _ic_weights_on(patches.device)
    ctr = patches[..., lo:hi, lo:hi]
    m10 = (ctr * wu).sum((-2, -1))
    m01 = (ctr * wv).sum((-2, -1))
    return torch.atan2(m01, m10)


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


def orb_from_patches(patches_blur: torch.Tensor, angle: torch.Tensor,
                     pattern: torch.Tensor) -> torch.Tensor:
    """ORB from pre-blurred patches (..., P, P) centred on the keypoint:
    bit b = I(p0_b) < I(p1_b), packed LSB-first into int32 words."""
    offsets = rotate_pattern_int(pattern.to(torch.float32), angle)
    vals = _sample_patch_values(patches_blur, offsets)
    return pack_bits_u32(vals[..., 0::2] < vals[..., 1::2])
