"""Dense FAST-9/16 and AGAST corner scores, Harris ranking and uniform
selection.

Port of ``multicol_slam_tpu/ops/fast.py`` (reference
mdBRIEFextractorOct.cpp:631-976). Every function takes images with
leading batch dimensions (..., H, W), so the rig's cameras run as one
batch. Sums keep the JAX package's order, so equal inputs give equal
bits.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

# Bresenham circle of radius 3, OpenCV pixel order, as (dy, dx).
CIRCLE = np.array([
    (-3, 0), (-3, 1), (-2, 2), (-1, 3), (0, 3), (1, 3), (2, 2), (3, 1),
    (3, 0), (3, -1), (2, -2), (1, -3), (0, -3), (-1, -3), (-2, -2), (-3, -1),
], np.int32)
# The AGAST rings of the reference's fastAgastType options
# (mdBRIEFextractorOct.cpp:863-950): 7_12 (radius 2, 12 pixels, arc 7) and
# 5_8 (radius 1, 8 pixels, arc 5).
CIRCLE_12 = np.array([
    (-2, 0), (-2, 1), (-1, 2), (0, 2), (1, 2), (2, 1),
    (2, 0), (2, -1), (1, -2), (0, -2), (-1, -2), (-2, -1),
], np.int32)
CIRCLE_8 = np.array([
    (-1, 0), (-1, 1), (0, 1), (1, 1), (1, 0), (1, -1), (0, -1), (-1, -1),
], np.int32)

# mask name -> (ring, arc length, ring radius)
DETECTOR_MASKS = {
    "fast_9_16": (CIRCLE, 9, 3),
    "agast_7_12": (CIRCLE_12, 7, 2),
    "agast_5_8": (CIRCLE_8, 5, 1),
}


def _pad2(x: torch.Tensor, pads, mode: str, value: float = 0.0) -> torch.Tensor:
    """Pad the last two dims by ((top, bottom), (left, right))."""
    (t, b), (l, r) = pads
    lead = x.shape[:-2]
    x3 = x.reshape((-1,) + tuple(x.shape[-2:]))
    if mode == "constant":
        out = F.pad(x3, (l, r, t, b), mode="constant", value=value)
    else:
        out = F.pad(x3[:, None], (l, r, t, b), mode=mode)[:, 0]
    return out.reshape(tuple(lead) + tuple(out.shape[-2:]))


def _ring_min_arc(x: list[torch.Tensor], arc: int) -> list[torch.Tensor]:
    """out[k] = min(x[k..k+arc-1] mod N), via log-step list rotations."""
    n = len(x)
    cur = x
    width = 1
    while 2 * width <= arc:
        cur = [torch.minimum(cur[k], cur[(k + width) % n]) for k in range(n)]
        width *= 2
    rest = arc - width
    if rest:
        partial = _ring_min_arc(x, rest)
        cur = [torch.minimum(cur[k], partial[(k + width) % n])
               for k in range(n)]
    return cur


def fast_score(img: torch.Tensor, threshold: float,
               mask: str = "fast_9_16") -> torch.Tensor:
    """Segment-test corner score (..., H, W); 0 where not a corner. Score
    is the largest threshold at which the pixel stays a corner (cv::FAST
    cornerScore semantics). ``mask`` names the ring and arc:
    fast_9_16 (cv::FAST), agast_7_12 or agast_5_8."""
    circle, arc, r = DETECTOR_MASKS[mask]
    h, w = img.shape[-2:]
    pad = _pad2(img, ((r, r), (r, r)), "replicate")
    d = [pad[..., r + dy: r + dy + h, r + dx: r + dx + w] - img
         for dy, dx in circle]
    dn = [-v for v in d]
    bright = functools.reduce(torch.maximum, _ring_min_arc(d, arc))
    dark = functools.reduce(torch.maximum, _ring_min_arc(dn, arc))
    score = torch.maximum(bright, dark) - 1.0
    return torch.where(score >= threshold, score, torch.zeros_like(score))


def harris_score(img: torch.Tensor, block: int = 7, k: float = 0.04) -> torch.Tensor:
    """Dense Harris response, 7x7 block, central differences, ORB scale."""
    dx = (_pad2(img, ((0, 0), (0, 2)), "replicate")[..., :, 2:]
          - _pad2(img, ((0, 0), (2, 0)), "replicate")[..., :, :-2]) * 0.5
    dy = (_pad2(img, ((2, 0), (0, 0)), "replicate")[..., :-2, :]
          - _pad2(img, ((0, 2), (0, 0)), "replicate")[..., 2:, :]) * -0.5
    r = block // 2
    h, w = img.shape[-2:]

    def bsum(x):
        xp = _pad2(x, ((r, r), (r, r)), "constant")
        acc_h = sum(xp[..., :, i:i + w] for i in range(block))
        return sum(acc_h[..., i:i + h, :] for i in range(block))

    a, b, c = bsum(dx * dx), bsum(dx * dy), bsum(dy * dy)
    scale = (1.0 / (4 * 255.0 * block)) ** 2
    return (a * c - b * b - k * (a + c) ** 2) * (scale * scale)


def nonmax_3x3(score: torch.Tensor) -> torch.Tensor:
    """Keep strict 3x3 local maxima; plateau ties keep the first pixel in
    raster order."""
    h, w = score.shape[-2:]
    p = _pad2(score, ((1, 1), (1, 1)), "constant", value=-float("inf"))
    view = lambda dy, dx: p[..., 1 + dy:1 + dy + h, 1 + dx:1 + dx + w]
    neigh = torch.stack([view(dy, dx) for dy in (-1, 0, 1) for dx in (-1, 0, 1)
                         if not (dy == 0 and dx == 0)], 0)
    is_max = score >= neigh.max(0).values
    earlier = torch.stack([view(dy, dx) for dy, dx in
                           ((-1, -1), (-1, 0), (-1, 1), (0, -1))], 0)
    is_max &= score > earlier.max(0).values
    return torch.where(is_max, score, torch.zeros_like(score))


def _window_any(x: torch.Tensor, cell: int) -> torch.Tensor:
    """Per-cell 'has any nonzero', broadcast back to pixels. x: (..., H, W)."""
    h, w = x.shape[-2:]
    hp = -(-h // cell) * cell
    wp = -(-w // cell) * cell
    xp = _pad2(x, ((0, hp - h), (0, wp - w)), "constant")
    lead = tuple(x.shape[:-2])
    cells = xp.reshape(lead + (hp // cell, cell, wp // cell, cell))
    has = cells.amax(dim=(-3, -1)) > 0
    back = has.repeat_interleave(cell, -2).repeat_interleave(cell, -1)
    return back[..., :h, :w]


def fast_with_fallback(img: torch.Tensor, th_hi: float, th_lo: float,
                       cell: int = 30, mask: str = "fast_9_16") -> torch.Tensor:
    """FAST/AGAST th_hi per cell, th_lo in cells without a th_hi corner
    (mdBRIEFextractorOct.cpp:905-940), then 3x3 NMS."""
    s_lo = fast_score(img, th_lo, mask)
    s_hi = torch.where(s_lo >= th_hi, s_lo, torch.zeros_like(s_lo))
    use_hi = _window_any(s_hi, cell)
    return nonmax_3x3(torch.where(use_hi, s_hi, s_lo))


def bucket_maxima(score: torch.Tensor, mask: torch.Tensor, bucket: int,
                  border: int = 16):
    """The best corner of each bucket x bucket tile of ``score`` (..., H, W)
    where ``mask`` (..., H, W) holds and ``border`` pixels inside the
    image, the tiles row-major over the image padded with zeros to whole
    tiles: (values (..., n_tiles), first maximum's index inside its tile
    in raster order (..., n_tiles) int64, tiles a row)."""
    h, w = score.shape[-2:]
    lead = tuple(score.shape[:-2])
    dev = score.device
    yy = torch.arange(h, device=dev)[:, None]
    xx = torch.arange(w, device=dev)[None, :]
    in_border = ((yy >= border) & (yy < h - border)
                 & (xx >= border) & (xx < w - border))
    s = torch.where(mask & in_border, score, torch.zeros_like(score))
    hp = -(-h // bucket) * bucket
    wp = -(-w // bucket) * bucket
    sp = _pad2(s, ((0, hp - h), (0, wp - w)), "constant")
    nby, nbx = hp // bucket, wp // bucket
    tiles = sp.reshape(lead + (nby, bucket, nbx, bucket)).transpose(-3, -2)
    tiles = tiles.reshape(lead + (nby * nbx, bucket * bucket))
    bvals, bargs = tiles.max(-1)   # first maximum
    return bvals, bargs, nbx


def select_uniform_topk(score: torch.Tensor, mask: torch.Tensor, k: int,
                        bucket: int, border: int = 16):
    """Spatially uniform top-k: best corner per bucket x bucket tile (first
    maximum in raster order), then the k best tiles, ties to the lower
    tile index (``lax.top_k`` order, kept by a stable sort).

    score: (..., H, W); mask: (..., H, W) bool. Returns yx (..., k, 2)
    int32, resp (..., k) float32, valid (..., k) bool.
    """
    lead = tuple(score.shape[:-2])
    bvals, bargs, nbx = bucket_maxima(score, mask, bucket, border)
    kk = min(k, bvals.shape[-1])
    order = torch.sort(-bvals, dim=-1, stable=True).indices[..., :kk]
    resp = torch.gather(bvals, -1, order)
    within = torch.gather(bargs, -1, order)
    by, bx = order // nbx, order % nbx
    dy, dx = within // bucket, within % bucket
    yx = torch.stack([by * bucket + dy, bx * bucket + dx], -1).to(torch.int32)
    valid = resp > 0
    if kk < k:
        pad = k - kk
        yx = torch.cat([yx, yx.new_zeros(lead + (pad, 2))], -2)
        resp = torch.cat([resp, resp.new_zeros(lead + (pad,))], -1)
        valid = torch.cat([valid, valid.new_zeros(lead + (pad,))], -1)
    return yx, resp, valid
