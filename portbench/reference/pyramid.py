"""Frozen copy of the port's ``multicol_slam_tpu_torch/ops/pyramid.py``
(the plain extraction chain), kept here so that the benchmark's reference
imports nothing of the program. Do not edit: it is the yardstick.

Image pyramid for feature extraction.

Port of ``multicol_slam_tpu/ops/pyramid.py`` (reference
mdBRIEFextractorOct.cpp:1158-1201): 1.2x cascaded antialiased linear
resize, each step two plain matmuls with the same host-built weights.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


def level_sizes(h: int, w: int, n_levels: int, scale: float) -> list[tuple[int, int]]:
    """Per-level sizes round(dim / scale^level) (mdBRIEFextractorOct.cpp:1163)."""
    out = []
    for lvl in range(n_levels):
        inv = 1.0 / (scale ** lvl)
        out.append((int(round(h * inv)), int(round(w * inv))))
    return out


def scale_factors(n_levels: int, scale: float) -> list[float]:
    """mvScaleFactor: [1, s, s^2, ...] (mdBRIEFextractorOct.cpp:153-156)."""
    return [scale ** lvl for lvl in range(n_levels)]


@functools.lru_cache(maxsize=None)
def _resize_matrix(n_in: int, n_out: int) -> np.ndarray:
    """(n_out, n_in) weights of a 1-D antialiased linear resize (half-pixel
    centres, triangle kernel widened when shrinking, rows renormalised)."""
    scale = n_out / n_in
    kscale = min(scale, 1.0)
    x = (np.arange(n_out) + 0.5) / scale - 0.5
    u = (np.arange(n_in)[None, :] - x[:, None]) * kscale
    wmat = np.maximum(0.0, 1.0 - np.abs(u))
    wmat /= wmat.sum(axis=1, keepdims=True)
    return wmat.astype(np.float32)


@functools.lru_cache(maxsize=None)
def _resize_weights(n_in: int, n_out: int, transpose: bool,
                    device: torch.device) -> torch.Tensor:
    """``_resize_matrix`` as a contiguous tensor on ``device``, copied there
    once: a host-to-device copy waits for the device's stream."""
    w = _resize_matrix(n_in, n_out)
    return torch.from_numpy(w.T.copy() if transpose else w).to(device)


def build_pyramid(images: torch.Tensor, n_levels: int, scale: float) -> list[torch.Tensor]:
    """(C, H, W) float32 -> list of (C, H_l, W_l) float32, each level
    resized from the previous one."""
    c, h, w = images.shape
    sizes = level_sizes(h, w, n_levels, scale)
    levels = [images]
    for lvl in range(1, n_levels):
        (hp, wp), (hl, wl) = sizes[lvl - 1], sizes[lvl]
        prev = levels[-1]
        mh = _resize_weights(hp, hl, False, images.device)
        mw = _resize_weights(wp, wl, True, images.device)
        t = torch.matmul(prev, mw)                           # (c, hp, wl)
        levels.append(torch.matmul(mh, t))                   # (c, hl, wl)
    return levels


def box_filter(images: torch.Tensor, size: int = 5) -> torch.Tensor:
    """Normalized box filter with the reflect-101 border on (..., H, W)
    (cv::boxFilter(..., Size(5, 5), normalize=true, BORDER_REFLECT_101),
    mdBRIEFextractorOct.cpp:1301): two 1-D window sums over the whole
    image. The extractor blurs only the patches descriptors read
    (``brief.blur_patches_valid``); inside the border they agree."""
    r = size // 2
    lead = images.shape[:-2]
    x = torch.nn.functional.pad(images.reshape((-1, 1) + tuple(images.shape[-2:])),
                                (r, r, r, r), mode="reflect")
    x = x.reshape(lead + tuple(x.shape[-2:]))
    acc_h = sum(x[..., :, i:i + images.shape[-1]] for i in range(size))
    acc = sum(acc_h[..., i:i + images.shape[-2], :] for i in range(size))
    return acc / (size * size)
