"""MultiFrame ORB feature extraction with the rig's cameras as a batch.

Port of ``multicol_slam_tpu/models/extractor.py`` (reference
mdBRIEFextractorOct.cpp and cMultiFrame.cpp:92-216): an 8-level 1.2x
pyramid, FAST 20 with fallback 5 in 30 px cells inside the mirror mask,
optional Harris ranking, bucketed uniform top-k per level, one raw patch
gather feeding IC_Angle and a 5x5 blur rounded to integers, ORB bits, and
a bearing ray per keypoint. The cameras are the leading dimension of
every tensor in place of the JAX package's ``vmap``.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np
import torch

from ..ops import brief, fast, pyramid
from ..ops.camera import CameraModel, img_to_world


class ExtractorConfig(NamedTuple):
    """ORB over FAST-9/16 corners. The JAX package's dBRIEF/mdBRIEF and
    AGAST options are not ported yet."""

    n_features: int = 400          # per camera (extractor.nFeatures)
    scale_factor: float = 1.2
    n_levels: int = 8
    fast_th: int = 20
    fast_th_min: int = 5           # per-cell fallback threshold
    desc_bytes: int = 32
    cell: int = 30
    border: int = 26
    use_harris: bool = False

    @property
    def n_pairs(self) -> int:
        return 8 * self.desc_bytes

    @property
    def n_words(self) -> int:
        return self.desc_bytes // 4


def features_per_level(n_features: int, n_levels: int, scale: float) -> list[int]:
    """Geometric split of the feature budget over levels, remainder to the
    last (mdBRIEFextractorOct.cpp:168-180)."""
    f = 1.0 / scale
    per = n_features * (1 - f) / (1 - f ** n_levels)
    out, acc = [], 0
    for _ in range(n_levels - 1):
        k = int(round(per))
        out.append(k)
        acc += k
        per *= f
    out.append(max(n_features - acc, 0))
    return out


class Features(NamedTuple):
    """Padded per-camera features; every tensor leads with (C, K)."""

    xy: torch.Tensor          # (C, K, 2) float32 level-0 pixel coords
    level: torch.Tensor       # (C, K) int32 pyramid level
    angle: torch.Tensor       # (C, K) float32 orientation (radians)
    response: torch.Tensor    # (C, K) float32 corner response
    ray: torch.Tensor         # (C, K, 3) float32 unit bearing ray
    desc: torch.Tensor        # (C, K, W) int32 packed descriptor bits
    desc_mask: torch.Tensor   # (C, K, W) int32 packed stability mask
    valid: torch.Tensor       # (C, K) bool


def _level_buckets(h: int, w: int, k: int) -> int:
    """Bucket edge so that #buckets ~ 3k (octree 'enough leaves' rule)."""
    if k <= 0:
        return 16
    b = int(np.sqrt(h * w / (3.0 * k)))
    return max(8, min(64, b))


def make_extractor(cfg: ExtractorConfig, cams: CameraModel,
                   mirror_masks: Sequence[np.ndarray], image_hw: tuple[int, int]):
    """Build extract(images (C, H, W) uint8 or float32) -> Features.

    cams: batched CameraModel; mirror_masks: per level, (C, H_l, W_l)
    uint8. The tensors follow the images' device."""
    h, w = image_hw
    sizes = pyramid.level_sizes(h, w, cfg.n_levels, cfg.scale_factor)
    scales = pyramid.scale_factors(cfg.n_levels, cfg.scale_factor)
    budgets = features_per_level(cfg.n_features, cfg.n_levels, cfg.scale_factor)
    pattern = torch.from_numpy(brief.make_pattern(cfg.n_pairs))
    masks = [torch.from_numpy(np.asarray(m) > 0) for m in mirror_masks]
    if len(masks) < cfg.n_levels:
        raise ValueError(f"need a mirror mask per pyramid level: got "
                         f"{len(masks)} for {cfg.n_levels} levels")
    w0 = sizes[0][1]
    row_off = np.cumsum([0] + [hl for hl, _ in sizes[:-1]]).tolist()
    levels = [lvl for lvl in range(cfg.n_levels) if budgets[lvl] > 0]
    consts = {}

    def on(device):
        """Per-device constants, copied once: a host-to-device copy
        waits for the device's stream."""
        if device not in consts:
            consts[device] = dict(
                pattern=pattern.to(device), masks=[m.to(device) for m in masks],
                cams=cams.to(device).expand(1),
                level_off=torch.tensor([[row_off[lvl], 0] for lvl in levels],
                                       dtype=torch.int32, device=device),
                scales=torch.tensor(scales, dtype=torch.float32, device=device),
                row_off=torch.tensor(row_off, dtype=torch.int32, device=device))
        return consts[device]

    def extract(images: torch.Tensor) -> Features:
        dev = images.device
        dc = on(dev)
        imgs = images.to(torch.float32)
        pyr = pyramid.build_pyramid(imgs, cfg.n_levels, cfg.scale_factor)
        C = imgs.shape[0]
        per_level = []
        for lvl in levels:
            k_l = budgets[lvl]
            img = pyr[lvl]
            hl, wl = sizes[lvl]
            score = fast.fast_with_fallback(img, cfg.fast_th, cfg.fast_th_min,
                                            cfg.cell)
            if cfg.use_harris:
                score = torch.where(score > 0, fast.harris_score(img) + 1e-6,
                                    torch.zeros_like(score))
            yx, resp, valid = fast.select_uniform_topk(
                score, dc["masks"][lvl], k=k_l,
                bucket=_level_buckets(hl, wl, k_l), border=cfg.border)
            per_level.append((lvl, yx, resp, valid))
        canvas = torch.cat([torch.nn.functional.pad(p, (0, w0 - p.shape[-1]))
                            for p in pyr], 1)                 # (C, canvas_h, w0)
        off = dc["level_off"]
        yx_canvas = torch.cat([yx + off[i] for i, (_, yx, _, _) in
                               enumerate(per_level)], 1)       # (C, K, 2)
        resp = torch.cat([r for _, _, r, _ in per_level], 1)
        valid = torch.cat([v for _, _, _, v in per_level], 1)
        level = torch.cat([torch.full((C, yx.shape[1]), lvl, dtype=torch.int32,
                                      device=dev) for lvl, yx, _, _ in per_level], 1)
        scale_per_kp = dc["scales"][level]
        row_off_kp = dc["row_off"][level]
        xy_lvl = torch.stack([yx_canvas[..., 1], yx_canvas[..., 0] - row_off_kp], -1)
        xy_full = xy_lvl.to(torch.float32) * scale_per_kp[..., None]

        patches_raw = brief.extract_patches(canvas, yx_canvas, brief.PATCH_R + 2)
        angle = brief.ic_angle_patches(patches_raw)
        # integer-valued blurred patches, as the reference's uint8 blur
        patches_blur = torch.round(brief.blur_patches_valid(patches_raw))
        desc = brief.orb_from_patches(patches_blur, angle, dc["pattern"])
        dmask = torch.full_like(desc, -1)   # 0xFFFFFFFF: every bit stable
        ray = img_to_world(dc["cams"], xy_full)
        return Features(xy=xy_full, level=level, angle=angle, response=resp,
                        ray=ray, desc=desc, desc_mask=dmask, valid=valid)

    return extract
