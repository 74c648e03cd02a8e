"""MultiFrame feature extraction with the rig's cameras as a batch.

Port of ``multicol_slam_tpu/models/extractor.py`` (reference
mdBRIEFextractorOct.cpp and cMultiFrame.cpp:92-216): an 8-level 1.2x
pyramid, FAST-9/16 or AGAST corners at threshold 20 with fallback 5 in
30 px cells inside the mirror mask, optional Harris ranking, bucketed
uniform top-k per level, one raw patch gather feeding IC_Angle and a 5x5
blur rounded to integers, ORB, dBRIEF or mdBRIEF bits (mdBRIEF with its
stability mask), and a bearing ray per keypoint. The cameras are the
leading dimension of every tensor in place of the JAX package's ``vmap``.

``extract`` runs the pyramid's products, then two hand-written kernels
(``kernels/extract.py``): detection (FAST or AGAST with the fallback,
suppression, Harris and each bucket's maximum, every level and camera at
once) and the descriptor (a CTA a keypoint: window, IC angle, blur, ORB
bits); the best buckets' stable sort, the gathers and the bearing rays
stay in PyTorch. On CPU tensors the two wrappers take their plain
versions. ``extract.plain`` is the plain chain, level by level: the
kernels' yardstick on the card, equal to ``extract`` on the CPU.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np
import torch

from ..kernels import extract as extract_k
from ..ops import brief, fast, pyramid
from ..ops.camera import CameraModel, img_to_world, undistort_points


class ExtractorConfig(NamedTuple):
    n_features: int = 400          # per camera (extractor.nFeatures)
    scale_factor: float = 1.2
    n_levels: int = 8
    fast_th: int = 20
    fast_th_min: int = 5           # per-cell fallback threshold
    desc_bytes: int = 32           # extractor.descSize (16/32/64)
    use_dbrief: bool = False       # extractor.usemdBRIEF -> dBRIEF
    learn_masks: bool = False      # extractor.masks -> mdBRIEF masks
    cell: int = 30
    border: int = 26
    detector_mask: str = "fast_9_16"   # fast_9_16 | agast_7_12 | agast_5_8
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

    @property
    def n_cams(self) -> int:
        return self.xy.shape[0]

    @property
    def k_per_cam(self) -> int:
        return self.xy.shape[1]


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
    buckets = [_level_buckets(*sizes[lvl], budgets[lvl]) for lvl in levels]
    kept = [min(budgets[lvl], extract_k.n_tiles(*sizes[lvl], b))
            for lvl, b in zip(levels, buckets)]
    T = max(extract_k.n_tiles(*sizes[lvl], b) for lvl, b in zip(levels, buckets))
    # each keypoint slot's level (table index), rank in the level's order
    # and whether a bucket fills it (the rest pad, as select_uniform_topk's)
    slot_l = np.concatenate([np.full(budgets[lvl], i) for i, lvl in enumerate(levels)])
    slot_rank = np.concatenate([np.arange(budgets[lvl]) for lvl in levels])
    slot_pad = slot_rank >= np.asarray(kept)[slot_l]
    consts = {}

    def on(device):
        """Per-device constants, copied once: a host-to-device copy
        waits for the device's stream."""
        if device not in consts:
            lv = np.asarray(levels)[slot_l]
            i64 = lambda a: torch.tensor(np.asarray(a), dtype=torch.int64, device=device)
            consts[device] = dict(
                pattern=pattern.to(device), masks=[m.to(device) for m in masks],
                cams=cams.to(device).expand(1), cams2=cams.to(device).expand(2),
                level_off=torch.tensor([[row_off[lvl], 0] for lvl in levels],
                                       dtype=torch.int32, device=device),
                scales=torch.tensor(scales, dtype=torch.float32, device=device),
                row_off=torch.tensor(row_off, dtype=torch.int32, device=device),
                # the kernels' path: each slot's place in the sorted (L, T)
                # buckets, its level's first bucket, bucket edge and buckets a
                # row, its pyramid level and scale, and the padding slots
                pick=i64(slot_l * T + np.minimum(slot_rank, T - 1)), level_T=i64(slot_l * T),
                bucket=i64(np.asarray(buckets)[slot_l]),
                nbx=i64(np.asarray([-(-sizes[lvl][1] // b)
                                    for lvl, b in zip(levels, buckets)])[slot_l]),
                slot_level=torch.tensor(lv, dtype=torch.int32, device=device),
                slot_scale=torch.tensor(np.asarray(scales, np.float32)[lv], device=device),
                pad=torch.tensor(slot_pad, device=device))
        return consts[device]

    def plain(images: torch.Tensor) -> Features:
        """The plain chain, level by level, on any device."""
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
                                            cfg.cell, cfg.detector_mask)
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
        return _describe_rest(cfg, dc, xy_full, level, angle, resp, valid,
                              patches_blur=patches_blur)

    def extract(images: torch.Tensor) -> Features:
        """The kernels' path: the pyramid, ``extract_k.detect``, the best
        buckets' sort and gathers (``select_keypoints``),
        ``extract_k.describe``, the rays."""
        dc = on(images.device)
        pyr = pyramid.build_pyramid(images.to(torch.float32).contiguous(), cfg.n_levels,
                                   cfg.scale_factor)
        vals, args = extract_k.detect(
            [pyr[lvl] for lvl in levels], [dc["masks"][lvl] for lvl in levels], buckets,
            th_hi=cfg.fast_th, th_lo=cfg.fast_th_min, cell=cfg.cell, border=cfg.border,
            ring=cfg.detector_mask, harris=cfg.use_harris)
        yx, resp, valid, level, xy_full = select_keypoints(dc, vals, args)
        if cfg.use_dbrief:
            angle, blur = extract_k.describe(pyr, yx, level, None)
            return _describe_rest(cfg, dc, xy_full, level, angle, resp, valid, patches_blur=blur)
        angle, desc = extract_k.describe(pyr, yx, level, dc["pattern"])
        return _describe_rest(cfg, dc, xy_full, level, angle, resp, valid, desc=desc)

    extract.plain = plain
    return extract


def select_keypoints(dc: dict, vals: torch.Tensor, args: torch.Tensor):
    """``select_uniform_topk``'s top-k of every level at once from the
    bucket maxima (C, L, T) and their indices inside the bucket (padding
    columns -inf): one stable sort of each level's row (the -inf columns
    sort last, so each level's order is its own), each slot's bucket by the
    constants of ``dc`` (``make_extractor``'s per-device table). Returns
    yx (C, K, 2) int32 level pixels, resp, valid, level (C, K) int32 and
    the level-0 pixel coordinates xy (C, K, 2) float32."""
    C = vals.shape[0]
    order = torch.sort(-vals, dim=-1, stable=True).indices.flatten(1)
    tile = order.index_select(1, dc["pick"])                      # (C, K)
    at = tile + dc["level_T"]
    resp = vals.flatten(1).gather(1, at)
    within = args.flatten(1).gather(1, at).to(torch.int64)
    bucket, nbx, pad = dc["bucket"], dc["nbx"], dc["pad"]
    y = (tile // nbx) * bucket + within // bucket
    x = (tile % nbx) * bucket + within % bucket
    yx = torch.where(pad[:, None], 0, torch.stack([y, x], -1)).to(torch.int32)
    resp = torch.where(pad, 0.0, resp)
    xy = torch.stack([yx[..., 1], yx[..., 0]], -1).to(torch.float32) \
        * dc["slot_scale"][:, None]
    level = dc["slot_level"].expand(C, -1).clone()
    return yx, resp, resp > 0, level, xy


def _describe_rest(cfg: ExtractorConfig, dc: dict, xy_full, level, angle, resp, valid, *,
                   patches_blur=None, desc=None) -> Features:
    """The descriptor from the blurred patches unless given, its stability
    mask, and the bearing rays."""
    cams1 = dc["cams"]
    if cfg.use_dbrief:
        undist = undistort_points(cams1, xy_full, cams1.p1[..., None])
        args = (patches_blur, angle, undist, dc["cams2"], dc["pattern"])
        if cfg.learn_masks:
            desc, dmask = brief.mdbrief_from_patches(*args)
        else:
            desc = brief.dbrief_from_patches(*args)
            dmask = torch.full_like(desc, -1)   # 0xFFFFFFFF: every bit stable
    else:
        if desc is None:
            desc = brief.orb_from_patches(patches_blur, angle, dc["pattern"])
        dmask = torch.full_like(desc, -1)
    ray = img_to_world(cams1, xy_full)
    return Features(xy=xy_full, level=level, angle=angle, response=resp,
                    ray=ray, desc=desc, desc_mask=dmask, valid=valid)
