"""The plain extraction chain, the benchmark's reference for the
program's features: a frozen copy of the port's ``extract.plain``
(``models/extractor.py``) and of how ``MultiColSLAM`` configures it from a
settings file and a rig (its extraction masks and detector ring). Plain
PyTorch over this folder's copies of the pyramid, detector, descriptor
and camera model; nothing of the program is imported.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from . import brief, fast, pyramid
from .camera import img_to_world, make_extraction_masks, undistort_points


class ExtractorConfig(NamedTuple):
    n_features: int = 400
    scale_factor: float = 1.2
    n_levels: int = 8
    fast_th: int = 20
    fast_th_min: int = 5
    desc_bytes: int = 32
    use_dbrief: bool = False
    learn_masks: bool = False
    cell: int = 30
    border: int = 26
    detector_mask: str = "fast_9_16"
    use_harris: bool = False

    @property
    def n_pairs(self) -> int:
        return 8 * self.desc_bytes

    @property
    def n_words(self) -> int:
        return self.desc_bytes // 4


class Features(NamedTuple):
    xy: torch.Tensor
    level: torch.Tensor
    angle: torch.Tensor
    response: torch.Tensor
    ray: torch.Tensor
    desc: torch.Tensor
    desc_mask: torch.Tensor
    valid: torch.Tensor


def config_from_settings(s: dict) -> ExtractorConfig:
    """The tracking extractor of a ``Slam_Settings`` YAML (its keys as
    ``config_io.load_settings`` reads them; the system's defaults where a
    key is absent), with the detector ring the system picks."""
    g = lambda k, d: s.get(k, d)
    mask = "fast_9_16"
    if int(g("extractor.useAgast", 0)):
        mask = {0: "agast_5_8", 1: "agast_7_12", 2: "agast_7_12"}.get(
            int(g("extractor.fastAgastType", 2)), "fast_9_16")
    return ExtractorConfig(
        n_features=int(g("extractor.nFeatures", 400)),
        scale_factor=float(g("extractor.scaleFactor", 1.2)),
        n_levels=int(g("extractor.nLevels", 8)), fast_th=int(g("extractor.fastTh", 20)),
        desc_bytes=int(g("extractor.descSize", 32)),
        use_dbrief=bool(int(g("extractor.usemdBRIEF", 0))),
        learn_masks=bool(int(g("extractor.masks", 0))), detector_mask=mask,
        use_harris=int(g("extractor.nScoreType", 0)) == 0)


def extraction_masks(cams, cfg: ExtractorConfig) -> list[np.ndarray]:
    """Per level, (C, H_l, W_l) uint8: the fisheye circle for cameras
    whose calibration sets mirrorMask, else the whole image."""
    C = int(cams.c.shape[0])
    w, h = int(float(cams.width[0])), int(float(cams.height[0]))
    per_cam = []
    for c in range(C):
        if float(cams.mirror[c]) > 0.5:
            per_cam.append(make_extraction_masks(float(cams.u0[c]), float(cams.v0[c]), w, h,
                                                 cfg.n_levels, cfg.scale_factor))
        else:
            per_cam.append([np.full(sz, 255, np.uint8) for sz in
                            pyramid.level_sizes(h, w, cfg.n_levels, cfg.scale_factor)])
    return [np.stack([m[lvl] for m in per_cam]) for lvl in range(cfg.n_levels)]


def features_per_level(n_features: int, n_levels: int, scale: float) -> list[int]:
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


def level_buckets(h: int, w: int, k: int) -> int:
    if k <= 0:
        return 16
    return max(8, min(64, int(np.sqrt(h * w / (3.0 * k)))))


def make_plain_extractor(cfg: ExtractorConfig, cams, mirror_masks):
    """plain(images (C, H, W) uint8) -> Features, level by level, on the
    images' device."""
    h, w = int(float(cams.height[0])), int(float(cams.width[0]))
    sizes = pyramid.level_sizes(h, w, cfg.n_levels, cfg.scale_factor)
    scales = pyramid.scale_factors(cfg.n_levels, cfg.scale_factor)
    budgets = features_per_level(cfg.n_features, cfg.n_levels, cfg.scale_factor)
    levels = [lvl for lvl in range(cfg.n_levels) if budgets[lvl] > 0]
    row_off = np.cumsum([0] + [hl for hl, _ in sizes[:-1]]).tolist()
    w0 = sizes[0][1]

    def plain(images: torch.Tensor) -> Features:
        dev = images.device
        pattern = torch.from_numpy(brief.make_pattern(cfg.n_pairs)).to(dev)
        masks = [torch.from_numpy(np.asarray(m) > 0).to(dev) for m in mirror_masks]
        cams1, cams2 = cams.to(dev).expand(1), cams.to(dev).expand(2)
        imgs = images.to(torch.float32)
        pyr = pyramid.build_pyramid(imgs, cfg.n_levels, cfg.scale_factor)
        C = imgs.shape[0]
        per_level = []
        for lvl in levels:
            k_l = budgets[lvl]
            img = pyr[lvl]
            hl, wl = sizes[lvl]
            score = fast.fast_with_fallback(img, cfg.fast_th, cfg.fast_th_min, cfg.cell,
                                            cfg.detector_mask)
            if cfg.use_harris:
                score = torch.where(score > 0, fast.harris_score(img) + 1e-6,
                                    torch.zeros_like(score))
            yx, resp, valid = fast.select_uniform_topk(
                score, masks[lvl], k=k_l, bucket=level_buckets(hl, wl, k_l), border=cfg.border)
            per_level.append((lvl, yx, resp, valid))
        canvas = torch.cat([torch.nn.functional.pad(p, (0, w0 - p.shape[-1])) for p in pyr], 1)
        off = torch.tensor([[row_off[lvl], 0] for lvl in levels], dtype=torch.int32, device=dev)
        yx_canvas = torch.cat([yx + off[i] for i, (_, yx, _, _) in enumerate(per_level)], 1)
        resp = torch.cat([r for _, _, r, _ in per_level], 1)
        valid = torch.cat([v for _, _, _, v in per_level], 1)
        level = torch.cat([torch.full((C, yx.shape[1]), lvl, dtype=torch.int32, device=dev)
                           for lvl, yx, _, _ in per_level], 1)
        scale_per_kp = torch.tensor(scales, dtype=torch.float32, device=dev)[level]
        row_off_kp = torch.tensor(row_off, dtype=torch.int32, device=dev)[level]
        xy_lvl = torch.stack([yx_canvas[..., 1], yx_canvas[..., 0] - row_off_kp], -1)
        xy_full = xy_lvl.to(torch.float32) * scale_per_kp[..., None]
        patches_raw = brief.extract_patches(canvas, yx_canvas, brief.PATCH_R + 2)
        angle = brief.ic_angle_patches(patches_raw)
        patches_blur = torch.round(brief.blur_patches_valid(patches_raw))
        if cfg.use_dbrief:
            undist = undistort_points(cams1, xy_full, cams1.p1[..., None])
            args = (patches_blur, angle, undist, cams2, pattern)
            if cfg.learn_masks:
                desc, dmask = brief.mdbrief_from_patches(*args)
            else:
                desc = brief.dbrief_from_patches(*args)
                dmask = torch.full_like(desc, -1)
        else:
            desc = brief.orb_from_patches(patches_blur, angle, pattern)
            dmask = torch.full_like(desc, -1)
        return Features(xy=xy_full, level=level, angle=angle, response=resp,
                        ray=img_to_world(cams1, xy_full), desc=desc, desc_mask=dmask,
                        valid=valid)

    plain.pyramid = lambda images: pyramid.build_pyramid(
        images.to(torch.float32), cfg.n_levels, cfg.scale_factor)
    plain.levels, plain.sizes, plain.budgets = levels, sizes, budgets
    return plain


def bits(x: torch.Tensor) -> torch.Tensor:
    """(..., W) int32 words -> (..., 32 W) {0, 1} bits."""
    shifts = torch.arange(32, dtype=torch.int64, device=x.device)
    b = ((x.to(torch.int64) & 0xFFFFFFFF)[..., None] >> shifts) & 1
    return b.reshape(x.shape[:-1] + (x.shape[-1] * 32,))


def mismatches(got, want: Features) -> dict:
    """Per field, the entries of the program's features ``got`` (its
    first K slots a camera, K the reference's) that differ from the
    reference's: keypoint coordinates, levels, responses, validity,
    angles and rays as exact values, descriptor and mask bits as bits."""
    K = want.xy.shape[1]
    out = {}
    for f in ("xy", "level", "response", "valid", "angle", "ray"):
        a, b = getattr(got, f)[:, :K], getattr(want, f)
        out[f] = int((a.to(b.device) != b).sum())
    for f in ("desc", "desc_mask"):
        a, b = getattr(got, f)[:, :K], getattr(want, f)
        out[f] = int((bits(a.to(b.device)) != bits(b)).sum())
    return out
