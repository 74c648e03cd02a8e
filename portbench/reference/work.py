"""The least work of the extraction kernels, and the card's published
peaks: the yardstick of the ``*_roofline`` metrics.

A frozen copy of ``chip_smoke.py``'s ``detect_work``, ``ring_passes``,
``bit_test_ops``, ``arc_min_ops``, ``window_pixels`` and the operation
and byte counts of its extraction bound (phase 19), over this folder's
copy of the detector, so that nothing of the program is imported.

Detection (``csrc/fast_detect.cu``, two launches a call): the th_lo bit
test at each pixel whose score suppression reads, the arc minima at each
such pixel and polarity that passes, the th_hi test at a cell's other
pixels only where it must run, FAST_PIXEL_OPS inside mask and border and
Harris at each survivor; bytes: each pixel read as float32 and its mask
byte once, each bucket's maximum and index written once. The descriptor
(``csrc/orb_describe.cu``): the IC moments, the angle, and either the
blur at each sampled point with an ORB test a pair (ORB) or the whole
blurred patch (mdBRIEF, whose pattern is applied in PyTorch); bytes: the
keypoints' distinct window pixels, their coordinates and level, the
outputs. Built with --fmad=false, each operation is one instruction, so
the operation bound divides by the float32 instruction rate.
"""

from __future__ import annotations

import functools

import torch

from . import fast
from .extract import level_buckets

# NVIDIA H100 SXM5 80 GB, published peaks (data sheet, dense, 700 W)
HBM_BYTES_S = 3.35e12
F32_OPS_S = 67e12                  # float32 outside the tensor cores, an FMA as two
F32_INSTR_S = F32_OPS_S / 2        # the same in instructions

FAST_PIXEL_OPS = 22
HARRIS_OPS = 49 * 10 + 21 + 9
MOMENT_OPS = 6 * 961
ANGLE_OPS = 60
BLUR_POINT_OPS = 32
BLUR_PATCH_OPS = 53 * 49 * 5 + 49 * 49 * 7
ORB_TEST_OPS = 25


def least_seconds(n_bytes: float, n_ops: float) -> float:
    """The least time the card could take: bytes over the memory's rate or
    instructions over the float32 rate, the larger."""
    return max(n_bytes / HBM_BYTES_S, n_ops / F32_INSTR_S)


def arc_min_ops(n: int, arc: int) -> int:
    width, ops = 1, 0
    while 2 * width <= arc:
        ops += n
        width *= 2
    rest = arc - width
    return ops + (n + arc_min_ops(n, rest) if rest else 0)


def bit_test_ops(n: int, arc: int) -> int:
    steps, width = 0, 1
    while 2 * width <= arc:
        steps, width = steps + 1, width * 2
    return n + 4 * n + 2 * (2 * (steps + (arc > width)) + 1)


def ring_passes(img, th, ring) -> torch.Tensor:
    """(C, H, W) int: the polarities whose segment test passes at th."""
    circle, arc, r = fast.DETECTOR_MASKS[ring]
    h, w = img.shape[-2:]
    pad = fast._pad2(img, ((r, r), (r, r)), "replicate")
    d = [pad[..., r + dy: r + dy + h, r + dx: r + dx + w] - img for dy, dx in circle]
    n = torch.zeros(img.shape, dtype=torch.int64, device=img.device)
    for ring_d in (d, [-v for v in d]):
        best = functools.reduce(torch.maximum, fast._ring_min_arc(ring_d, arc))
        n += (best - 1.0 >= th).long()
    return n


def detect_work(img, m, cfg) -> dict:
    """What detection's exact method must do on one level ``img`` (C, H,
    W) with its mask ``m`` (bool), counted from this input."""
    h, w = img.shape[-2:]
    b, cell = cfg.border, cfg.cell
    yy, xx = torch.arange(h, device=img.device)[:, None], torch.arange(w, device=img.device)
    inner = m & (yy >= b) & (yy < h - b) & (xx >= b) & (xx < w - b)
    need = torch.nn.functional.max_pool2d(inner[:, None].float(), 3, 1, 1)[:, 0] > 0
    passes = ring_passes(img, cfg.fast_th_min, cfg.detector_mask)
    hi = ring_passes(img, cfg.fast_th, cfg.detector_mask) > 0
    hp, wp = -(-h // cell) * cell, -(-w // cell) * cell

    def cell_any(x):
        xp = torch.nn.functional.pad(x.float(), (0, wp - w, 0, hp - h))
        has = xp.reshape(x.shape[0], hp // cell, cell, wp // cell, cell).amax((-3, -1)) > 0
        return has.repeat_interleave(cell, -2).repeat_interleave(cell, -1)[..., :h, :w]

    hi_tests = cell_any(need) & ~cell_any(hi & need) & ~need
    survivors = 0
    if cfg.use_harris:
        nms = fast.fast_with_fallback(img, cfg.fast_th, cfg.fast_th_min, cell,
                                      cfg.detector_mask) > 0
        survivors = int((nms & inner).sum())
    return dict(need=int(need.sum()), passes=int(passes[need].sum()),
                hi_tests=int(hi_tests.sum()), inner=int(inner.sum()), survivors=survivors)


def window_pixels(sizes, yx, level) -> int:
    """Distinct canvas pixels of the keypoints' 53 x 53 windows."""
    rows = torch.tensor([sum(h for h, _ in sizes[:i]) for i in range(len(sizes))],
                        device=yx.device)
    canvas_h, w0, side = sum(h for h, _ in sizes), sizes[0][1], 53
    y0 = (rows[level.long()] + yx[..., 0] - 26).clamp(0, canvas_h - side)
    x0 = (yx[..., 1] - 26).clamp(0, w0 - side)
    ar = torch.arange(side, device=yx.device)
    idx = ((y0[..., None] + ar)[..., :, None] * w0 + (x0[..., None] + ar)[..., None, :])
    C = yx.shape[0]
    seen = torch.zeros(C, canvas_h * w0, dtype=torch.bool, device=yx.device)
    seen.scatter_(1, idx.reshape(C, -1), True)
    return int(seen.sum())


def detect_frame(plain, cfg, masks, images) -> tuple[int, int]:
    """(bytes, operations) detection needs at least on one frame (C, H, W)."""
    pyr = plain.pyramid(images)
    circle, arc, _ = fast.DETECTOR_MASKS[cfg.detector_mask]
    n = len(circle)
    ops, pixels, T = 0, 0, 0
    for lvl in plain.levels:
        img, m = pyr[lvl], masks[lvl]
        dw = detect_work(img, m, cfg)
        ops += ((dw["need"] + dw["hi_tests"]) * bit_test_ops(n, arc)
                + dw["passes"] * (arc_min_ops(n, arc) + n - 1) + dw["inner"] * FAST_PIXEL_OPS
                + dw["survivors"] * HARRIS_OPS)
        h, w = plain.sizes[lvl]
        pixels += img.shape[0] * h * w
        b = level_buckets(h, w, plain.budgets[lvl])
        T = max(T, -(-h // b) * -(-w // b))
    C = images.shape[0]
    return pixels * 5 + C * len(plain.levels) * T * 8, ops


def describe_frame(plain, cfg, feats) -> tuple[int, int]:
    """(bytes, operations) the descriptor needs at least for one frame's
    keypoints ``feats`` (the reference's features of it)."""
    scales = torch.tensor([cfg.scale_factor ** lvl for lvl in range(cfg.n_levels)],
                          device=feats.xy.device)[feats.level.long()]
    yx = torch.round(feats.xy.flip(-1) / scales[..., None]).to(torch.int32)
    C, K = feats.level.shape
    kps = C * K
    orb = not cfg.use_dbrief
    out_b = kps * (4 + (4 * cfg.n_words if orb else 49 * 49 * 4))
    n_bytes = 4 * window_pixels(plain.sizes, yx, feats.level) + 12 * kps + out_b + (
        2 * cfg.n_pairs * 2 * 4 if orb else 0)
    n_ops = kps * (MOMENT_OPS + ANGLE_OPS + (
        cfg.n_pairs * (2 * BLUR_POINT_OPS + ORB_TEST_OPS) if orb else BLUR_PATCH_OPS))
    return n_bytes, n_ops
