"""Binary descriptor Hamming distance and the gated nearest-neighbour core.

Port of ``multicol_slam_tpu/ops/hamming.py`` (reference
cORBmatcher.cpp:2439-2476 and the thresholds of :46-65). Packed
descriptors are int32 tensors holding the uint32 bit patterns, LSB-first
(bit k of word w is descriptor bit 32*w + k), since torch on the CPU
shifts no uint32; bit work runs in int64. Every function batches over
leading dimensions, so the rig's cameras run as one batch.
"""

from __future__ import annotations

import numpy as np
import torch

INVALID = 0x7FFFFFFF  # distance sentinel for gated-out pairs


def thresholds(desc_bytes: int, masked: bool) -> tuple[int, int]:
    """(TH_HIGH, TH_LOW) per cORBmatcher.cpp:52-64."""
    if masked:
        return int(np.floor(1.5 * desc_bytes)), int(np.floor(desc_bytes))
    return 3 * desc_bytes, 2 * desc_bytes


def pack_bits_u32(bits: torch.Tensor) -> torch.Tensor:
    """(..., B) {0,1} -> (..., B//32) int32 uint32-bit-patterns, LSB-first."""
    B = bits.shape[-1]
    assert B % 32 == 0
    b = bits.to(torch.int64).reshape(bits.shape[:-1] + (B // 32, 32))
    shifts = torch.arange(32, dtype=torch.int64, device=bits.device)
    v = (b << shifts).sum(-1)
    return torch.where(v >= 2 ** 31, v - 2 ** 32, v).to(torch.int32)


def unpack_bits_u32(packed: torch.Tensor) -> torch.Tensor:
    """(..., W) int32 bit patterns -> (..., W*32) {0,1} int8."""
    shifts = torch.arange(32, dtype=torch.int64, device=packed.device)
    words = packed.to(torch.int64) & 0xFFFFFFFF
    bits = (words[..., None] >> shifts) & 1
    return bits.reshape(packed.shape[:-1] + (packed.shape[-1] * 32,)).to(torch.int8)


def _pm1(packed: torch.Tensor) -> torch.Tensor:
    return 2.0 * unpack_bits_u32(packed).to(torch.float32) - 1.0


def hamming_matrix(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(..., N, M) int32 Hamming distances from a (..., N, W), b (..., M, W)
    as one +-1 float32 matmul: (B - <s_a, s_b>) / 2 is exact in f32."""
    B = a.shape[-1] * 32
    ip = torch.matmul(_pm1(a), _pm1(b).transpose(-1, -2))
    return ((B - ip) * 0.5).to(torch.int32)


def hamming_matrix_masked(a: torch.Tensor, b: torch.Tensor,
                          mask_a: torch.Tensor, mask_b: torch.Tensor) -> torch.Tensor:
    """(..., N, M) int32 masked distance (popc((a^b)&m_a) + popc((a^b)&m_b)) // 2
    (cORBmatcher.cpp:2455-2476), as two exact float32 matmuls."""
    sa, sb = _pm1(a), _pm1(b)
    ma = unpack_bits_u32(mask_a).to(torch.float32)
    mb = unpack_bits_u32(mask_b).to(torch.float32)
    na = ma.sum(-1)
    nb = mb.sum(-1)
    ip_a = torch.matmul(ma * sa, sb.transpose(-1, -2))
    ip_b = torch.matmul(sa, (mb * sb).transpose(-1, -2))
    cnt_a = (na[..., :, None] - ip_a) * 0.5
    cnt_b = (nb[..., None, :] - ip_b) * 0.5
    return ((cnt_a + cnt_b) * 0.5).to(torch.int32)


def masked_argmin2(dist: torch.Tensor, valid: torch.Tensor):
    """Per-row best index, best and second-best distance over the gated
    (..., N, M) matrix; INVALID where gated out, ties to the lowest index,
    second = min over every column but the argmin's."""
    d = torch.where(valid, dist, torch.full_like(dist, INVALID))
    best_d, best_idx = d.min(-1)
    d2 = d.scatter(-1, best_idx[..., None], INVALID)
    second_d = d2.min(-1).values
    return best_idx.to(torch.int32), best_d, second_d


def nn_accept(best_idx: torch.Tensor, best_d: torch.Tensor,
              second_d: torch.Tensor, max_dist: int,
              nn_ratio: float | None = None) -> torch.Tensor:
    """The acceptance half of gated_nn_match: best <= max_dist and the
    optional Lowe ratio best < ratio * second. Returns idx or -1."""
    ok = best_d <= max_dist
    if nn_ratio is not None:
        ok &= best_d.to(torch.float32) < nn_ratio * second_d.to(torch.float32)
    return torch.where(ok, best_idx, torch.full_like(best_idx, -1))


def gated_nn_match(dist: torch.Tensor, valid: torch.Tensor, *,
                   max_dist: int, nn_ratio: float | None = None):
    """Gated nearest-neighbour matching over a distance matrix
    (cORBmatcher.cpp:67-166 ratio test). Returns (match_idx with -1 for
    no match, best_d)."""
    best_idx, best_d, second_d = masked_argmin2(dist, valid)
    return nn_accept(best_idx, best_d, second_d, max_dist, nn_ratio), best_d


def resolve_duplicate_targets(match_idx: torch.Tensor, best_d: torch.Tensor,
                              m: int) -> torch.Tensor:
    """Keep only the lowest-distance row per matched column, ties to the
    lowest row; losers become -1. match_idx, best_d: (..., N)."""
    n = match_idx.shape[-1]
    lead = tuple(match_idx.shape[:-1])
    valid = match_idx >= 0
    cols = torch.where(valid, match_idx, torch.full_like(match_idx, m)).long()
    col_min = torch.full(lead + (m + 1,), INVALID, dtype=best_d.dtype,
                         device=best_d.device)
    col_min = col_min.scatter_reduce(-1, cols, best_d, "amin")
    rows = torch.arange(n, dtype=torch.int32, device=match_idx.device).expand(lead + (n,))
    is_min = valid & (best_d == torch.gather(col_min, -1, cols))
    win_row = torch.full(lead + (m + 1,), n, dtype=torch.int32,
                         device=match_idx.device)
    win_row = win_row.scatter_reduce(
        -1, cols, torch.where(is_min, rows, torch.full_like(rows, n)), "amin")
    keep = valid & (torch.gather(win_row, -1, cols) == rows)
    return torch.where(keep, match_idx, torch.full_like(match_idx, -1))
