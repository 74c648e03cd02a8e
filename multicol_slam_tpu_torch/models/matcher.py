"""Gated descriptor matching: every search mode of the reference.

Port of ``multicol_slam_tpu/models/matcher.py`` (reference
cORBmatcher.cpp): ``match_frame_to_frame`` (:1990-2110),
``match_local_map`` (:67-166), ``window_search`` (:326-473),
``search_for_initialization`` (:579), ``search_for_triangulation``
(:968-1155) and ``fuse_candidates`` (:1265-1420). Each search builds one
boolean gate over (batch, query, candidate) from the mode's rules, then
one call to ``kernels.hamming_nn`` reduces the whole batch to the best
and second-best gated Hamming distance per query, in place of the JAX
package's per-camera ``vmap`` over a distance matrix. Callers fold any
leading batch axes (neighbour keyframes, fuse targets, camera pairs)
into the camera axis. The relocalization search waits for the
relocalization slice.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..kernels.hamming_nn import hamming_nn
from ..ops import hamming as hm
from ..ops.geometry import epipolar_distance_sq
from .extractor import Features


class MatchParams(NamedTuple):
    desc_bytes: int = 32
    masked: bool = False
    scale_factor: float = 1.2

    @property
    def th_high(self) -> int:
        return hm.thresholds(self.desc_bytes, self.masked)[0]

    @property
    def th_low(self) -> int:
        return hm.thresholds(self.desc_bytes, self.masked)[1]


def _sq_dist(a_xy: torch.Tensor, b_uv: torch.Tensor) -> torch.Tensor:
    """(C, N, M) squared pixel distance between b_uv (C, N, 2) and
    a_xy (C, M, 2)."""
    return ((a_xy[:, None, :, :] - b_uv[:, :, None, :]) ** 2).sum(-1)


def _nn(q, q_mask, db, db_mask, gate, params: MatchParams, *, max_dist: int,
        nn_ratio: float | None = None, mutual: bool = False):
    """One kernel call over (C, N, M): best per query row within
    ``max_dist``, the optional ratio test, the optional mutual check (a
    second call on the transposed problem: the column's best row must be
    the row, ties to the lowest row as ``jnp.argmin``), then one winner
    per target column (hamming.py gated_nn_match +
    resolve_duplicate_targets)."""
    q, db = q.contiguous(), db.contiguous()
    masks = (q_mask.contiguous(), db_mask.contiguous()) if params.masked \
        else (None, None)
    idx, best, second = hamming_nn(q, db, gate.contiguous(), *masks)
    match = hm.nn_accept(idx, best, second, max_dist, nn_ratio)
    if mutual:
        col_best = hamming_nn(db, q, gate.transpose(-1, -2).contiguous(),
                              masks[1], masks[0])[0]
        back = torch.gather(col_best, -1, torch.clamp(idx, min=0).long())
        rows = torch.arange(q.shape[1], dtype=back.dtype, device=back.device)
        match = torch.where(back == rows, match, torch.full_like(match, -1))
    return hm.resolve_duplicate_targets(match, best, db.shape[1])


def match_frame_to_frame(cur: Features, last: Features,
                         last_has_point: torch.Tensor,
                         cur_has_point: torch.Tensor,
                         uv_pred: torch.Tensor, pred_ok: torch.Tensor,
                         params: MatchParams, th: float = 50.0) -> torch.Tensor:
    """Motion-model search (cORBmatcher.cpp:1990-2110): each last-frame
    slot with a point, projected to uv_pred (C, K, 2) in its own camera,
    matches the nearest current keypoint within th * 1.2^level px and
    one octave. Returns (C, K_last) indices into the current slots (-1 =
    none)."""
    sf = params.scale_factor
    radius = th * sf ** last.level.to(torch.float32)              # (C, Kl)
    gate = _sq_dist(cur.xy, uv_pred) <= (radius ** 2)[..., None]
    clvl = cur.level[:, None, :]
    llvl = last.level[:, :, None]
    gate &= (clvl >= llvl - 1) & (clvl <= llvl + 1)
    gate &= (cur.valid & ~cur_has_point)[:, None, :]
    gate &= (last.valid & last_has_point & pred_ok)[:, :, None]
    return _nn(last.desc, last.desc_mask, cur.desc, cur.desc_mask, gate, params,
               max_dist=params.th_high)


def match_local_map(feats: Features, has_point: torch.Tensor,
                    pt_desc: torch.Tensor, pt_mask: torch.Tensor,
                    uv_pred: torch.Tensor, pred_ok: torch.Tensor,
                    pred_level: torch.Tensor, view_cos: torch.Tensor,
                    params: MatchParams, th: float = 3.0,
                    nn_ratio: float = 0.9) -> torch.Tensor:
    """Local-map search (cORBmatcher.cpp:67-166): each map point (P, W)
    with frustum data (C, P, ...) matches the nearest free keypoint within
    th * (2.5 or 4.0 by viewing angle) * 1.2^level px and the octave
    window [level-1, level], passing the 0.9 ratio test. Returns (C, P)
    indices into the frame slots (-1 = none)."""
    sf = params.scale_factor
    C = feats.xy.shape[0]
    r = torch.where(view_cos > 0.998, 2.5, 4.0)
    radius = th * r * sf ** pred_level.to(torch.float32)          # (C, P)
    gate = _sq_dist(feats.xy, uv_pred) <= (radius ** 2)[..., None]
    flvl = feats.level[:, None, :]
    plvl = pred_level[:, :, None]
    gate &= (flvl >= plvl - 1) & (flvl <= plvl)
    gate &= (feats.valid & ~has_point)[:, None, :]
    gate &= pred_ok[:, :, None]
    q = pt_desc.expand((C,) + tuple(pt_desc.shape))
    qm = pt_mask.expand((C,) + tuple(pt_mask.shape))
    return _nn(q, qm, feats.desc, feats.desc_mask, gate, params,
               max_dist=params.th_high, nn_ratio=nn_ratio)


def window_search(f1: Features, f2: Features, f1_select: torch.Tensor,
                  params: MatchParams, window: float = 100.0,
                  nn_ratio: float = 0.9, use_low_th: bool = False) -> torch.Tensor:
    """WindowSearch (cORBmatcher.cpp:326-473): each selected f1 slot
    matches the best f2 slot of the same camera within a coordinate
    window and the same octave, with the ratio test and TH_HIGH (TH_LOW
    with ``use_low_th``). Returns (C, K1) indices into f2's slots."""
    max_d = params.th_low if use_low_th else params.th_high
    gate = _sq_dist(f2.xy, f1.xy) <= window * window
    gate &= f2.level[:, None, :] == f1.level[:, :, None]
    gate &= f2.valid[:, None, :] & (f1.valid & f1_select)[:, :, None]
    return _nn(f1.desc, f1.desc_mask, f2.desc, f2.desc_mask, gate, params,
               max_dist=max_d, nn_ratio=nn_ratio)


def search_for_initialization(f1: Features, f2: Features, params: MatchParams,
                              window: float = 50.0,
                              nn_ratio: float = 0.9) -> torch.Tensor:
    """SearchForInitialization (cORBmatcher.cpp:579): window search at
    level 0 only, TH_LOW, ratio test, mutual best, one winner per target.
    Returns (C, K1) indices into f2's slots."""
    gate = _sq_dist(f2.xy, f1.xy) <= window * window
    gate &= (f1.level == 0)[:, :, None] & (f2.level == 0)[:, None, :]
    gate &= f2.valid[:, None, :] & f1.valid[:, :, None]
    return _nn(f1.desc, f1.desc_mask, f2.desc, f2.desc_mask, gate, params,
               max_dist=params.th_low, nn_ratio=nn_ratio, mutual=True)


def search_for_triangulation(f1: Features, f1_free: torch.Tensor,
                             f2: Features, f2_free: torch.Tensor,
                             E12: torch.Tensor, params: MatchParams,
                             epi_th: float = 1e-2) -> torch.Tensor:
    """SearchForTriangulationRaw (cORBmatcher.cpp:968-1155): brute-force
    matching within the same camera of both frames, gated by the
    per-camera essential E12 (C, 3, 3) on bearing rays (world-to-camera
    convention, se3_np.essential_from_poses) and by free slots, TH_LOW.
    Returns (C, K1) indices into f2's slots."""
    epi = epipolar_distance_sq(f1.ray[:, :, None, :], f2.ray[:, None, :, :],
                               E12[:, None, None])
    gate = epi < epi_th
    gate &= (f1.valid & f1_free)[:, :, None] & (f2.valid & f2_free)[:, None, :]
    return _nn(f1.desc, f1.desc_mask, f2.desc, f2.desc_mask, gate, params,
               max_dist=params.th_low)


def fuse_candidates(feats: Features, has_point: torch.Tensor,
                    pt_desc: torch.Tensor, pt_mask: torch.Tensor,
                    uv_pred: torch.Tensor, pred_ok: torch.Tensor,
                    pred_level: torch.Tensor, params: MatchParams,
                    th: float = 3.0, loose_desc: bool = False) -> torch.Tensor:
    """Fuse (cORBmatcher.cpp:1265-1420): candidate points (P, W) projected
    into the keyframe (C, P, ...) match the nearest slot within
    th * 1.2^level px and one octave either way, TH_LOW (TH_HIGH with
    ``loose_desc``). A match on an occupied slot means "merge", on a free
    one "add observation"; the caller reads ``has_point`` to decide.
    Returns (C, P) indices into the keyframe's slots."""
    sf = params.scale_factor
    desc_th = params.th_high if loose_desc else params.th_low
    C = feats.xy.shape[0]
    radius = th * sf ** pred_level.to(torch.float32)
    gate = _sq_dist(feats.xy, uv_pred) <= (radius ** 2)[..., None]
    flvl = feats.level[:, None, :]
    plvl = pred_level[:, :, None]
    gate &= (flvl >= plvl - 1) & (flvl <= plvl + 1)
    gate &= feats.valid[:, None, :] & pred_ok[:, :, None]
    q = pt_desc.expand((C,) + tuple(pt_desc.shape))
    qm = pt_mask.expand((C,) + tuple(pt_mask.shape))
    return _nn(q, qm, feats.desc, feats.desc_mask, gate, params, max_dist=desc_th)
