"""Gated descriptor matching: every search mode of the reference.

Port of ``multicol_slam_tpu/models/matcher.py`` (reference
cORBmatcher.cpp): ``match_frame_to_frame`` (:1990-2110),
``match_local_map`` (:67-166), ``window_search`` (:326-473),
``search_for_initialization`` (:579), ``search_for_triangulation``
(:968-1155), ``fuse_candidates`` (:1265-1420), the relocalization
``reloc_projection_match`` (:2120-2263) and ``search_by_bow`` (:179-323,
:885). Each search reduces the whole batch to the best and second-best
gated Hamming distance per query in one kernel call, in place of the JAX
package's per-camera ``vmap`` over a distance matrix. The searches gated
by a pixel window, a level window (or a vocabulary node) and validity
hand those per-row fields to ``kernels.hamming_nn_radius``, which builds
the gate inside the kernel; the epipolar-gated triangulation search
builds a boolean (batch, query, candidate) gate for
``kernels.hamming_nn``. Callers fold any leading batch axes (neighbour
keyframes, fuse targets, camera pairs) into the camera axis.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..kernels.hamming_nn import hamming_nn, hamming_nn_radius
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


def _radius_nn(q, q_mask, q_uv, q_r2, q_lvl_lo, q_lvl_hi, q_ok,
               db: Features, db_ok, params: MatchParams):
    """One ``hamming_nn_radius`` call: queries q (Cq, N, W) at q_uv with
    squared radius q_r2 and level window [q_lvl_lo, q_lvl_hi] against the
    slots of db where db_ok. Returns (idx, best, second), each (C, N)."""
    i32 = lambda t: t.to(torch.int32).contiguous()
    masks = (q_mask.contiguous(), db.desc_mask.contiguous()) if params.masked else ()
    return hamming_nn_radius(
        q.contiguous(), db.desc.contiguous(), q_uv.contiguous(), q_r2.contiguous(),
        i32(q_lvl_lo), i32(q_lvl_hi), q_ok.contiguous(), db.xy.contiguous(),
        i32(db.level), db_ok.contiguous(), *masks)


def _accept(idx, best, second, m: int, max_dist: int, nn_ratio: float | None = None):
    """Best per query row within ``max_dist``, the optional ratio test,
    then one winner per target column (hamming.py gated_nn_match +
    resolve_duplicate_targets)."""
    match = hm.nn_accept(idx, best, second, max_dist, nn_ratio)
    return hm.resolve_duplicate_targets(match, best, m)


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
    found = _radius_nn(last.desc, last.desc_mask, uv_pred, radius ** 2,
                       last.level - 1, last.level + 1,
                       last.valid & last_has_point & pred_ok,
                       cur, cur.valid & ~cur_has_point, params)
    return _accept(*found, cur.xy.shape[1], params.th_high)


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
    r = torch.where(view_cos > 0.998, 2.5, 4.0)
    radius = th * r * sf ** pred_level.to(torch.float32)          # (C, P)
    found = _radius_nn(pt_desc[None], pt_mask[None], uv_pred, radius ** 2,
                       pred_level - 1, pred_level, pred_ok,
                       feats, feats.valid & ~has_point, params)
    return _accept(*found, feats.xy.shape[1], params.th_high, nn_ratio)


def window_search(f1: Features, f2: Features, f1_select: torch.Tensor,
                  params: MatchParams, window: float = 100.0,
                  nn_ratio: float = 0.9, use_low_th: bool = False) -> torch.Tensor:
    """WindowSearch (cORBmatcher.cpp:326-473): each selected f1 slot
    matches the best f2 slot of the same camera within a coordinate
    window and the same octave, with the ratio test and TH_HIGH (TH_LOW
    with ``use_low_th``). Returns (C, K1) indices into f2's slots."""
    max_d = params.th_low if use_low_th else params.th_high
    r2 = f1.xy.new_full(f1.valid.shape, window * window)
    found = _radius_nn(f1.desc, f1.desc_mask, f1.xy, r2, f1.level, f1.level,
                       f1.valid & f1_select, f2, f2.valid, params)
    return _accept(*found, f2.xy.shape[1], max_d, nn_ratio)


def search_for_initialization(f1: Features, f2: Features, params: MatchParams,
                              window: float = 50.0,
                              nn_ratio: float = 0.9) -> torch.Tensor:
    """SearchForInitialization (cORBmatcher.cpp:579): window search at
    level 0 only, TH_LOW, ratio test, mutual best, one winner per target.
    The mutual check is the same search with the roles swapped (the
    window is symmetric, and (a - b)^2 == (b - a)^2 in IEEE arithmetic):
    the column's best row must be the row, ties to the lowest row as
    ``jnp.argmin``. Returns (C, K1) indices into f2's slots."""
    def search(fq: Features, fdb: Features):
        zero = torch.zeros_like(fq.level)
        return _radius_nn(fq.desc, fq.desc_mask, fq.xy,
                          fq.xy.new_full(fq.valid.shape, window * window), zero, zero,
                          fq.valid & (fq.level == 0), fdb, fdb.valid, params)

    idx, best, second = search(f1, f2)
    match = hm.nn_accept(idx, best, second, params.th_low, nn_ratio)
    col_best = search(f2, f1)[0]
    back = torch.gather(col_best, -1, torch.clamp(idx, min=0).long())
    rows = torch.arange(idx.shape[1], dtype=back.dtype, device=back.device)
    match = torch.where(back == rows, match, torch.full_like(match, -1))
    return hm.resolve_duplicate_targets(match, best, f2.xy.shape[1])


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
    masks = (f1.desc_mask.contiguous(), f2.desc_mask.contiguous()) if params.masked else ()
    found = hamming_nn(f1.desc.contiguous(), f2.desc.contiguous(), gate.contiguous(),
                       *masks)
    return _accept(*found, f2.xy.shape[1], params.th_low)


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
    radius = th * sf ** pred_level.to(torch.float32)
    found = _radius_nn(pt_desc[None], pt_mask[None], uv_pred, radius ** 2,
                       pred_level - 1, pred_level + 1, pred_ok, feats, feats.valid,
                       params)
    return _accept(*found, feats.xy.shape[1], desc_th)


def reloc_projection_match(feats: Features, has_point: torch.Tensor,
                           pt_desc: torch.Tensor, pt_mask: torch.Tensor,
                           uv_pred: torch.Tensor, pred_ok: torch.Tensor,
                           pred_level: torch.Tensor, params: MatchParams,
                           th: float = 10.0, orb_dist: int = 100) -> torch.Tensor:
    """SearchByProjection(F, KF, sAlreadyFound, th, ORBdist), the
    relocalization round (cORBmatcher.cpp:2120-2263): a candidate
    keyframe's points (P, W) projected at the refined pose (C, P, ...)
    match the nearest FREE frame slot within th * 1.2^level px and one
    octave either way, under the absolute descriptor gate ``orb_dist``, no
    ratio test. Points already found are excluded through ``pred_ok``.
    Returns (C, P) indices into the frame's slots."""
    sf = params.scale_factor
    radius = th * sf ** pred_level.to(torch.float32)
    found = _radius_nn(pt_desc[None], pt_mask[None], uv_pred, radius ** 2,
                       pred_level - 1, pred_level + 1, pred_ok, feats,
                       feats.valid & ~has_point, params)
    return _accept(*found, feats.xy.shape[1], orb_dist)


def search_by_bow(q_desc: torch.Tensor, q_ok: torch.Tensor, q_node: torch.Tensor,
                  db_desc: torch.Tensor, db_ok: torch.Tensor, db_node: torch.Tensor,
                  params: MatchParams, nn_ratio: float = 0.75) -> torch.Tensor:
    """SearchByBoW (cORBmatcher.cpp:179-323, :885): each query row (N, W)
    where q_ok matches the nearest database row (M, W) where db_ok in the
    same vocabulary node, TH_LOW, the ratio test, one winner per database
    row. The node gate runs in the kernel's level window: both bounds of
    a query row are its node, each database row's level is its node, and
    every pixel distance is 0 against a radius of +inf. The distance is
    unmasked even for mdBRIEF, as the JAX package's (loop_closing.py:267,
    :308). Returns (N,) indices into the database rows (-1 = none)."""
    N, M = q_desc.shape[0], db_desc.shape[0]
    q_uv = q_desc.new_zeros((1, N, 2), dtype=torch.float32)
    q_r2 = q_desc.new_full((1, N), float("inf"), dtype=torch.float32)
    node = q_node.to(torch.int32).reshape(1, N).contiguous()
    found = hamming_nn_radius(
        q_desc.reshape(1, N, -1).contiguous(), db_desc.reshape(1, M, -1).contiguous(),
        q_uv, q_r2, node, node, q_ok.reshape(1, N).contiguous(),
        db_desc.new_zeros((1, M, 2), dtype=torch.float32),
        db_node.to(torch.int32).reshape(1, M).contiguous(), db_ok.reshape(1, M).contiguous())
    return _accept(*found, M, params.th_low, nn_ratio)[0]
