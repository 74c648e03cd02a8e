"""Projection-gated descriptor matching for the WORKING frame.

Port of ``match_frame_to_frame`` and ``match_local_map`` of
``multicol_slam_tpu/models/matcher.py`` (reference cORBmatcher.cpp:
1990-2110 and :67-166). Each search builds one boolean gate over
(camera, query, candidate) from the mode's rules, then one call to
``kernels.hamming_nn`` reduces all cameras at once to the best and
second-best gated Hamming distance per query, in place of the JAX
package's per-camera ``vmap`` over a distance matrix.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..kernels.hamming_nn import hamming_nn
from ..ops import hamming as hm
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


def _nn(q, q_mask, db, db_mask, gate, params: MatchParams, nn_ratio=None):
    masks = (q_mask.contiguous(), db_mask.contiguous()) if params.masked \
        else (None, None)
    idx, best, second = hamming_nn(q.contiguous(), db.contiguous(),
                                   gate.contiguous(), *masks)
    match = hm.nn_accept(idx, best, second, params.th_high, nn_ratio)
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
    return _nn(last.desc, last.desc_mask, cur.desc, cur.desc_mask, gate, params)


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
    return _nn(q, qm, feats.desc, feats.desc_mask, gate, params, nn_ratio)
