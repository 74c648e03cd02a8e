"""The steady-state WORKING frame: extraction, motion-model tracking,
local-map tracking.

Port of the device half of ``multicol_slam_tpu/models/tracking.py``
(reference cTracking.cpp:790-888): ``frustum_check``,
``_motion_track_core``, ``_local_map_core``, ``working_track_step`` and
``working_scan_chunk``. The tracker's host state machine, map store and
keyframe policy are not ported yet. ``working_scan_chunk`` is a Python
loop over the frames with the same carry and the same stacked outputs
as the JAX package's ``lax.scan``.

Feature slots are K = n_features per camera here. The full system pads
to twice that for the initializer's slot space; the WORKING frame alone
has no initializer, so nothing is padded.
"""

from __future__ import annotations

import dataclasses

import torch

from ..ops.camera import world_to_img
from ..ops.geometry import cayley2hom, hom2cayley, inv_se3
from ..ops.rig import Rig, mt_mc
from . import matcher
from . import optimizer as opt
from .extractor import Features


def bucket(n: int, minimum: int = 64) -> int:
    """Round up to a power of two."""
    b = minimum
    while b < n:
        b *= 2
    return b


@dataclasses.dataclass
class TrackerConfig:
    """The WORKING frame's fields of the JAX package's TrackerConfig; the
    keyframe and relocalization fields come with the tracker's port."""

    motion_th: float = 15.0        # window scale for motion-model search
    local_map_th: float = 3.0      # SearchReferencePointsInFrustum th
    min_inliers_local: int = 15    # TrackLocalMap accept (:874-887)


def _cam_frame(rig: Rig, mt_min: torch.Tensor):
    """(M (C,4,4) camera-to-world, T (C,4,4) world-to-camera) at a pose."""
    M = mt_mc(cayley2hom(mt_min.to(torch.float32)), rig.M_c)
    return M, inv_se3(M)


def frustum_check(rig: Rig, mt_min: torch.Tensor, X: torch.Tensor,
                  normal: torch.Tensor, min_dist: torch.Tensor,
                  max_dist: torch.Tensor, n_levels: int = 8,
                  scale_factor: float = 1.2, dist_slack: float = 1.0):
    """cMultiFrame::isInFrustum per (camera, point) (cMultiFrame.cpp:
    218-270): z > 0, inside the image and (for mirror-masked cameras) the
    level-0 circle of radius v0+22 around (u0, v0), distance within
    [min, max], viewing cos > 0.5; the octave predicted from distance.
    X: (P, 3). Returns (uv (C,P,2), ok (C,P), level (C,P), view_cos (C,P))."""
    M, T = _cam_frame(rig, mt_min)
    Xc = torch.einsum("cij,pj->cpi", T[:, :3, :3], X) + T[:, None, :3, 3]
    cams = rig.cams.expand(1)
    uv = world_to_img(cams, Xc)
    centers = M[:, :3, 3]
    PO = X[None, :, :] - centers[:, None, :]
    dist = torch.linalg.norm(PO, dim=-1)
    view_cos = torch.einsum("cpi,pi->cp", PO, normal) / torch.clamp(dist, min=1e-9)
    ur = torch.round(uv[..., 0])
    vr = torch.round(uv[..., 1])
    cx, cy = cams.u0, cams.v0
    r = cy + 22.0
    in_circle = (ur - cx) ** 2 + (vr - cy) ** 2 < r * r
    in_img = ((ur > 0) & (ur < cams.width) & (vr > 0) & (vr < cams.height)
              & (in_circle | ~(cams.mirror > 0.5)))
    ok = ((Xc[..., 2] > 0) & in_img
          & (dist >= min_dist[None, :] / dist_slack)
          & (dist <= max_dist[None, :] * dist_slack)
          & (view_cos > 0.5))
    ratio = torch.clamp(max_dist[None, :] / torch.clamp(dist, min=1e-9), min=1e-9)
    # log(scale_factor) in float32, taken on the host: no device copy
    log_sf = torch.log(torch.tensor(scale_factor, dtype=torch.float32)).item()
    level = torch.ceil(torch.log(ratio) / log_sf).to(torch.int32)
    level = torch.clamp(level, 0, n_levels - 1)
    return uv, ok, level, view_cos


def _flat_obs(C: int, K: int, device):
    return torch.arange(C, dtype=torch.int32, device=device).repeat_interleave(K)


def _motion_track_core(rig: Rig, mt_pred: torch.Tensor, last_pts: torch.Tensor,
                       last_has: torch.Tensor, cur: Features, last: Features,
                       cur_has_pt: torch.Tensor, params: matcher.MatchParams,
                       th: float):
    """TrackWithMotionModel (cTracking.cpp:790-832 + cOptimizer.cpp:
    259-458): project the last frame's points at the predicted pose,
    match into the current frame, pose LM over the matches. Returns
    (match (C,K_last), mt, inlier (C,K_last), n_inliers, n_matches,
    n_lm_iters)."""
    _, T = _cam_frame(rig, mt_pred)
    Xc = torch.einsum("cij,ckj->cki", T[:, :3, :3], last_pts) + T[:, None, :3, 3]
    uv_pred = world_to_img(rig.cams.expand(1), Xc)
    ok = Xc[..., 2] > 0
    match = matcher.match_frame_to_frame(cur, last, last_has, cur_has_pt,
                                         uv_pred, ok, params, th=th)
    C, K = match.shape
    flat = match.reshape(-1)
    got = flat >= 0
    cam_ids = _flat_obs(C, K, flat.device)
    tgt = torch.clamp(flat, min=0)
    cl, tl = cam_ids.long(), tgt.long()
    lvl = cur.level[cl, tl].to(torch.float32)
    obs = opt.BAObservations(
        uv=cur.xy[cl, tl], kf=torch.zeros_like(flat), cam=cam_ids,
        pt=torch.arange(C * K, dtype=torch.int32, device=flat.device),
        inv_sigma2=torch.where(got, params.scale_factor ** (-2.0 * lvl),
                               torch.ones_like(lvl)),
        valid=got)
    mt, inlier, n_in, n_it = opt.pose_optimization(
        rig, mt_pred, obs, last_pts.reshape(-1, 3))
    return match, mt, inlier.reshape(C, K), n_in, got.sum(), n_it


def _local_map_core(rig: Rig, mt_cur: torch.Tensor, X: torch.Tensor,
                    normal: torch.Tensor, mind: torch.Tensor,
                    maxd: torch.Tensor, cand_ok: torch.Tensor,
                    pt_desc: torch.Tensor, pt_mask: torch.Tensor,
                    cur: Features, cur_has_pt: torch.Tensor,
                    slot_X: torch.Tensor, slot_has: torch.Tensor,
                    params: matcher.MatchParams, th: float, n_levels: int,
                    scale_factor: float):
    """TrackLocalMap (cTracking.cpp:834-888): frustum check over the local
    map, projection search into the frame, pose LM over the frame's
    existing associations plus the new matches. Returns (frustum_ok (C,P),
    match (C,P), mt, slot inliers (C,K), new-match inliers (C,P),
    n_inliers, n_lm_iters)."""
    uv, ok, lvl, vcos = frustum_check(rig, mt_cur, X, normal, mind, maxd,
                                      n_levels=n_levels,
                                      scale_factor=scale_factor)
    ok = ok & cand_ok[None, :]
    match = matcher.match_local_map(cur, cur_has_pt, pt_desc, pt_mask,
                                    uv, ok, lvl, vcos, params, th=th)
    C, K = cur_has_pt.shape
    P = X.shape[0]
    dev = X.device
    cam1 = _flat_obs(C, K, dev)
    lvl1 = cur.level.reshape(-1).to(torch.float32)
    flat2 = match.reshape(-1)
    got2 = flat2 >= 0
    cam2 = _flat_obs(C, P, dev)
    tgt2 = torch.clamp(flat2, min=0).long()
    uv2 = cur.xy[cam2.long(), tgt2]
    lvl2 = cur.level[cam2.long(), tgt2].to(torch.float32)
    obs = opt.BAObservations(
        uv=torch.cat([cur.xy.reshape(-1, 2), uv2], 0),
        kf=torch.zeros(C * (K + P), dtype=torch.int32, device=dev),
        cam=torch.cat([cam1, cam2], 0),
        pt=torch.arange(C * (K + P), dtype=torch.int32, device=dev),
        inv_sigma2=scale_factor ** (-2.0 * torch.cat([lvl1, lvl2], 0)),
        valid=torch.cat([slot_has.reshape(-1), got2], 0))
    X_all = torch.cat([slot_X.reshape(-1, 3), X.repeat(C, 1)], 0)
    mt, inlier, n_in, n_it = opt.pose_optimization(rig, mt_cur, obs, X_all)
    return (ok, match, mt, inlier[:C * K].reshape(C, K),
            inlier[C * K:].reshape(C, P), n_in, n_it)


def _scatter_rows(tgt: torch.Tensor, vals: torch.Tensor, fill, K: int):
    """Per camera, out[c, tgt[c, i]] = vals[c, i] into K slots; targets
    equal to K are dropped (the JAX package's mode="drop")."""
    C = tgt.shape[0]
    out = torch.full((C, K + 1) + tuple(vals.shape[2:]), fill,
                     dtype=vals.dtype, device=vals.device)
    rows = torch.arange(C, device=tgt.device)[:, None].expand_as(tgt)
    out[rows, tgt.long()] = vals
    return out[:, :K]


def working_track_step(extract_fn, rig: Rig, images: torch.Tensor,
                       mt_pred: torch.Tensor, last_pts: torch.Tensor,
                       last_has: torch.Tensor, last: Features,
                       lp_slot: torch.Tensor, X: torch.Tensor,
                       normal: torch.Tensor, mind: torch.Tensor,
                       maxd: torch.Tensor, cand_base: torch.Tensor,
                       pt_desc: torch.Tensor, pt_mask: torch.Tensor,
                       params: matcher.MatchParams, th_motion: float,
                       th_local: float, n_levels: int, scale_factor: float):
    """The whole WORKING frame: extraction (cMultiFrame.cpp:92-216),
    TrackWithMotionModel (cTracking.cpp:790-832) and TrackLocalMap
    (:834-888). The current frame's associations come from the motion
    matches that survive as inliers; a local-map point is no candidate
    when ``lp_slot`` (P, C), its last-frame slot per camera or -1, names
    a surviving slot.

    Returns (cur_feats, motion match, mt1, motion inliers, n_in1, n_m1,
    lm_iters1, frustum_ok, local match, mt2, slot inliers, new-match
    inliers, n_in2, lm_iters2)."""
    cur = extract_fn(images)
    m_out = _motion_track_core(rig, mt_pred, last_pts, last_has, cur, last,
                               torch.zeros_like(cur.valid), params,
                               th=th_motion)
    match1, mt1, inl1, n_in1, n_m1, it1 = m_out
    C, K = match1.shape
    keep = (match1 >= 0) & inl1
    tgt = torch.where(keep, torch.clamp(match1, min=0), torch.full_like(match1, K))
    slot_has = _scatter_rows(tgt, torch.ones_like(keep), False, K)
    slot_X = _scatter_rows(tgt, last_pts, 0.0, K)
    cidx = torch.arange(C, device=lp_slot.device)[None, :].expand_as(lp_slot)
    taken = (lp_slot >= 0) & keep[cidx, torch.clamp(lp_slot, min=0).long()]
    cand_ok = cand_base & ~taken.any(dim=1)
    l_out = _local_map_core(rig, mt1, X, normal, mind, maxd, cand_ok,
                            pt_desc, pt_mask, cur, slot_has, slot_X,
                            slot_has, params, th=th_local,
                            n_levels=n_levels, scale_factor=scale_factor)
    return (cur,) + tuple(m_out) + tuple(l_out)


def working_scan_chunk(extract_fn, rig: Rig, images: torch.Tensor,
                       mt0: torch.Tensor, V0: torch.Tensor, last: Features,
                       slot_X0: torch.Tensor, slot_lp0: torch.Tensor,
                       slot_has0: torch.Tensor, X: torch.Tensor,
                       normal: torch.Tensor, mind: torch.Tensor,
                       maxd: torch.Tensor, cand_base: torch.Tensor,
                       pt_desc: torch.Tensor, pt_mask: torch.Tensor,
                       params: matcher.MatchParams, th_motion: float,
                       th_local: float, n_levels: int, scale_factor: float):
    """B WORKING frames in a row: ``working_track_step`` plus the slot
    roll between frames (surviving motion inliers keep their landmark,
    new local-map inliers take free slots, V = M_last^-1 M_cur). Slots
    carry ``slot_lp``, an index into the frozen local-map snapshot.

    images: (B, C, H, W). Returns (carry, ys): carry is (last feats,
    slot_X, slot_lp, slot_has, mt, V) after the last frame; ys stacks
    per-frame mt (B, 6), lp / has (B, C, K), vis (B, cap), n_in1, n_m1,
    n_in2, it1, it2 (B,), and feats (Features of (B, C, K, ...))."""
    C, K = slot_has0.shape
    cap = X.shape[0]
    dev = X.device
    src_X = X[None].expand((C,) + tuple(X.shape))
    src_lp = torch.arange(cap, dtype=torch.int32, device=dev)[None].expand(C, cap)
    ar_k = torch.arange(K, dtype=torch.int32, device=dev)[None].expand(C, K)
    carry = (last, slot_X0, slot_lp0, slot_has0, mt0, V0)
    ys = []
    for img in images:
        last_f, slot_X, slot_lp, slot_has, mt, V = carry
        M_last = cayley2hom(mt)
        mt_pred = hom2cayley(M_last @ V)
        # inverse of slot_lp per camera: snapshot index -> slot (or -1)
        idx = torch.where(slot_lp >= 0, slot_lp, torch.full_like(slot_lp, cap))
        inv = torch.full((C, cap + 1), -1, dtype=torch.int32, device=dev)
        inv.scatter_(1, idx.long(), ar_k)
        lp_slot = inv[:, :cap].T.contiguous()                  # (cap, C)
        (cur, match1, mt1, inl1, n_in1, n_m1, it1,
         fr_ok, match2, mt2, inl_slot, inl_new, n_in2, it2) = working_track_step(
            extract_fn, rig, img, mt_pred, slot_X, slot_has, last_f,
            lp_slot, X, normal, mind, maxd, cand_base, pt_desc, pt_mask,
            params, th_motion=th_motion, th_local=th_local,
            n_levels=n_levels, scale_factor=scale_factor)
        keep = (match1 >= 0) & inl1 & slot_has
        tgt1 = torch.where(keep, torch.clamp(match1, min=0), torch.full_like(match1, K))
        sX1 = _scatter_rows(tgt1, slot_X, 0.0, K)
        slp1 = _scatter_rows(tgt1, slot_lp, -1, K)
        sh1 = _scatter_rows(tgt1, keep, False, K)
        got2 = (match2 >= 0) & inl_new
        tgt2 = torch.where(got2, torch.clamp(match2, min=0), torch.full_like(match2, K))
        sX2 = _scatter_rows(tgt2, src_X, 0.0, K)
        slp2 = _scatter_rows(tgt2, src_lp, -1, K)
        sh2 = _scatter_rows(tgt2, got2, False, K)
        keep_slot = sh1 & inl_slot
        nxt_X = torch.where(keep_slot[..., None], sX1, sX2)
        nxt_lp = torch.where(keep_slot, slp1, slp2)
        nxt_has = keep_slot | sh2
        V_new = inv_se3(M_last) @ cayley2hom(mt2)
        ys.append(dict(mt=mt2, lp=nxt_lp, has=nxt_has, vis=fr_ok.any(dim=0),
                       n_in1=n_in1, n_m1=n_m1, n_in2=n_in2, it1=it1, it2=it2,
                       feats=cur))
        carry = (cur, nxt_X, nxt_lp, nxt_has, mt2, V_new)
    stacked = {k: torch.stack([y[k] for y in ys]) for k in ys[0] if k != "feats"}
    stacked["feats"] = Features(*(torch.stack(fs) for fs in
                                  zip(*(y["feats"] for y in ys))))
    return carry, stacked
