"""Tracking front-end: the per-frame state machine (cTracking.{h,cpp}).

Port of ``multicol_slam_tpu/models/tracking.py`` (reference
cTracking.cpp:237-346): NO_IMAGES_YET -> NOT_INITIALIZED -> INITIALIZING
-> WORKING / LOST; motion-model tracking (pose predicted as M_last V,
:800), the previous-frame window search fallback (:724-788), local-map
tracking (:834-888), the keyframe decision (:890-938, with the MultiCol
baseline / depth > 0.2 rule :921) and the motion model V = M_last^-1
M_cur (:327-338).

The per-frame math (extraction, projection, matching, pose LM) runs on
the device in a few batched calls of static shape, C cameras x K slots;
the state machine, map bookkeeping and keyframe policy stay on the host,
and each stage's outputs come back in one fetch. Relocalization
(:1125-1312) draws BoW candidates, matches them, fits GP3P RANSAC and
the pose LM, with a projection second chance. ``working_scan_chunk`` is
a Python loop of ``working_scan_body`` over the frames with the same
carry and stacked outputs as the JAX package's ``lax.scan``;
``Tracker.track_chunk`` runs it over a chunk of steady-state frames and
replays the bookkeeping from one fetch.

On the card the tracker runs every device unit of its thread as a CUDA
graph (``utils/graphs.py``) in the shared pool, as the JAX package runs
them compiled: one capture per set of static arguments and input shapes
(the local map's bucket ``cap`` among them), one replay a call. Besides
``working_track_step`` and ``working_scan_body``: the standalone
extraction (``extract``, ``extract_init``), ``motion_track_step``,
``extract_motion_track_step``, ``window_search``, ``pose_optimization``,
``local_map_track_step``, the relocalization's projection round
(``reloc_projection_round``), ``initializer.initialize_device`` and
``ransac.ransac_gpnp`` (drawing from the tracker's generator, registered
with their graphs) and the BoW transform of a frame. The pose LM, the GP3P
RANSAC and the projection round pad to a fixed C * K rows, so one key
serves every call; ``Tracker.capture_ahead`` captures the keys of the
frames after the bootstrap and of a relocalization on the bootstrap's
frame. On the CPU the functions run eagerly.
"""

from __future__ import annotations

import contextlib
import dataclasses
import enum
from typing import Optional

import numpy as np
import torch

from ..ops import ransac, se3_np
from ..ops.camera import world_to_img
from ..ops.geometry import cayley2hom, hom2cayley, inv_se3
from ..ops.rig import Rig, mt_mc
from ..utils import graphs
from ..utils.timing import StageTimers, span
from . import initializer, matcher
from . import optimizer as opt
from .extractor import Features
from .map import MapStore
from .vocabulary import transform_words


class TrackState(enum.Enum):
    NO_IMAGES_YET = 0
    NOT_INITIALIZED = 1
    INITIALIZING = 2
    WORKING = 3
    LOST = 4


def bucket(n: int, minimum: int = 64) -> int:
    """Round up to a power of two."""
    b = minimum
    while b < n:
        b *= 2
    return b


@dataclasses.dataclass
class TrackerConfig:
    n_features: int = 400
    desc_bytes: int = 32
    masked: bool = False
    scale_factor: float = 1.2
    n_levels: int = 8
    fps: float = 25.0
    use_motion_model: bool = True
    motion_th: float = 15.0        # window scale for motion-model search
    local_map_th: float = 3.0      # SearchReferencePointsInFrustum th
    min_inliers_track: int = 10    # TrackWithMotionModel accept
    min_inliers_local: int = 15    # TrackLocalMap accept (:874-887)
    kf_tracked_ratio: float = 0.9  # NeedNewKeyFrame ref-ratio condition
    kf_min_points: int = 50
    baseline_depth_ratio: float = 0.2  # curBaseline2MKF gate (:921)
    # widened-window projection re-match after a weak relocalization fit
    reloc_second_chance: bool = True

    @property
    def min_frames(self) -> int:
        return int(self.fps / 3.0)   # cTracking.cpp:93

    @property
    def max_frames(self) -> int:
        return int(2 * self.fps / 3.0)


def _cam_frame(rig: Rig, mt_min: torch.Tensor):
    """(M (C,4,4) camera-to-world, T (C,4,4) world-to-camera) at a pose."""
    M = mt_mc(cayley2hom(mt_min.to(torch.float32)), rig.M_c)
    return M, inv_se3(M)


def project_slots(rig: Rig, mt_min: torch.Tensor, X: torch.Tensor):
    """Project per-slot world points X (C, K, 3) into their own camera.
    Returns uv (C, K, 2) and ok = (z > 0) (C, K)."""
    _, T = _cam_frame(rig, mt_min)
    Xc = torch.einsum("cij,ckj->cki", T[:, :3, :3], X) + T[:, None, :3, 3]
    return world_to_img(rig.cams.expand(1), Xc), Xc[..., 2] > 0


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


def reloc_projection_round(rig: Rig, mt: torch.Tensor, X: torch.Tensor,
                           normal: torch.Tensor, min_dist: torch.Tensor,
                           max_dist: torch.Tensor, cand_ok: torch.Tensor,
                           cur: Features, cur_has_pt: torch.Tensor,
                           pt_desc: torch.Tensor, pt_mask: torch.Tensor,
                           params: matcher.MatchParams, th: float, orb_dist: int,
                           n_levels: int, scale_factor: float) -> torch.Tensor:
    """The relocalization's projection round (cORBmatcher.cpp:2120-2263):
    candidate landmarks X (P, 3), those with ``cand_ok`` (the real rows of
    a padded batch), checked against the frustum at the refined pose with
    a 4x distance slack, then matched into the frame's free slots
    (``matcher.reloc_projection_match``). Returns (C, P) slot indices."""
    uv, ok, lvl, _ = frustum_check(rig, mt, X, normal, min_dist, max_dist,
                                   n_levels=n_levels, scale_factor=scale_factor,
                                   dist_slack=4.0)
    ok = ok & cand_ok[None, :]
    return matcher.reloc_projection_match(cur, cur_has_pt, pt_desc, pt_mask, uv, ok,
                                          lvl, params, th=th, orb_dist=orb_dist)


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


motion_track_step = _motion_track_core


def extract_motion_track_step(extract_fn, rig: Rig, images: torch.Tensor,
                              mt_pred: torch.Tensor, last_pts: torch.Tensor,
                              last_has: torch.Tensor, last: Features,
                              params: matcher.MatchParams, th: float):
    """Extraction (cMultiFrame.cpp:92-216) then the whole of
    TrackWithMotionModel; the current frame has no associations yet, so
    every slot is free. Returns (cur_feats,) + _motion_track_core's
    outputs."""
    cur = extract_fn(images)
    out = _motion_track_core(rig, mt_pred, last_pts, last_has, cur, last,
                             torch.zeros_like(cur.valid), params, th=th)
    return (cur,) + tuple(out)


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


local_map_track_step = _local_map_core


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


def scan_step_inputs(carry, cap: int):
    """What a scan step feeds ``working_track_step`` from the carry
    (last feats, slot_X, slot_lp, slot_has, mt, V): (M_last (4, 4), the
    predicted pose mt_pred = M_last V (6,), lp_slot (cap, C), per camera
    the inverse of slot_lp: snapshot index -> slot, or -1)."""
    _, _, slot_lp, _, mt, V = carry
    C, K = slot_lp.shape
    dev = slot_lp.device
    M_last = cayley2hom(mt)
    mt_pred = hom2cayley(M_last @ V)
    ar_k = torch.arange(K, dtype=torch.int32, device=dev)[None].expand(C, K)
    idx = torch.where(slot_lp >= 0, slot_lp, torch.full_like(slot_lp, cap))
    inv = torch.full((C, cap + 1), -1, dtype=torch.int32, device=dev)
    inv.scatter_(1, idx.long(), ar_k)
    return M_last, mt_pred, inv[:, :cap].T.contiguous()


def slot_roll(carry, step_out, X: torch.Tensor, M_last: torch.Tensor):
    """The carry after a scan step (surviving motion inliers keep their
    landmark, new local-map inliers take free slots, V = M_last^-1 M_cur)
    and the step's per-frame outputs y: mt (6,), lp / has (C, K), vis
    (cap,), n_in1, n_m1, n_in2, it1, it2 and feats (the frame's
    Features). ``step_out``: ``working_track_step``'s outputs."""
    _, slot_X, slot_lp, slot_has, _, _ = carry
    (cur, match1, _, inl1, n_in1, n_m1, it1,
     fr_ok, match2, mt2, inl_slot, inl_new, n_in2, it2) = step_out
    C, K = slot_has.shape
    cap = X.shape[0]
    src_X = X[None].expand((C,) + tuple(X.shape))
    src_lp = torch.arange(cap, dtype=torch.int32, device=X.device)[None].expand(C, cap)
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
    y = dict(mt=mt2, lp=nxt_lp, has=nxt_has, vis=fr_ok.any(dim=0),
             n_in1=n_in1, n_m1=n_m1, n_in2=n_in2, it1=it1, it2=it2, feats=cur)
    return (cur, nxt_X, nxt_lp, nxt_has, mt2, V_new), y


def working_scan_body(extract_fn, rig: Rig, img: torch.Tensor, carry,
                      X: torch.Tensor, normal: torch.Tensor, mind: torch.Tensor,
                      maxd: torch.Tensor, cand_base: torch.Tensor,
                      pt_desc: torch.Tensor, pt_mask: torch.Tensor,
                      params: matcher.MatchParams, th_motion: float,
                      th_local: float, n_levels: int, scale_factor: float):
    """One frame of ``working_scan_chunk`` (the body of the JAX package's
    ``lax.scan``): ``working_track_step`` from the carry, then the slot
    roll. Slots carry ``slot_lp``, an index into the frozen local-map
    snapshot.

    img: (C, H, W); carry: (last feats, slot_X (C, K, 3), slot_lp (C, K),
    slot_has (C, K), mt (6,), V (4, 4)). Returns ``slot_roll``'s (carry
    after the frame, y)."""
    M_last, mt_pred, lp_slot = scan_step_inputs(carry, X.shape[0])
    last_f, slot_X, _, slot_has, _, _ = carry
    out = working_track_step(
        extract_fn, rig, img, mt_pred, slot_X, slot_has, last_f,
        lp_slot, X, normal, mind, maxd, cand_base, pt_desc, pt_mask,
        params, th_motion=th_motion, th_local=th_local,
        n_levels=n_levels, scale_factor=scale_factor)
    return slot_roll(carry, out, X, M_last)


def working_scan_chunk(extract_fn, rig: Rig, images: torch.Tensor,
                       mt0: torch.Tensor, V0: torch.Tensor, last: Features,
                       slot_X0: torch.Tensor, slot_lp0: torch.Tensor,
                       slot_has0: torch.Tensor, X: torch.Tensor,
                       normal: torch.Tensor, mind: torch.Tensor,
                       maxd: torch.Tensor, cand_base: torch.Tensor,
                       pt_desc: torch.Tensor, pt_mask: torch.Tensor,
                       params: matcher.MatchParams, th_motion: float,
                       th_local: float, n_levels: int, scale_factor: float,
                       body=working_scan_body):
    """B WORKING frames in a row: ``body`` (``working_scan_body``, or its
    CUDA graph on the card) once per frame, the carry threaded through.

    images: (B, C, H, W). Returns (carry, ys): carry is (last feats,
    slot_X, slot_lp, slot_has, mt, V) after the last frame; ys stacks
    per-frame mt (B, 6), lp / has (B, C, K), vis (B, cap), n_in1, n_m1,
    n_in2, it1, it2 (B,), and feats (Features of (B, C, K, ...))."""
    carry = (last, slot_X0, slot_lp0, slot_has0, mt0, V0)
    ys = []
    for img in images:
        carry, y = body(extract_fn, rig, img, carry, X, normal, mind, maxd,
                        cand_base, pt_desc, pt_mask, params, th_motion=th_motion,
                        th_local=th_local, n_levels=n_levels,
                        scale_factor=scale_factor)
        ys.append(y)
    stacked = {k: torch.stack([y[k] for y in ys]) for k in ys[0] if k != "feats"}
    stacked["feats"] = Features(*(torch.stack(fs) for fs in
                                  zip(*(y["feats"] for y in ys))))
    return carry, stacked


# the Tracker's device units (attribute names): graphs.jit on the card
UNIT_NAMES = ("_working_step", "_scan_body", "_extract_unit", "_extract_init_unit",
              "_motion_step", "_extract_motion_step", "_window_search", "_pose_opt",
              "_local_map_step", "_reloc_projection", "_init_device", "_gpnp",
              "bow_transform")


def fetch(*tensors):
    """One fetch of a stage's device outputs as numpy arrays."""
    return tuple(t.detach().cpu().numpy() for t in tensors)


def to_device(a, device, dtype=None) -> torch.Tensor:
    """Host array -> device tensor: uint32 words travel as int32 bits and
    float64 as float32 (the JAX package's ``jnp.asarray`` with x64 off)."""
    a = np.asarray(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    elif dtype is None and a.dtype == np.float64:
        dtype = torch.float32
    return torch.as_tensor(a, dtype=dtype, device=device)


class Tracker:
    """Host-side tracking orchestration, one per SLAM session. Device
    tensors live on the rig's device; the map and the state machine are
    host numpy."""

    def __init__(self, rig: Rig, extract_fn, extract_init_fn,
                 map_store: MapStore, cfg: TrackerConfig):
        self.rig = rig
        self.dev = rig.M_c.device
        self.extract = extract_fn
        self.extract_init = extract_init_fn or extract_fn
        self.map = map_store
        self.cfg = cfg
        self.params = matcher.MatchParams(
            desc_bytes=cfg.desc_bytes, masked=cfg.masked,
            scale_factor=cfg.scale_factor)
        self.state = TrackState.NO_IMAGES_YET
        # the device units of the tracker's thread: CUDA graphs of the
        # shared pool on the card (the JAX package's jax.jit), eager on the
        # CPU. The fused step and the scan body take the raw extractor as a
        # static argument; the standalone extraction has graphs of its own
        unit = graphs.jit if self.dev.type == "cuda" else (lambda f: f)
        self._working_step = unit(working_track_step)
        self._scan_body = unit(working_scan_body)
        self._extract_unit = unit(self.extract)
        self._extract_init_unit = unit(self.extract_init)
        self._motion_step = unit(motion_track_step)
        self._extract_motion_step = unit(extract_motion_track_step)
        self._window_search = unit(matcher.window_search)
        self._pose_opt = unit(opt.pose_optimization)
        self._local_map_step = unit(local_map_track_step)
        self._reloc_projection = unit(reloc_projection_round)
        self._init_device = unit(initializer.initialize_device)
        self._gpnp = unit(ransac.ransac_gpnp)
        # the BoW transform of a frame (relocalization candidates and
        # SearchByBoW); the system hands it to the loop closer
        self.bow_transform = unit(transform_words)
        # RANSAC's sampling stream (the JAX package's PRNGKey(42)); the
        # graphed RANSAC units register it
        self.gen = torch.Generator(device=self.dev).manual_seed(42)
        self._M_c_np = rig.M_c.detach().cpu().numpy().astype(np.float64)

        self.frame_id = -1
        self.last_kf_id = -1
        self.last_reloc_frame = -1000
        self.velocity: Optional[np.ndarray] = None   # 4x4 V = M_last^-1 M_cur

        # current / last frame data
        self.cur_feats: Optional[Features] = None
        self.cur_pt: Optional[np.ndarray] = None     # (C, K) map point ids
        self.cur_outlier: Optional[np.ndarray] = None
        self.cur_mt = np.zeros(6)
        self.last_feats: Optional[Features] = None
        self.last_pt: Optional[np.ndarray] = None
        self.last_outlier: Optional[np.ndarray] = None
        self.last_mt = np.zeros(6)

        self.init_ref_feats: Optional[Features] = None

        # eval vectors (cTracking.h:114-121)
        self.all_poses: list[np.ndarray] = []
        self.timestamps: list[float] = []
        self.n_tracked: list[int] = []
        # device stages issued per frame
        self.dispatches_per_frame: list[int] = []
        self._dispatch_n = 0
        # per-stage timings (cTracking.h:119-121)
        self.timers = StageTimers()
        # per chunk scan (track_chunk): (frames, seconds of the scan and its
        # fetch, whether the scan body captured a graph in it); a chunk that
        # captured paid the warm-up and the capture
        self.chunk_scans: list[tuple[int, float, bool]] = []

        # callbacks wired by the System
        self.on_new_keyframe = None        # fn(kf_id)
        self.on_init_keyframes = None      # fn(kf0, kf1): sync bootstrap
        # async mapping's back-pressure (cTracking.cpp:922-935): a keyframe
        # is inserted only while the mapper can accept one; otherwise the
        # tracker asks its running pass to yield (InterruptBA) and retries
        # on the next frame
        self.mapper_idle_fn = None         # fn() -> bool
        self.interrupt_ba_fn = None        # fn(): LocalMapping::InterruptBA
        self.on_reset = None               # fn(): reset fan-out
        self.reloc_candidates_fn = None    # fn(Features) -> [kf] (BoW)
        self.reloc_bow_match_fn = None     # fn(kf, Features) -> [(pt, c, s)]
        # fn(Features): the BoW transforms of a relocalizing frame, run on
        # a frame's features by capture_ahead (wired with the loop closer)
        self.reloc_transform_ahead_fn = None
        # what capture_ahead captured, and the units that captured on a
        # later frame: (frame id, unit name, captures)
        self.captured_ahead: list[str] = []
        self.late_captures: list[tuple[int, str, int]] = []
        # the next frame relocalizes (the loop closer sets it after moving
        # the map, cLoopClosing.cpp:575)
        self.force_reloc = False
        # device-resident local-map snapshot cache, reused while the map is
        # unchanged and the vote selects the same points; the System flips
        # map_dirty after every mapping pass, loop correction and reset
        self.map_dirty = True
        self._snap_cache = None
        # per-frame path taken (fused / fused_weak / velocity / reloc /
        # reloc_recent / init / ...)
        self.frame_path: list[str] = []
        # fault injection: fn(mt_min6, frame_id) -> mt_min6 applied after a
        # successful track and before the keyframe decision, so keyframes
        # and points inherit the error as they would real drift (the loop
        # tests' drift)
        self.perturb_pose_fn = None

    # ------------------------------------------------------------------

    def _to_dev(self, a, dtype=None) -> torch.Tensor:
        return to_device(a, self.dev, dtype)

    def _sync(self):
        # this thread's stream only: the async mapper's stream runs on
        if self.dev.type == "cuda":
            torch.cuda.current_stream(self.dev).synchronize()

    def units(self) -> dict:
        """The tracker's device units by attribute name (graphs on the card)."""
        return {name: getattr(self, name) for name in UNIT_NAMES}

    def _unit_captures(self) -> dict:
        return {name: u.captures for name, u in self.units().items()
                if isinstance(u, graphs.jit)}

    def track(self, images, timestamp: float) -> Optional[np.ndarray]:
        """Main entry (cTracking::GrabImageSet + Track). ``images``:
        (C, H, W) uint8 or float. Returns the estimated M_t (4x4) or None
        while not tracking. After the capture-ahead, a unit that captures a
        graph on a frame is noted in ``late_captures``."""
        with self._noting_late_captures():
            return self._track(images, timestamp)

    @contextlib.contextmanager
    def _noting_late_captures(self):
        """Note in ``late_captures`` the units that captured inside the
        block, once the capture-ahead has run."""
        before, ahead = self._unit_captures(), bool(self.captured_ahead)
        try:
            yield
        finally:
            if ahead:
                after = self._unit_captures()
                self.late_captures += [(self.frame_id, name, after[name] - n)
                                       for name, n in before.items()
                                       if after.get(name, n) > n]

    def _track(self, images, timestamp: float) -> Optional[np.ndarray]:
        images = torch.as_tensor(images, device=self.dev)
        self.frame_id += 1
        C, K = self.map.kf_pt.shape[1], self.map.kf_pt.shape[2]
        self._dispatch_n = 0

        self.cur_pt = np.full((C, K), -1, np.int32)
        self.cur_outlier = np.zeros((C, K), bool)

        # WORKING + motion model: extraction runs inside the fused step,
        # so decide before extracting (the gather reads last-frame state).
        # force_reloc is read once per frame, so the decision and the
        # branch below agree
        forced = self.force_reloc
        motion_in = None
        lm_in = None
        why = "state"
        if self.state == TrackState.WORKING and not forced:
            why = ("velocity" if self.velocity is None else
                   "reloc_recent" if self.frame_id < self.last_reloc_frame + 2 else "")
        if (self.state == TrackState.WORKING and not forced
                and self.velocity is not None and self.cfg.use_motion_model
                and self.frame_id >= self.last_reloc_frame + 2):
            pts, has = self._gather_last_slot_points()
            if has.sum() < 20:
                why = f"thin_carry:{int(has.sum())}"
            else:
                motion_in = (pts, has)
                # local map voted by the last frame's associations
                # (UpdateReferenceKeyFrames counts every non-bad point,
                # cTracking.cpp:1055-1075)
                lm_in = self._local_map_snapshot(self.last_pt)

        if motion_in is None:
            with self.timers.time("feature_extraction"):
                self._dispatch_n += 1
                if self.state in (TrackState.NO_IMAGES_YET,
                                  TrackState.NOT_INITIALIZED,
                                  TrackState.INITIALIZING):
                    feats = self._extract_init_unit(images)
                else:
                    feats = self._extract_unit(images)
                self._sync()
            self.cur_feats = feats

        if self.state == TrackState.NO_IMAGES_YET:
            self.state = TrackState.NOT_INITIALIZED

        if self.state == TrackState.NOT_INITIALIZED:
            self.frame_path.append("init")
            self._first_initialization()
        elif self.state == TrackState.INITIALIZING:
            self.frame_path.append("init")
            self._try_initialize()
            if self.state == TrackState.WORKING:
                self.capture_ahead(images)
        else:
            ok = False
            fused_done = False
            if self.state == TrackState.WORKING and not forced:
                tried_fused = motion_in is not None and lm_in is not None
                if tried_fused:
                    with self.timers.time("working_fused"):
                        r = self._track_working_fused(motion_in, lm_in, images)
                    if r is not None:
                        ok, fused_done = r, True
                self.frame_path.append(
                    "fused" if fused_done else
                    "fused_weak" if tried_fused else
                    (why or "no_snapshot"))
                if not fused_done:
                    with self.timers.time("initial_pose_estimation"):
                        if not tried_fused and motion_in is not None:
                            ok = self._track_with_motion_model(motion_in, images)
                        if not ok:
                            ok = self._track_previous_frame()
            else:
                self.frame_path.append("reloc")
                with self.timers.time("initial_pose_estimation"), span("tracker.relocalize"):
                    ok = self._relocalize()
                if ok and forced == self.force_reloc:
                    self.force_reloc = False

            if ok and not fused_done:
                with self.timers.time("track_local_map"):
                    ok = self._track_local_map()

            if ok:
                self.state = TrackState.WORKING
                if self.perturb_pose_fn is not None:
                    self.cur_mt = np.asarray(self.perturb_pose_fn(self.cur_mt, self.frame_id))
                if self._need_new_keyframe():
                    self._create_new_keyframe()
                # motion model V = M_last^-1 M_cur (cTracking.cpp:327-338)
                M_last = se3_np.cayley2hom(self.last_mt)
                M_cur = se3_np.cayley2hom(self.cur_mt)
                self.velocity = np.linalg.inv(M_last) @ M_cur
            else:
                self.state = TrackState.LOST
                self.velocity = None
                # reset if the map is young (cTracking.cpp:317-324)
                if self.map.n_keyframes() <= 3:
                    self.dispatches_per_frame.append(self._dispatch_n)
                    self.reset()
                    return None

        self.dispatches_per_frame.append(self._dispatch_n)
        # roll frame state
        self.last_feats = self.cur_feats
        self.last_pt = self.cur_pt
        self.last_outlier = self.cur_outlier
        self.last_mt = self.cur_mt.copy()
        if self.state == TrackState.WORKING:
            M = se3_np.cayley2hom(self.cur_mt)
            self.all_poses.append(M)
            self.timestamps.append(timestamp)
            return M
        return None

    # ------------------------------------------------------------------
    # initialization
    # ------------------------------------------------------------------

    def _first_initialization(self):
        """cTracking::FirstInitialization (:375-391): >= 100 keypoints."""
        if int(self.cur_feats.valid.sum()) >= initializer.MIN_MATCHES:
            self.init_ref_feats = self.cur_feats
            self.cur_mt = np.zeros(6)
            self.state = TrackState.INITIALIZING

    def _try_initialize(self):
        feats = self.cur_feats
        if int(feats.valid.sum()) < initializer.MIN_MATCHES:
            self.state = TrackState.NOT_INITIALIZED
            return
        cand = self._init_device(self.gen, self.rig, self.init_ref_feats, feats,
                                 self.params)
        cand = initializer.InitCandidate(*fetch(*cand))
        if int((cand.match_idx >= 0).sum()) < initializer.MIN_MATCHES:
            self.state = TrackState.NOT_INITIALIZED
            return
        res = initializer.pick_leading_camera(cand, self.rig)
        if res is None:
            return  # keep trying with the same reference
        self._create_initial_map(res)

    def _create_initial_map(self, res: initializer.InitResult):
        """cTracking::CreateInitialMap (:439-722): two keyframes and the
        lead camera's points; the mapper adds cross-camera points and
        refines the poses by BA."""
        m = self.map
        kf0 = m.alloc_keyframe(res.mt_ref, self.init_ref_feats,
                               self.frame_id - 1)
        kf1 = m.alloc_keyframe(res.mt_cur, self.cur_feats, self.frame_id)

        ids = m.alloc_points(len(res.X_world))
        m.pt_pos[ids] = res.X_world.astype(np.float32)
        m.pt_first_kf[ids] = kf0
        lead = res.lead_cam
        for i, p in enumerate(ids):
            m.add_observation(int(p), kf0, lead, int(res.ref_slots[i]))
            m.add_observation(int(p), kf1, lead, int(res.cur_slots[i]))
        m.update_point_stats(ids, self._M_c_np,
                             self.cfg.scale_factor, self.cfg.n_levels)
        m.update_spanning_tree(kf1)

        self.cur_pt[lead, res.cur_slots] = ids
        self.cur_mt = res.mt_cur.copy()
        self.last_kf_id = kf1
        self.state = TrackState.WORKING
        self.velocity = None
        # the two bootstrap keyframes are mapped before the next frame:
        # their first BA fixes the metric scale (cTracking.cpp:439-722)
        if self.on_init_keyframes:
            self.on_init_keyframes(kf0, kf1)
        elif self.on_new_keyframe:
            self.on_new_keyframe(kf0)
            self.on_new_keyframe(kf1)
        if self.on_init_keyframes or self.on_new_keyframe:
            self.cur_mt = m.kf_pose[kf1].copy()

    def capture_ahead(self, images):
        """On the card, once, on the frame that built the initial map (after
        its mapping passes): capture the keys the next frames and a
        relocalization need, on this frame's own images, features and
        associations, the results discarded: the standalone extraction,
        the previous-frame window search, the pose LM (C * K rows), the
        local-map step at the tracking window and at the second chance's
        (the current snapshot's cap), the WORKING step and the chunk scan's
        body at the tracking thresholds and that cap (this frame tracked
        from the reference keyframe), the GP3P RANSAC and the projection
        round (C * K rows) and, when a loop closer is wired, the frame's BoW
        transforms. ``gen``'s state is restored after it, so the run draws
        what an eager run draws; the map and the tracker's state are left as
        they were. A key that depends on the map's size (a later local map's
        cap) or a retrained vocabulary can still capture on a later frame
        (``late_captures``)."""
        if not isinstance(self._pose_opt, graphs.jit) or self.captured_ahead:
            return
        before = self._unit_captures()
        state = self.gen.get_state()
        m = self.map
        try:
            self._extract_unit(images)
            has = self.cur_pt >= 0
            has_t = self._to_dev(has)
            self._window_search(self.cur_feats, self.cur_feats, has_t, self.params,
                                window=200.0, nn_ratio=0.9)
            cam_idx, slot_idx = np.nonzero(has)
            pids = self.cur_pt[cam_idx, slot_idx]
            self._pose_opt(*self._pose_lm_inputs(self.cur_mt, cam_idx, slot_idx, pids))
            self._gpnp(self.gen, *self._gpnp_inputs(cam_idx, slot_idx, m.pt_pos[pids]),
                       n_hyps=256)
            self._reloc_projection(*self._projection_inputs(np.unique(pids)))
            snap = self._local_map_snapshot()
            if snap is not None:
                local_pts, cap, arrs = snap
                slot_X = np.zeros(self.cur_pt.shape + (3,), np.float32)
                slot_X[has] = m.pt_pos[self.cur_pt[has]]
                cand_ok = self._to_dev(np.arange(cap) < len(local_pts))
                for th in (self.cfg.local_map_th, 10.0):
                    self._local_map_step(
                        self.rig, self._to_dev(self.cur_mt, torch.float32), arrs["X"],
                        arrs["normal"], arrs["mind"], arrs["maxd"], cand_ok, arrs["desc"],
                        arrs["dmask"], self.cur_feats, has_t, self._to_dev(slot_X), has_t,
                        self.params, th=th, n_levels=self.cfg.n_levels,
                        scale_factor=self.cfg.scale_factor)
                # the WORKING step and the chunk scan's body at the tracking
                # thresholds and this cap, tracking this frame from the
                # reference keyframe at this frame's pose (its own features
                # as the last frame would match themselves exactly)
                ref = min((k for k in m.keyframe_ids().tolist() if k != self.last_kf_id),
                          key=lambda k: m.kf_frame_id[k], default=self.last_kf_id)
                ref_pt = m.kf_pt[ref]
                ref_has = ref_pt >= 0
                ref_X = np.zeros(ref_pt.shape + (3,), np.float32)
                ref_X[ref_has] = m.pt_pos[ref_pt[ref_has]]
                last = m.kf_features[ref]
                local = (arrs["X"], arrs["normal"], arrs["mind"], arrs["maxd"],
                         arrs["cand_base"], arrs["desc"], arrs["dmask"], self.params)
                thresholds = dict(th_motion=self.cfg.motion_th, th_local=self.cfg.local_map_th,
                                  n_levels=self.cfg.n_levels,
                                  scale_factor=self.cfg.scale_factor)
                self._working_step(
                    self.extract, self.rig, images, self._to_dev(self.cur_mt),
                    self._to_dev(ref_X), self._to_dev(ref_has), last,
                    self._to_dev(self._slot_lookup(ref_pt, ref_has, local_pts, cap)),
                    *local, **thresholds)
                slot_lp, carried = self._snapshot_slots(ref_pt, ref_has, local_pts)
                carry = (last, self._to_dev(ref_X), self._to_dev(slot_lp),
                         self._to_dev(carried), self._to_dev(self.cur_mt, torch.float32),
                         self._to_dev(np.eye(4), torch.float32))
                self._scan_body(self.extract, self.rig, images, carry, *local, **thresholds)
            if self.reloc_transform_ahead_fn is not None:
                self.reloc_transform_ahead_fn(self.cur_feats)
        finally:
            self.gen.set_state(state)
        after = self._unit_captures()
        self.captured_ahead = [name for name, n in before.items() if after[name] > n]

    # ------------------------------------------------------------------
    # frame-to-frame tracking
    # ------------------------------------------------------------------

    def _gather_last_slot_points(self):
        """(C, K, 3) world position per last-frame slot (zeros if none)
        and the slots that carry a live, first-in-camera landmark."""
        C, K = self.last_pt.shape
        # follow merge forwarding first (the mapper may have fused points)
        self.last_pt = self.map.resolve_points(self.last_pt)
        pts = np.zeros((C, K, 3), np.float32)
        has = (self.last_pt >= 0) & ~self.last_outlier
        ids = self.last_pt[has]
        pts[has] = self.map.pt_pos[ids]
        alive = np.zeros((C, K), bool)
        alive[has] = self.map.pt_valid[ids]
        # dedupe: merge forwarding can leave one landmark in two slots of
        # a camera; keep the first so it votes once and lp_slot is exact
        for c in range(C):
            idx = np.nonzero(alive[c])[0]
            if len(idx) == 0:
                continue
            _, first = np.unique(self.last_pt[c, idx], return_index=True)
            dup = np.ones(len(idx), bool)
            dup[first] = False
            alive[c, idx[dup]] = False
        return pts, alive

    def _apply_motion_matches(self, match, inlier):
        """Assign matched points to current slots and discard LM outliers
        (the reference nulls them after TrackWithMotionModel,
        cTracking.cpp:817-830)."""
        for c in range(match.shape[0]):
            sel = np.nonzero(match[c] >= 0)[0]
            self.cur_pt[c, match[c, sel]] = self.last_pt[c, sel]
            bad = sel[~inlier[c, sel]]
            self.cur_pt[c, match[c, bad]] = -1

    def _track_with_motion_model(self, gathered=None, images=None) -> bool:
        """cTracking::TrackWithMotionModel (:790-832): extraction (when
        ``images`` is given), projection, matching and pose LM on the
        device, one fetch of the outputs."""
        M_last = se3_np.cayley2hom(self.last_mt)
        mt_pred = se3_np.hom2cayley(M_last @ self.velocity)

        if gathered is None:
            gathered = self._gather_last_slot_points()
            if gathered[1].sum() < 20:
                return False
        pts, has = gathered
        self._dispatch_n += 1
        if images is not None:
            out = self._extract_motion_step(
                self.extract, self.rig, images, self._to_dev(mt_pred),
                self._to_dev(pts), self._to_dev(has), self.last_feats,
                self.params, th=self.cfg.motion_th)
            self.cur_feats = out[0]
            out = out[1:]
        else:
            out = self._motion_step(
                self.rig, self._to_dev(mt_pred), self._to_dev(pts),
                self._to_dev(has), self.cur_feats, self.last_feats,
                self._to_dev(self.cur_pt >= 0), self.params,
                th=self.cfg.motion_th)
        match, mt, inlier, n_in, n_matches, _ = fetch(*out)
        n_matches = int(n_matches)
        if n_matches < 20:
            return False
        self._apply_motion_matches(match, inlier)
        self.cur_mt = mt
        n_in = int(n_in)
        return n_in >= self.cfg.min_inliers_track

    def _track_working_fused(self, motion_in, lm_in, images):
        """The steady-state WORKING frame (``working_track_step``, one
        graph replay on the card): extraction, motion tracking and
        local-map tracking chained on the device, then all bookkeeping
        from one fetch. Returns the local-map
        verdict, or None when the motion stage failed (the caller falls
        back to the previous-frame window search, cTracking.cpp:300-315)."""
        pts, has = motion_in
        local_pts, cap, arrs = lm_in
        M_last = se3_np.cayley2hom(self.last_mt)
        mt_pred = se3_np.hom2cayley(M_last @ self.velocity)
        P = len(local_pts)
        # per-camera inverse lookup landmark -> last-frame slot, so the
        # device can exclude local points already in the frame
        lp_slot = self._slot_lookup(self.last_pt, has, local_pts, cap)

        self._dispatch_n += 1
        out = self._working_step(
            self.extract, self.rig, images, self._to_dev(mt_pred),
            self._to_dev(pts), self._to_dev(has), self.last_feats,
            self._to_dev(lp_slot), arrs["X"], arrs["normal"], arrs["mind"],
            arrs["maxd"], arrs["cand_base"], arrs["desc"], arrs["dmask"],
            self.params, th_motion=self.cfg.motion_th,
            th_local=self.cfg.local_map_th, n_levels=self.cfg.n_levels,
            scale_factor=self.cfg.scale_factor)
        self.cur_feats = out[0]
        (match1, mt1, inl1, n_in1, n_m1, _,
         fr_ok, match2, mt2, inl_slot, inl_new, n_in2, _) = fetch(*out[1:])
        n_m1 = int(n_m1)
        if n_m1 < 20:
            return None
        self._apply_motion_matches(match1, inl1)
        self.cur_mt = mt1
        n_in1 = int(n_in1)
        if n_in1 < self.cfg.min_inliers_track:
            return None

        # local-map bookkeeping, as _track_local_map's after its step
        m = self.map
        vis = fr_ok[:, :P].any(0)
        m.pt_visible[local_pts[vis]] += 1
        slot_has = self.cur_pt >= 0
        n_new = self._apply_local_matches(match2, inl_new, local_pts, P)
        self.cur_outlier |= slot_has & ~inl_slot
        self.cur_mt = mt2
        n_in2 = int(n_in2)
        # resolve merges and drop dead landmarks before the found counters
        # and the keyframe decision
        self.cur_pt = m.resolve_points(self.cur_pt)
        raw_has = self.cur_pt >= 0
        dead = np.zeros_like(raw_has)
        dead[raw_has] = ~m.pt_valid[self.cur_pt[raw_has]]
        self.cur_pt[dead] = -1
        tracked = self.cur_pt[(self.cur_pt >= 0) & ~self.cur_outlier]
        m.pt_found[tracked] += 1
        self.n_tracked.append(len(tracked))
        return n_in2 >= self.cfg.min_inliers_local

    def _slot_lookup(self, pt, has, local_pts, cap):
        """(cap, C) int32: per camera the slot of ``pt`` (C, K) that holds
        each local-map point where ``has``, else -1 (the fused step's
        ``lp_slot``)."""
        lp_slot = np.full((cap, pt.shape[0]), -1, np.int32)
        inv = np.full(self.map.pt_pos.shape[0], -1, np.int32)
        for c in range(pt.shape[0]):
            inv[:] = -1
            s = np.nonzero(has[c])[0]
            inv[pt[c, s]] = s
            lp_slot[:len(local_pts), c] = inv[local_pts]
        return lp_slot

    def _snapshot_slots(self, pt, has, local_pts):
        """(slot_lp (C, K) int32, carried (C, K) bool): each slot's index
        into the local-map snapshot, -1 for none, and the slots of ``has``
        that carry a snapshot point (the chunk scan's carry)."""
        id_to_lp = np.full(self.map.pt_pos.shape[0], -1, np.int32)
        id_to_lp[local_pts] = np.arange(len(local_pts), dtype=np.int32)
        slot_lp = np.full(pt.shape, -1, np.int32)
        carried = has.copy()
        slot_lp[carried] = id_to_lp[pt[carried]]
        carried &= slot_lp >= 0     # landmarks outside the snapshot do not carry
        return slot_lp, carried

    def _apply_local_matches(self, match, inl_new, local_pts, P) -> int:
        """Give free slots their local-map matches and flag the matches the
        LM rejected; returns the number of new associations."""
        n_new = 0
        for c in range(match.shape[0]):
            sel = np.nonzero(match[c, :P] >= 0)[0]
            slots = match[c, sel]
            free = self.cur_pt[c, slots] < 0
            self.cur_pt[c, slots[free]] = local_pts[sel[free]]
            n_new += int(free.sum())
            bad = sel[~inl_new[c, sel]]
            self.cur_outlier[c, match[c, bad]] = True
        return n_new

    def track_chunk(self, images, timestamps):
        """``_track_chunk``, a unit that captures in it noted in
        ``late_captures`` (after the capture-ahead)."""
        with self._noting_late_captures():
            return self._track_chunk(images, timestamps)

    def _track_chunk(self, images, timestamps):
        """B consecutive steady-state WORKING frames through
        ``working_scan_chunk`` (``working_track_step`` and the slot roll
        over every frame) and one fetch of the stacked per-frame outputs;
        the host then replays the bookkeeping (counters, keyframe policy)
        in frame order. The throughput mode: one fetch a chunk in place of
        one a frame (on the card, one graph replay of the scan body a
        frame, the carry passed through the graph's input buffers), and
        latency grows by B frames.

        Against the per-frame path, as in the JAX package: the local-map
        snapshot is frozen for the chunk, and a keyframe fired at chunk
        position i takes the i-th frame's features when the walk reaches
        it. ``images``: (B, C, H, W), a tensor on the tracker's device or
        numpy. Returns (n_accepted, poses), the (4, 4) body poses of the
        accepted prefix, or None when the streaming preconditions do not
        hold (not WORKING, a relocalization pending or within two frames,
        no velocity or motion model, a pose perturbation, fewer than 20
        carried landmarks, no local map). A frame below the tracking
        floors, or a relocalization requested by the loop closer, ends
        the accepted prefix; the caller tracks on per frame from there."""
        B = int(images.shape[0])
        if (self.state != TrackState.WORKING or self.force_reloc
                or self.velocity is None or not self.cfg.use_motion_model
                or self.perturb_pose_fn is not None
                or self.frame_id < self.last_reloc_frame + 2):
            return None
        pts, has = self._gather_last_slot_points()
        if has.sum() < 20:
            return None
        lm_in = self._local_map_snapshot(self.last_pt)
        if lm_in is None:
            return None
        local_pts, cap, arrs = lm_in
        m = self.map
        P = len(local_pts)
        C, K = self.last_pt.shape
        # slot -> snapshot index: the device carries associations by
        # snapshot index, resolved back to landmark ids in the walk
        slot_lp0, hs = self._snapshot_slots(self.last_pt, has, local_pts)

        captures = getattr(self._scan_body, "captures", 0)
        with self.timers.time("working_chunk"):
            self._dispatch_n += 1
            carry, ys = working_scan_chunk(
                self.extract, self.rig, torch.as_tensor(images, device=self.dev),
                self._to_dev(self.last_mt, torch.float32),
                self._to_dev(self.velocity, torch.float32), self.last_feats,
                self._to_dev(pts), self._to_dev(slot_lp0), self._to_dev(hs),
                arrs["X"], arrs["normal"], arrs["mind"], arrs["maxd"],
                arrs["cand_base"], arrs["desc"], arrs["dmask"], self.params,
                th_motion=self.cfg.motion_th, th_local=self.cfg.local_map_th,
                n_levels=self.cfg.n_levels, scale_factor=self.cfg.scale_factor,
                body=self._scan_body)
            feats_stack = ys.pop("feats")      # stays on the device
            keys = list(ys)
            host = dict(zip(keys, fetch(*(ys[k] for k in keys))))
        self.chunk_scans.append((B, self.timers.samples["working_chunk"][-1],
                                 getattr(self._scan_body, "captures", 0) > captures))

        entry_mt = self.last_mt.copy()
        mt_arr = host["mt"]
        poses: list[np.ndarray] = []
        accepted = 0
        for i in range(B):
            if self.force_reloc:
                break       # the loop closer moved the map mid-chunk
            if (int(host["n_m1"][i]) < 20
                    or int(host["n_in1"][i]) < self.cfg.min_inliers_track
                    or int(host["n_in2"][i]) < self.cfg.min_inliers_local):
                break       # the per-frame path recovers from here
            self.frame_id += 1
            m.pt_visible[local_pts[host["vis"][i][:P]]] += 1
            hs_i = host["has"][i]
            cur_pt = np.full((C, K), -1, np.int32)
            cur_pt[hs_i] = local_pts[host["lp"][i][hs_i]]
            cur_pt = m.resolve_points(cur_pt)
            raw = cur_pt >= 0
            dead = np.zeros_like(raw)
            dead[raw] = ~m.pt_valid[cur_pt[raw]]
            cur_pt[dead] = -1
            tracked = cur_pt[cur_pt >= 0]
            m.pt_found[tracked] += 1
            self.n_tracked.append(len(tracked))
            self.cur_pt = cur_pt
            self.cur_outlier = np.zeros((C, K), bool)
            self.cur_mt = mt_arr[i].astype(np.float64)
            self.dispatches_per_frame.append(1 if i == 0 else 0)
            self.frame_path.append("chunk")
            M = se3_np.cayley2hom(self.cur_mt)
            self.all_poses.append(M)
            self.timestamps.append(timestamps[i])
            poses.append(M)
            accepted += 1
            if self._need_new_keyframe():
                self.cur_feats = Features(*(t[i] for t in feats_stack))
                self._create_new_keyframe()

        if accepted:
            i = accepted - 1
            self.cur_feats = (carry[0] if accepted == B
                              else Features(*(t[i] for t in feats_stack)))
            self.last_feats = self.cur_feats
            self.last_pt = self.cur_pt
            self.last_outlier = np.zeros((C, K), bool)
            self.last_mt = self.cur_mt.copy()
            prev = entry_mt if accepted == 1 else mt_arr[accepted - 2].astype(np.float64)
            self.velocity = (np.linalg.inv(se3_np.cayley2hom(prev))
                             @ se3_np.cayley2hom(self.cur_mt))
        return accepted, poses

    def _track_previous_frame(self) -> bool:
        """cTracking::TrackPreviousFrame (:724-788): wide window search
        from the last frame, then pose optimization."""
        pts, has = self._gather_last_slot_points()
        if has.sum() < 10:
            return False
        self._dispatch_n += 1
        has_t = self._to_dev(has)
        match = fetch(self._window_search(
            self.last_feats, self.cur_feats, has_t, self.params,
            window=200.0, nn_ratio=0.9))[0]
        n = int((match >= 0).sum())
        if n < 20:
            # second round with a larger window (cTracking.cpp:735-760)
            self._dispatch_n += 1
            match = fetch(self._window_search(
                self.last_feats, self.cur_feats, has_t, self.params,
                window=400.0, nn_ratio=0.95))[0]
            n = int((match >= 0).sum())
        for c in range(match.shape[0]):
            sel = np.nonzero(match[c] >= 0)[0]
            self.cur_pt[c, match[c, sel]] = self.last_pt[c, sel]
        if n < 10:
            return False
        return self._optimize_current_pose(self.last_mt,
                                           self.cfg.min_inliers_track)

    def _optimize_current_pose(self, mt_init, min_inliers: int) -> bool:
        """Pose-only LM over the current frame's associations, padded to
        the frame's C * K slots (an association takes a slot, so one key
        serves every call; padding rows are invalid)."""
        self.cur_pt = self.map.resolve_points(self.cur_pt)
        has = self.cur_pt >= 0
        cam_idx, slot_idx = np.nonzero(has)
        pt_ids = self.cur_pt[cam_idx, slot_idx]
        alive = self.map.pt_valid[pt_ids]
        cam_idx, slot_idx, pt_ids = (cam_idx[alive], slot_idx[alive],
                                     pt_ids[alive])
        n = len(pt_ids)
        if n < min_inliers:
            return False
        self._dispatch_n += 1
        mt, inlier, n_in, _ = fetch(*self._pose_opt(
            *self._pose_lm_inputs(mt_init, cam_idx, slot_idx, pt_ids)))
        n_in = int(n_in)
        inlier = inlier[:n]
        # mark outliers on the frame (cOptimizer.cpp:414-438)
        self.cur_outlier[cam_idx[~inlier], slot_idx[~inlier]] = True
        self.cur_mt = mt
        return n_in >= min_inliers

    def _pose_lm_inputs(self, mt_init, cam_idx, slot_idx, pt_ids):
        """``pose_optimization``'s arguments for the frame slots (cam_idx,
        slot_idx) observing landmarks pt_ids, padded to the frame's C * K
        slots (padding rows invalid, unit weight)."""
        n, cap = len(pt_ids), self.cur_pt.size
        uv = np.zeros((cap, 2), np.float32)
        xy, lvl = fetch(self.cur_feats.xy, self.cur_feats.level)
        uv[:n] = xy[cam_idx, slot_idx]
        inv_sigma2 = np.ones(cap, np.float32)
        inv_sigma2[:n] = self.cfg.scale_factor ** (-2.0 * lvl[cam_idx, slot_idx])
        cams = np.zeros(cap, np.int32)
        cams[:n] = cam_idx
        X = np.zeros((cap, 3), np.float32)
        X[:n] = self.map.pt_pos[pt_ids]
        obs = opt.BAObservations(
            uv=self._to_dev(uv), kf=self._to_dev(np.zeros(cap, np.int32)),
            cam=self._to_dev(cams), pt=self._to_dev(np.arange(cap, dtype=np.int32)),
            inv_sigma2=self._to_dev(inv_sigma2), valid=self._to_dev(np.arange(cap) < n))
        return (self.rig, self._to_dev(np.asarray(mt_init, np.float64)), obs,
                self._to_dev(X))

    # ------------------------------------------------------------------
    # local map tracking
    # ------------------------------------------------------------------

    def _local_map_ids(self, src_pt=None):
        """UpdateReference (cTracking.cpp:1014-1123): keyframes observing
        the frame's points (K1) and their covisible neighbours (K2); the
        local points are all points of those keyframes. ``src_pt`` picks
        the frame whose associations vote (default: the current one)."""
        if src_pt is None:
            src_pt = self.cur_pt
        m = self.map
        ids = src_pt[src_pt >= 0]
        ids = ids[m.pt_valid[ids]]
        if len(ids) == 0:
            return np.empty(0, np.int32), np.empty(0, np.int32)
        # vote over the map's flat observation log
        in_frame = np.zeros(m.pt_pos.shape[0], bool)
        in_frame[ids] = True
        rows = m.obs_rows()
        votes = np.bincount(rows[in_frame[rows[:, 0]], 1],
                            minlength=m.kf_pt.shape[0])
        k1 = np.nonzero(votes)[0]
        if len(k1) == 0:
            return np.empty(0, np.int32), np.empty(0, np.int32)
        k1 = k1[np.argsort(-votes[k1], kind="stable")].tolist()
        local_kfs = list(k1)
        seen = set(local_kfs)
        for kf in k1[:10]:
            for nkf in m.covisible_keyframes(kf, best_n=10):
                if nkf not in seen:
                    seen.add(nkf)
                    local_kfs.append(nkf)
        arr = m.kf_pt[np.asarray(local_kfs, np.int64)]
        pts = np.unique(arr[arr >= 0])
        pts = pts[m.pt_valid[pts]].astype(np.int32)
        return np.asarray(local_kfs, np.int32), pts

    def _local_map_snapshot(self, src_pt=None):
        """Bucket-padded device inputs of the local-map stage (positions,
        normals, distance range, distinctive descriptors, the candidate
        mask), selected by ``_local_map_ids``. Returns (local_pts, cap,
        dict of device tensors) or None when there is no local map yet."""
        with span("tracker.snapshot"):
            local_kfs, local_pts = self._local_map_ids(src_pt)
            if len(local_pts) == 0:
                return None
            m = self.map
            c = self._snap_cache
            if (c is not None and not self.map_dirty
                    and np.array_equal(c[0], local_pts)):
                return c
            P = len(local_pts)
            cap = bucket(P, 256)
            pad = lambda a, fill=0: np.concatenate(
                [a, np.full((cap - P,) + a.shape[1:], fill, a.dtype)], 0)
            arrs = dict(X=pad(m.pt_pos[local_pts]),
                        normal=pad(m.pt_normal[local_pts]),
                        mind=pad(m.pt_min_dist[local_pts]),
                        maxd=pad(m.pt_max_dist[local_pts], 1.0),
                        desc=pad(m.pt_desc[local_pts]),
                        dmask=pad(m.pt_desc_mask[local_pts]),
                        cand_base=np.arange(cap) < P)
            arrs = {k: self._to_dev(v) for k, v in arrs.items()}
            self._snap_cache = (local_pts, cap, arrs)
            self.map_dirty = False
            return self._snap_cache

    def _track_local_map(self, th: float | None = None,
                         update_counters: bool = True) -> bool:
        """TrackLocalMap (:834-888): frustum check, local-map matching and
        pose LM over the frame's associations plus the new matches in one
        device step (``local_map_track_step``), one fetch. ``th`` widens
        the search window (relocalization's second chance uses 10);
        ``update_counters=False`` leaves the visibility and found counters
        alone, so a relocalization attempt does not skew culling."""
        snap = self._local_map_snapshot()
        if snap is None:
            return False
        local_pts, cap, arrs = snap
        m = self.map
        P = len(local_pts)

        # clean the frame's associations before deriving the candidates:
        # follow merges, drop LM outliers (cTracking.cpp:817-830) and dead
        # landmarks; what is left is both the LM's first observation group
        # and the matcher's occupancy mask
        self.cur_pt = m.resolve_points(self.cur_pt)
        drop = (self.cur_pt >= 0) & self.cur_outlier
        self.cur_pt[drop] = -1
        self.cur_outlier[drop] = False
        C, K = self.cur_pt.shape
        raw_has = self.cur_pt >= 0
        dead = np.zeros((C, K), bool)
        dead[raw_has] = ~m.pt_valid[self.cur_pt[raw_has]]
        self.cur_pt[dead] = -1
        slot_has = self.cur_pt >= 0
        slot_X = np.zeros((C, K, 3), np.float32)
        slot_X[slot_has] = m.pt_pos[self.cur_pt[slot_has]]
        # padding and points already in the frame are no candidates
        cand_ok = np.zeros(cap, bool)
        cand_ok[:P] = ~np.isin(local_pts, self.cur_pt[slot_has])

        self._dispatch_n += 1
        slot_has_t = self._to_dev(slot_has)
        out = self._local_map_step(
            self.rig, self._to_dev(self.cur_mt, torch.float32), arrs["X"],
            arrs["normal"], arrs["mind"], arrs["maxd"], self._to_dev(cand_ok),
            arrs["desc"], arrs["dmask"], self.cur_feats, slot_has_t,
            self._to_dev(slot_X), slot_has_t, self.params,
            th=self.cfg.local_map_th if th is None else th,
            n_levels=self.cfg.n_levels, scale_factor=self.cfg.scale_factor)
        ok, match, mt, inl_slot, inl_new, n_in, _ = fetch(*out)

        # visibility counters (isInFrustum -> IncreaseVisible)
        if update_counters:
            vis = ok[:, :P].any(0)
            m.pt_visible[local_pts[vis]] += 1
        n_new = self._apply_local_matches(match, inl_new, local_pts, P)
        # LM outliers among the existing associations
        self.cur_outlier |= slot_has & ~inl_slot
        self.cur_mt = mt
        n_in = int(n_in)
        okpose = n_in >= self.cfg.min_inliers_local
        if update_counters:
            # found counters for culling (TrackLocalMap IncreaseFound)
            tracked = self.cur_pt[(self.cur_pt >= 0) & ~self.cur_outlier]
            m.pt_found[tracked] += 1
            self.n_tracked.append(len(tracked))
        return okpose

    # ------------------------------------------------------------------
    # keyframe policy
    # ------------------------------------------------------------------

    def _need_new_keyframe(self) -> bool:
        """cTracking::NeedNewKeyFrame (:890-938)."""
        m = self.map
        if self.last_kf_id < 0:
            return False
        n_tracked = int(((self.cur_pt >= 0) & ~self.cur_outlier).sum())
        frames_since = self.frame_id - m.kf_frame_id[self.last_kf_id]
        if frames_since < self.cfg.min_frames:
            return False
        ref_pts = int((m.kf_pt[self.last_kf_id] >= 0).sum())
        weak = n_tracked < ref_pts * self.cfg.kf_tracked_ratio
        stale = frames_since >= self.cfg.max_frames
        # MultiCol baseline condition (:921): distance to the last
        # keyframe over the median scene depth > 0.2
        M_cur = se3_np.cayley2hom(self.cur_mt)
        M_kf = se3_np.cayley2hom(m.kf_pose[self.last_kf_id])
        baseline = np.linalg.norm(M_cur[:3, 3] - M_kf[:3, 3])
        depth = self._median_scene_depth()
        moved = depth > 0 and (baseline / depth) > self.cfg.baseline_depth_ratio
        if not ((weak and n_tracked > self.cfg.kf_min_points) or stale or moved):
            return False
        # a busy mapper takes no keyframe: ask its pass to yield, retry on
        # the next frame (cTracking.cpp:922-935); synchronous mapping wires
        # no mapper_idle_fn
        if self.mapper_idle_fn is not None and not self.mapper_idle_fn():
            if self.interrupt_ba_fn is not None:
                self.interrupt_ba_fn()
            return False
        return True

    def _median_scene_depth(self) -> float:
        pts = self.cur_pt[(self.cur_pt >= 0) & ~self.cur_outlier]
        if len(pts) == 0:
            return 0.0
        M_cur = se3_np.cayley2hom(self.cur_mt)
        d = np.linalg.norm(self.map.pt_pos[pts] - M_cur[:3, 3], axis=1)
        return float(np.median(d))

    def _create_new_keyframe(self):
        """cTracking::CreateNewKeyFrame (:940-951)."""
        m = self.map
        kf = m.alloc_keyframe(self.cur_mt, self.cur_feats, self.frame_id)
        with span("tracker.new_keyframe", kf=kf):
            C, K = self.cur_pt.shape
            for c in range(C):
                for s in np.nonzero((self.cur_pt[c] >= 0) & ~self.cur_outlier[c])[0]:
                    pid = int(self.cur_pt[c, s])
                    if m.pt_valid[pid]:
                        m.add_observation(pid, kf, c, int(s))
            m.update_spanning_tree(kf)
            self.last_kf_id = kf
            if self.on_new_keyframe:
                self.on_new_keyframe(kf)

    # ------------------------------------------------------------------
    # relocalization (cTracking::Relocalisation :1125-1312)
    # ------------------------------------------------------------------

    def _reloc_matches(self, kf: int) -> list[tuple[int, int, int]]:
        """(point, cam, slot) matches of the current frame against
        keyframe kf: the vocabulary-node-gated SearchByBoW
        (cORBmatcher.cpp:179-323) when a loop closer is wired, else a
        window search over the whole image at TH_LOW and ratio 0.75."""
        if self.reloc_bow_match_fn is not None:
            return self.reloc_bow_match_fn(kf, self.cur_feats)
        m = self.map
        match = fetch(self._window_search(
            m.kf_features[kf], self.cur_feats, self._to_dev(m.kf_pt[kf] >= 0),
            self.params, window=1e6, nn_ratio=0.75, use_low_th=True))[0]
        c, s = np.nonzero(match >= 0)
        p = m.kf_pt[kf, c, s]
        keep = p >= 0
        return list(zip(p[keep].tolist(), c[keep].tolist(), match[c, s][keep].tolist()))

    def _relocalize(self) -> bool:
        """Relocalisation (cTracking.cpp:1125-1312): candidate keyframes
        from the BoW database (DetectRelocalisationCandidates) plus the ten
        most recent keyframes (BoW can alias to a similar-looking place
        while the last keyframe overlaps the view); the candidate with the
        most matches (>= 15) seeds GP3P RANSAC over the 2D-3D matches,
        then the pose LM. A weak or failed fit gets a second chance: the
        candidate's landmarks projected at the refined pose
        (``_reloc_project_candidate``), then a widened local-map re-match."""
        m = self.map
        cands = self.reloc_candidates_fn(self.cur_feats) if self.reloc_candidates_fn else []
        recent = m.keyframe_ids()[-10:].tolist()
        best = None
        for kf in dict.fromkeys(list(cands) + recent):
            if m.kf_features[kf] is None:
                continue
            triples = self._reloc_matches(kf)
            if len(triples) >= 15 and (best is None or len(triples) > best[0]):
                best = (len(triples), kf, triples)
        if best is None:
            return False
        _, kf, triples = best
        for p, c, s in triples:
            self.cur_pt[c, s] = p

        # GP3P RANSAC over body-frame rays x landmark positions, then the
        # pose LM (cTracking.cpp:1234-1266)
        mt_init = m.kf_pose[kf]
        cam_idx, slot_idx = np.nonzero(self.cur_pt >= 0)
        pids = self.cur_pt[cam_idx, slot_idx]
        alive = m.pt_valid[pids]
        cam_idx, slot_idx, pids = cam_idx[alive], slot_idx[alive], pids[alive]
        if len(pids) >= 6:
            self._dispatch_n += 1
            T, _, n_in = fetch(*self._gpnp(self.gen, *self._gpnp_inputs(
                cam_idx, slot_idx, m.pt_pos[pids]), n_hyps=256))
            if int(n_in) >= max(6, int(0.4 * len(pids))):
                mt_init = se3_np.hom2cayley(np.linalg.inv(T))

        ok = self._optimize_current_pose(mt_init, 10)
        n_assoc = int(((self.cur_pt >= 0) & ~self.cur_outlier).sum())
        if self.cfg.reloc_second_chance and (not ok or n_assoc < 50):
            # accept a fit at >= 10 inliers (cTracking.cpp:1284-1297)
            if self._reloc_project_candidate(kf) > 0:
                ok = self._optimize_current_pose(self.cur_mt, 10) or ok
                n_assoc = int(((self.cur_pt >= 0) & ~self.cur_outlier).sum())
            if not ok or n_assoc < 50:
                ok = self._track_local_map(th=10.0, update_counters=False) or ok
        if ok:
            self.last_reloc_frame = self.frame_id
        return ok

    def _gpnp_inputs(self, cam_idx, slot_idx, X):
        """GP3P RANSAC's device inputs for the frame slots (cam_idx,
        slot_idx) against landmarks X: body-frame ray origins and
        directions, positions and the valid mask, padded to the frame's
        C * K slots (padding rows invalid, so they score no inliers)."""
        rays = fetch(self.cur_feats.ray)[0][cam_idx, slot_idx]
        Mc = self._M_c_np
        dirs = np.einsum("nij,nj->ni", Mc[cam_idx, :3, :3], rays)
        cap = self.cur_pt.size
        padf = lambda a: self._to_dev(np.concatenate(
            [a, np.zeros((cap - len(a),) + a.shape[1:], a.dtype)], 0))
        return (padf(Mc[cam_idx, :3, 3]), padf(dirs), padf(np.asarray(X, np.float32)),
                self._to_dev(np.arange(cap) < len(cam_idx)))

    def _reloc_project_candidate(self, kf: int) -> int:
        """SearchByProjection(F, KF, sAlreadyFound, th, ORBdist), the
        relocalization round (cORBmatcher.cpp:2120-2263): keyframe kf's
        landmarks not yet associated, projected at the refined pose with a
        4x distance slack (the pose was just recovered), matched into free
        slots within 10 * 1.2^level px under the absolute ORBdist gate
        (100 per 256 bits, 50 masked). Returns the new associations."""
        m = self.map
        arr = m.kf_pt[kf]
        cand = np.unique(arr[arr >= 0])
        cand = cand[m.pt_valid[cand]]
        found = self.cur_pt[self.cur_pt >= 0]
        if len(found):
            cand = cand[~np.isin(cand, found)]
        if len(cand) == 0:
            return 0
        P = len(cand)
        self._dispatch_n += 1
        match = fetch(self._reloc_projection(*self._projection_inputs(cand)))[0]
        n_new = 0
        for c in range(match.shape[0]):
            sel = np.nonzero(match[c, :P] >= 0)[0]
            slots = match[c, sel]
            free = self.cur_pt[c, slots] < 0
            self.cur_pt[c, slots[free]] = cand[sel[free]]
            n_new += int(free.sum())
        return n_new

    def _projection_inputs(self, cand):
        """``reloc_projection_round``'s arguments for candidate landmarks
        ``cand`` at the current pose, padded to the frame's C * K slots (a
        keyframe has at most that many landmarks; padding rows are no
        candidates)."""
        m = self.map
        P, cap = len(cand), self.cur_pt.size
        pad = lambda a, fill=0: self._to_dev(np.concatenate(
            [a, np.full((cap - P,) + a.shape[1:], fill, a.dtype)], 0))
        orb_dist = int(round((50 if self.params.masked else 100) * self.cfg.desc_bytes / 32))
        return (self.rig, self._to_dev(self.cur_mt), pad(m.pt_pos[cand]),
                pad(m.pt_normal[cand]), pad(m.pt_min_dist[cand]),
                pad(m.pt_max_dist[cand], 1.0), self._to_dev(np.arange(cap) < P),
                self.cur_feats, self._to_dev(self.cur_pt >= 0), pad(m.pt_desc[cand]),
                pad(m.pt_desc_mask[cand]), self.params, 10.0, orb_dist,
                self.cfg.n_levels, self.cfg.scale_factor)

    # ------------------------------------------------------------------

    def reset(self):
        """cTracking::Reset (:1327-1375): clears the map and all eval
        state. ``on_reset`` (wired by the System) runs first: it stops the
        async mapper's work (its queue drained, a pass in flight waited
        for, as the reference's RequestReset waits for the mapper's
        acknowledgement) and resets the mapper and the loop closer, so no
        pass runs on a cleared map. The JAX package clears the map first."""
        if getattr(self, "on_reset", None):
            self.on_reset()
        self.map.clear()
        self.state = TrackState.NOT_INITIALIZED
        self.velocity = None
        self.init_ref_feats = None
        self.last_feats = None
        self.last_kf_id = -1
        self.force_reloc = False
        self.map_dirty = True
        self._snap_cache = None
        self.cur_pt = np.full_like(self.cur_pt, -1) \
            if self.cur_pt is not None else None
        self.last_pt = None
        self.last_outlier = None
        self.all_poses.clear()
        self.timestamps.clear()
        self.n_tracked.clear()
        self.dispatches_per_frame.clear()
        self.timers.clear()
