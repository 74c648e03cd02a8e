"""Local mapping back-end (cLocalMapping.{h,cpp}).

Port of ``multicol_slam_tpu/models/local_mapping.py``. The reference's
loop per inserted keyframe (cLocalMapping.cpp:69-129):
ProcessNewMultiKeyFrame (:145-185) -> MapPointCulling (:187-221) ->
CreateNewMapPoints (:223-383) -> SearchInNeighbors / Fuse (:385-454) ->
LocalBundleAdjustment (cOptimizer.cpp:461-874) -> KeyFrameCulling
(:517-593). Each stage fans out over a short host list (neighbour
keyframes, camera pairs, fuse targets); the list becomes a leading batch
axis folded into the matcher's camera axis, so each stage is one
Hamming-NN kernel call and one fetch. The local BA is one Schur LM call
on a host-assembled static-shape problem; culling is host numpy. The
mapper runs when called: in the tracking thread, or in the system's
mapper thread under async mapping, where ``interrupt_check`` lets a
pending keyframe cut a pass short.

The JAX package jits four of these units (``triangulation_batch``,
``cross_camera_batch``, ``fuse_targets_batch`` and the local
``bundle_adjustment``). On the card ``LocalMapper`` runs them as CUDA
graphs (``utils/graphs.py``) in a memory pool of its own, since under
async mapping they replay on the mapper's stream while the tracker's
graphs replay on the tracker's; on the CPU they run eagerly. A graph pays
off only when its key comes back: the local BA's and the fuse's padded
shapes grow by factors of four (``coarse_bucket``), so that over a run
the BA takes a few shapes and replays each.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..ops import geometry as geo
from ..ops import se3_np
from ..ops.camera import world_to_img
from ..ops.rig import Rig
from ..utils import graphs
from . import matcher
from . import optimizer as opt
from .extractor import Features
from .map import MapStore
from .tracking import fetch, frustum_check, to_device

# Reference gates (cLocalMapping.cpp:39-43, 244-379)
MIN_BASELINE_DEPTH_RATIO = 0.01   # :253
TRIANG_PARALLAX_DEG = 3.0         # :318 area
TRIANG_REPROJ_TH = 4.0            # two-view reprojection error (px)
TRIANG_MAX_DIST = 25.0            # :360 area
CULL_FOUND_RATIO = 0.25           # MapPointCulling :199
KF_CULL_REDUNDANT = 0.9           # KeyFrameCulling :585
KF_CULL_MIN_OBS = 5               # maxNrObs, KeyFrameCulling :522
KF_CULL_PREGATE_OBS = 3           # Observations() > 3 pre-gate :548
# cos of the parallax gate as float32 computes it (a Python float, so a
# graphed unit makes no tensor from host data)
_COS_PARALLAX = float(torch.cos(torch.deg2rad(torch.tensor(TRIANG_PARALLAX_DEG,
                                                           dtype=torch.float32))))


def coarse_bucket(n: int, minimum: int) -> int:
    """Round up to ``minimum`` times a power of four: the padded shapes of
    the local BA and the fuse, coarse enough that a graph's key comes back
    as the map grows. Padding is inert: padded observations are invalid,
    padded points and keyframes fixed, padded fuse candidates invalid."""
    b = minimum
    while b < n:
        b *= 4
    return b


def _stack_features(fs) -> Features:
    return Features(*(torch.stack(ts) for ts in zip(*fs)))


def _fold(f: Features) -> Features:
    """(B, C, K, ...) -> (B * C, K, ...)."""
    return Features(*(t.reshape((-1,) + tuple(t.shape[2:])) for t in f))


def _triangulate_and_gate(cam1, cam2, xy1, xy2_all, r1, ray2_all, m, Trel, Tcw):
    """Triangulation and acceptance gates of CreateNewMapPoints
    (cLocalMapping.cpp:270-379) for a batch of B camera pairs: midpoint
    triangulation in camera 1's frame, then z > 0 in both views,
    parallax, two-view reprojection error and distance. cam1 / cam2:
    camera fields (B,); xy1, r1: (B, K, ...); xy2_all, ray2_all: (B, K2,
    ...); m (B, K) matches; Trel (B, 4, 4) camera 2 -> camera 1; Tcw
    (B, 4, 4) camera 1 -> world. Returns (Xw (B, K, 3), good (B, K))."""
    j = torch.clamp(m, min=0).long()[..., None]
    r2 = torch.gather(ray2_all, 1, j.expand(-1, -1, 3))
    xy2 = torch.gather(xy2_all, 1, j.expand(-1, -1, 2))
    R12, t12 = Trel[:, None, :3, :3], Trel[:, None, :3, 3]
    X1 = geo.triangulate_midpoint(t12, R12, r1, r2)
    z1 = (X1 * r1).sum(-1)
    X2 = torch.einsum("bki,bij->bkj", X1 - t12, Trel[:, :3, :3])
    z2 = (X2 * r2).sum(-1)
    n1 = X1 / torch.clamp(torch.linalg.norm(X1, dim=-1, keepdim=True), min=1e-12)
    d2v = X1 - t12
    n2 = d2v / torch.clamp(torch.linalg.norm(d2v, dim=-1, keepdim=True), min=1e-12)
    cosp = (n1 * n2).sum(-1)
    e1 = torch.linalg.norm(world_to_img(cam1.expand(1), X1) - xy1, dim=-1)
    e2 = torch.linalg.norm(world_to_img(cam2.expand(1), X2) - xy2, dim=-1)
    dist = torch.linalg.norm(X1, dim=-1)
    good = ((m >= 0) & (z1 > 0) & (z2 > 0) & (cosp < _COS_PARALLAX)
            & (e1 < TRIANG_REPROJ_TH) & (e2 < TRIANG_REPROJ_TH)
            & (dist < TRIANG_MAX_DIST) & torch.isfinite(X1).all(-1))
    Xw = torch.einsum("bkj,bij->bki", X1, Tcw[:, :3, :3]) + Tcw[:, None, :3, 3]
    return Xw, good


def triangulation_batch(rig: Rig, f1: Features, f1_free, f2s: Features, free2,
                        E, Trel, Tcw, params):
    """SearchForTriangulationRaw, midpoint triangulation and gates over
    every top-covisible neighbour at once (CreateNewMapPoints,
    cLocalMapping.cpp:223-383; same-camera search, cORBmatcher.cpp:
    968-1155): the (neighbour, camera) pairs fold into one kernel call.

    f2s: neighbour Features stacked (N, C, K, ...); free2 (N, C, K);
    E (N, C, 3, 3) essentials; Trel (N, C, 4, 4) camera 2 -> camera 1;
    Tcw (C, 4, 4) camera -> world of the new keyframe. Padded neighbour
    rows carry free2 = False. Returns (match, Xw, good), each (N, C, K,
    ...)."""
    N, C = free2.shape[:2]
    rep = lambda t: t[None].expand((N,) + tuple(t.shape)).reshape(
        (N * C,) + tuple(t.shape[1:]))
    f1r = Features(*(rep(t) for t in f1))
    f2 = _fold(f2s)
    match = matcher.search_for_triangulation(
        f1r, rep(f1_free), f2, free2.reshape(N * C, -1), E.reshape(N * C, 3, 3),
        params)
    cams = rig.cams.index(torch.arange(C, device=match.device).repeat(N))
    Xw, good = _triangulate_and_gate(cams, cams, f1r.xy, f2.xy, f1r.ray, f2.ray,
                                     match, Trel.reshape(N * C, 4, 4), rep(Tcw))
    K = match.shape[-1]
    return match.reshape(N, C, K), Xw.reshape(N, C, K, 3), good.reshape(N, C, K)


def cross_camera_batch(rig: Rig, f: Features, free, i1, i2, E, Trel, Tcw, params):
    """Cross-camera triangulation inside one keyframe over every camera
    pair at once (SearchForTriangulationBetweenCameras, cORBmatcher.cpp:
    1158-1262): i1 / i2 (Np,) index the camera axis, and the pair axis
    takes the matcher's camera slot. Returns (match (Np, K), Xw (Np, K,
    3), good (Np, K))."""
    i1, i2 = i1.long(), i2.long()
    f1p = Features(*(t[i1] for t in f))
    f2p = Features(*(t[i2] for t in f))
    match = matcher.search_for_triangulation(f1p, free[i1], f2p, free[i2], E,
                                             params)
    return (match,) + _triangulate_and_gate(
        rig.cams.index(i1), rig.cams.index(i2), f1p.xy, f2p.xy, f1p.ray, f2p.ray,
        match, Trel, Tcw)


def fuse_targets_batch(rig: Rig, poses, feats: Features, occupied, X, normal,
                       mind, maxd, cand_valid, desc, dmask, params, th: float,
                       n_levels: int, scale_factor: float):
    """SearchInNeighbors' Fuse over every target keyframe at once
    (cLocalMapping.cpp:385-454, cORBmatcher.cpp:1265-1420): the frustum
    check of the candidate points against each target pose, then one
    kernel call for the projection-gated fuse match with the targets
    folded into the camera axis. poses (T, 6); feats (T, C, K, ...);
    occupied (T, C, K); candidate arrays (P, ...) shared by all targets.
    Returns match (T, C, P) into each target's slots."""
    T, C = occupied.shape[:2]
    frs = [frustum_check(rig, poses[t], X, normal, mind, maxd,
                         n_levels=n_levels, scale_factor=scale_factor)
           for t in range(T)]
    uv = torch.stack([fr[0] for fr in frs])
    ok = torch.stack([fr[1] for fr in frs]) & cand_valid
    lvl = torch.stack([fr[2] for fr in frs])
    P = X.shape[0]
    match = matcher.fuse_candidates(
        _fold(feats), occupied.reshape(T * C, -1), desc, dmask,
        uv.reshape(T * C, P, 2), ok.reshape(T * C, P), lvl.reshape(T * C, P),
        params, th=th)
    return match.reshape(T, C, P)


def assemble_ba_problem(m: MapStore, kfs: list[int], fixed_mask: np.ndarray,
                        scale_factor: float, min_obs: int = 10, device=None):
    """A static-shape BAProblem over the given keyframes, on ``device``
    (the host side of cOptimizer's graph building, cOptimizer.cpp:
    57-257/461-874), built from the map's flat observation log.

    Returns (problem, mt0 (N, 6), X0 (P, 3), pts (P,), rows) or None when
    there are fewer than ``min_obs`` observations; mt0 and X0 are float32
    numpy (the JAX package's production dtype), padded like the problem;
    rows is the (K, 4) (pt, kf_id, cam, slot) table aligned with the
    observations."""
    kfs_a = np.asarray(kfs, np.int64)
    kf_in = np.zeros(m.kf_pt.shape[0], bool)
    kf_in[kfs_a] = True
    rows = m.obs_rows()
    rows = rows[kf_in[rows[:, 1]] & m.pt_valid[rows[:, 0]]]
    if len(rows) < min_obs:
        return None
    rows = np.unique(rows, axis=0)   # dedupe re-added observations

    # per-row measurement and octave, gathered per keyframe
    K = len(rows)
    uv_r = np.zeros((K, 2), np.float32)
    lvl_r = np.zeros(K, np.int32)
    keep = np.ones(K, bool)
    srt = np.argsort(rows[:, 1], kind="stable")
    rs = rows[srt]
    uk, starts = np.unique(rs[:, 1], return_index=True)
    for i, kf in enumerate(uk):
        end = starts[i + 1] if i + 1 < len(uk) else K
        sl = srt[starts[i]:end]
        host = m.kf_host(int(kf))
        if host is None:
            keep[sl] = False
            continue
        uv_r[sl] = host.xy[rows[sl, 2], rows[sl, 3]]
        lvl_r[sl] = host.level[rows[sl, 2], rows[sl, 3]]
    if not keep.all():
        rows, uv_r, lvl_r = rows[keep], uv_r[keep], lvl_r[keep]
        K = len(rows)
    if K < min_obs:
        return None
    pts = np.unique(rows[:, 0]).astype(np.int32)
    kf_to_idx = np.full(m.kf_pt.shape[0], -1, np.int32)
    kf_to_idx[kfs_a] = np.arange(len(kfs), dtype=np.int32)
    pti_r = np.searchsorted(pts, rows[:, 0]).astype(np.int32)

    cap = coarse_bucket(K, 2048) + 1
    uv = np.zeros((cap, 2), np.float32)
    kfi = np.zeros(cap, np.int32)
    cami = np.zeros(cap, np.int32)
    pti = np.zeros(cap, np.int32)
    isig = np.ones(cap, np.float32)
    valid = np.zeros(cap, bool)
    uv[:K] = uv_r
    kfi[:K] = kf_to_idx[rows[:, 1]]
    cami[:K] = rows[:, 2]
    pti[:K] = pti_r
    isig[:K] = scale_factor ** (-2.0 * lvl_r)
    valid[:K] = True
    # per-point observation table, padded with the invalid row cap - 1
    counts = np.bincount(pti_r, minlength=len(pts))
    Mo = coarse_bucket(int(max(counts.max(), 1)), 8)
    pt_obs_tab = np.full((len(pts), Mo), cap - 1, np.int32)
    order2 = np.argsort(pti_r, kind="stable")
    group_start = np.concatenate([[0], np.cumsum(counts)[:-1]])
    pos = np.arange(K) - group_start[pti_r[order2]]
    pt_obs_tab[pti_r[order2], pos] = order2
    # bucket the keyframe and point axes; padded ones are fixed
    P, N = len(pts), len(kfs)
    Pcap = coarse_bucket(P, 1024)
    Ncap = coarse_bucket(N, 16)
    pt_obs_tab = np.concatenate(
        [pt_obs_tab, np.full((Pcap - P, Mo), cap - 1, np.int32)], 0)
    fixed_kf = np.concatenate([fixed_mask, np.ones(Ncap - N, bool)])
    fixed_pt = np.concatenate([np.zeros(P, bool), np.ones(Pcap - P, bool)])
    dev = lambda a: to_device(a, device)
    problem = opt.BAProblem(
        obs=opt.BAObservations(uv=dev(uv), kf=dev(kfi), cam=dev(cami),
                               pt=dev(pti), inv_sigma2=dev(isig),
                               valid=dev(valid)),
        pt_obs=dev(pt_obs_tab), fixed_kf=dev(fixed_kf), fixed_pt=dev(fixed_pt))
    mt0 = np.concatenate([np.stack([m.kf_pose[k] for k in kfs]),
                          np.zeros((Ncap - N, 6))], 0).astype(np.float32)
    X0 = np.concatenate([m.pt_pos[pts].astype(np.float64),
                         np.ones((Pcap - P, 3))], 0).astype(np.float32)
    return problem, mt0, X0, pts, rows


def pad_ba_problem(problem, K: int, M: int):
    """A BAProblem's observation table padded to K rows, appended invalid
    (zero measurement, keyframe, camera and point 0, weight 1), and its
    points' observation lists to M columns pointing at the table's old
    last row, which is invalid: inert, as ``assemble_ba_problem``'s own
    padding."""
    obs, pt_obs = problem.obs, problem.pt_obs
    n = K - obs.uv.shape[0]
    pad = lambda t, fill: torch.cat([t, torch.full((n,) + tuple(t.shape[1:]), fill,
                                                   dtype=t.dtype, device=t.device)])
    cols = torch.full((pt_obs.shape[0], M - pt_obs.shape[1]), obs.uv.shape[0] - 1,
                      dtype=pt_obs.dtype, device=pt_obs.device)
    return problem._replace(
        obs=opt.BAObservations(uv=pad(obs.uv, 0.0), kf=pad(obs.kf, 0), cam=pad(obs.cam, 0),
                               pt=pad(obs.pt, 0), inv_sigma2=pad(obs.inv_sigma2, 1.0),
                               valid=pad(obs.valid, False)),
        pt_obs=torch.cat([pt_obs, cols], 1))


@dataclasses.dataclass
class LocalMapper:
    rig: Rig
    map: MapStore
    params: matcher.MatchParams
    scale_factor: float = 1.2
    n_levels: int = 8
    ba_iters: int = 5

    def __post_init__(self):
        self.recent_pts: list[tuple[int, int]] = []   # (pt, created_at_kf)
        self.dev = self.rig.M_c.device
        # InterruptBA (cTracking.cpp:931, cLocalMapping.cpp:512-515): while
        # this callable reports a pending keyframe, the pass skips its tail
        # stages (fuse, local BA, keyframe culling). The reference aborts a
        # running BA (mbAbortBA); here the pass yields between stages
        self.interrupt_check = None
        # host copy of the rig extrinsics for the point statistics
        self._M_c_np = self.rig.M_c.detach().cpu().numpy().astype(np.float64)
        # the JAX package's four jitted units: CUDA graphs on the card, in
        # the mapper's own pool (None on the CPU; the loop closer's graphs
        # join it), eager on the CPU
        units = (triangulation_batch, cross_camera_batch, fuse_targets_batch,
                 opt.bundle_adjustment)
        self.pool = None
        self._last_ba = None            # the last local BA's (problem, mt0, X0)
        if self.dev.type == "cuda":
            self.pool = graphs.Pool("mapper")
            units = tuple(graphs.jit(u, self.pool) for u in units)
        self._triangulate, self._cross_camera, self._fuse, self._bundle_adjust = units

    def _to_dev(self, a) -> torch.Tensor:
        return to_device(a, self.dev)

    def capture_ahead(self):
        """On the card: capture the local BA's graphs at the next bucket of
        the last BA problem's observation rows, of its points' observation
        columns, and of both, that problem padded inertly to each
        (``pad_ba_problem``), the results discarded. A map grows those two
        axes first: over the bench's 90-frame runs on the H100 the
        mapper's BA keys differed from the bootstrap's in them alone (16
        keyframes and 1024 points throughout). The system calls this after
        its bootstrap passes under async mapping, on the tracker's thread
        before the mapper's first pass, so that the mapper's thread
        replays those keys instead of capturing them beside the tracker's
        frames."""
        if self.pool is None or self._last_ba is None:
            return
        problem, mt0, X0 = self._last_ba
        K, M = problem.obs.uv.shape[0], problem.pt_obs.shape[1]
        for k, m in ((4 * (K - 1) + 1, M), (K, 4 * M), (4 * (K - 1) + 1, 4 * M)):
            self._bundle_adjust(self.rig, self._to_dev(mt0), self._to_dev(X0),
                                pad_ba_problem(problem, k, m), huber=opt.HUBER_LOCAL,
                                iters=self.ba_iters)

    def _interrupted(self) -> bool:
        return bool(self.interrupt_check is not None and self.interrupt_check())

    # ------------------------------------------------------------------

    def process_keyframe(self, kf: int):
        """One local-mapping pass for a new keyframe, in cLocalMapping::
        Run's order (:69-129). The front stages always run; fuse runs only
        while no keyframe is pending, and local BA with keyframe culling
        only if still uninterrupted after it (the interrupt points of
        :512-515). With no ``interrupt_check`` (synchronous mapping) every
        stage runs."""
        self._update_point_stats_for_kf(kf)
        self._cull_map_points(kf)
        self._create_new_map_points(kf)
        self._create_cross_camera_points(kf)
        if not self._interrupted():
            self._fuse_in_neighbors(kf)
        if not self._interrupted():
            self._local_bundle_adjustment(kf)
            self._cull_keyframes(kf)

    def reset(self):
        """cLocalMapping::RequestReset: drop the probation list so a fresh
        map never sees stale point ids (cTracking.cpp:1327-1375)."""
        self.recent_pts.clear()

    # ------------------------------------------------------------------

    def _update_point_stats_for_kf(self, kf: int):
        """ProcessNewMultiKeyFrame: refresh normals, depths and
        descriptors of the keyframe's points (cLocalMapping.cpp:145-185)."""
        pts = self.map.kf_pt[kf]
        pts = np.unique(pts[pts >= 0])
        self.map.update_point_stats(pts, self._M_c_np,
                                    self.scale_factor, self.n_levels)

    def _cull_map_points(self, kf: int):
        """MapPointCulling (:187-221): drop points with found-ratio < 0.25
        or too few observations shortly after creation."""
        m = self.map
        keep = []
        for pt, born_kf in self.recent_pts:
            if not m.pt_valid[pt]:
                continue
            found_ratio = m.pt_found[pt] / max(m.pt_visible[pt], 1)
            age = kf - born_kf
            n_obs_kfs = len({o[0] for o in m.pt_obs.get(pt, [])})
            if found_ratio < CULL_FOUND_RATIO:
                m.remove_point(pt)
            elif age >= 2 and n_obs_kfs <= 2:
                m.remove_point(pt)
            elif age >= 3:
                continue  # survived probation
            else:
                keep.append((pt, born_kf))
        self.recent_pts = keep

    # ------------------------------------------------------------------

    # neighbour-batch size: top-5 covisible keyframes (cLocalMapping.cpp:244)
    TRIANG_NEIGHBORS = 5

    def _create_new_map_points(self, kf: int):
        """CreateNewMapPoints (:223-383): triangulate the new keyframe's
        unmatched features against its top covisible keyframes (same
        camera, epipolar-gated search, midpoint triangulation and gates)
        in one ``triangulation_batch`` call; the host allocates the
        accepted points."""
        m = self.map
        neighbors = m.covisible_keyframes(kf, best_n=self.TRIANG_NEIGHBORS)
        f1 = m.kf_features[kf]
        if not neighbors or f1 is None:
            return
        M1 = se3_np.cayley2hom(m.kf_pose[kf])
        depth1 = self._median_depth_of_kf(kf)
        C, K = m.kf_pt.shape[1:]
        Mc = self._M_c_np
        T1 = np.stack([np.linalg.inv(M1 @ Mc[c]) for c in range(C)])
        Tcw = np.stack([M1 @ Mc[c] for c in range(C)])

        valid_nb = []
        for nkf in neighbors:
            if m.kf_features[nkf] is None:
                continue
            M2 = se3_np.cayley2hom(m.kf_pose[nkf])
            baseline = np.linalg.norm(M1[:3, 3] - M2[:3, 3])
            if depth1 > 0 and baseline / depth1 < MIN_BASELINE_DEPTH_RATIO:
                continue  # :244-254
            valid_nb.append((nkf, M2))
        if not valid_nb:
            return

        NB = self.TRIANG_NEIGHBORS
        E = np.zeros((NB, C, 3, 3), np.float32)
        Trel = np.tile(np.eye(4, dtype=np.float32), (NB, C, 1, 1))
        free2 = np.zeros((NB, C, K), bool)
        f2_list = []
        for n, (nkf, M2) in enumerate(valid_nb):
            for c in range(C):
                T2 = np.linalg.inv(M2 @ Mc[c])
                E[n, c] = se3_np.essential_from_poses(T1[c], T2)
                Trel[n, c] = T1[c] @ np.linalg.inv(T2)
            free2[n] = m.kf_pt[nkf] < 0
            f2_list.append(m.kf_features[nkf])
        while len(f2_list) < NB:
            f2_list.append(f1)    # pad rows; free2 = False never matches
        match, Xw, good = fetch(*self._triangulate(
            self.rig, f1, self._to_dev(m.kf_pt[kf] < 0), _stack_features(f2_list),
            self._to_dev(free2), self._to_dev(E), self._to_dev(Trel),
            self._to_dev(Tcw.astype(np.float32)), self.params))

        # allocate neighbour by neighbour in covisibility order; a slot an
        # earlier neighbour triangulated is taken (the reference's loop)
        taken = np.zeros((C, K), bool)
        new_ids = []
        for n, (nkf, _) in enumerate(valid_nb):
            for c in range(C):
                sel = np.nonzero(good[n, c] & ~taken[c])[0]
                if len(sel) == 0:
                    continue
                j = match[n, c, sel]
                ids = m.alloc_points(len(sel))
                m.pt_pos[ids] = Xw[n, c, sel].astype(np.float32)
                m.pt_first_kf[ids] = kf
                for i, p in enumerate(ids):
                    m.add_observation(int(p), kf, c, int(sel[i]))
                    m.add_observation(int(p), nkf, c, int(j[i]))
                    self.recent_pts.append((int(p), kf))
                taken[c, sel] = True
                new_ids.append(ids)
        if new_ids:
            m.update_point_stats(np.concatenate(new_ids), self._M_c_np,
                                 self.scale_factor, self.n_levels)

    def _create_cross_camera_points(self, kf: int):
        """Cross-camera triangulation inside the keyframe
        (SearchForTriangulationBetweenCameras, cORBmatcher.cpp:1158-1262):
        free features of different cameras, the rig's epipolar gate and
        its metric baseline, the observations that anchor the scale."""
        m = self.map
        f = m.kf_features[kf]
        if f is None:
            return
        M1 = se3_np.cayley2hom(m.kf_pose[kf])
        C, K = m.kf_pt.shape[1:]
        Mc = self._M_c_np

        pairs = []
        for c1 in range(C):
            for c2 in range(c1 + 1, C):
                Trel = np.linalg.inv(Mc[c1]) @ Mc[c2]
                if np.linalg.norm(Trel[:3, 3]) < 1e-6:
                    continue
                pairs.append((c1, c2, Trel))
        if not pairs:
            return
        i1 = np.asarray([p[0] for p in pairs], np.int32)
        i2 = np.asarray([p[1] for p in pairs], np.int32)
        Trel = np.stack([p[2] for p in pairs]).astype(np.float32)
        E = np.stack([se3_np.essential_from_poses(
            np.linalg.inv(Mc[c1]), np.linalg.inv(Mc[c2]))
            for c1, c2, _ in pairs]).astype(np.float32)
        Tcw = np.stack([M1 @ Mc[c1] for c1, _, _ in pairs]).astype(np.float32)
        match, Xw, good = fetch(*self._cross_camera(
            self.rig, f, self._to_dev(m.kf_pt[kf] < 0), self._to_dev(i1),
            self._to_dev(i2), self._to_dev(E), self._to_dev(Trel),
            self._to_dev(Tcw), self.params))

        # endpoint dedup across pairs: a slot an earlier pair consumed is
        # no longer free
        taken = np.zeros((C, K), bool)
        new_ids = []
        for pidx, (c1, c2, _) in enumerate(pairs):
            sel = np.nonzero(good[pidx])[0]
            if len(sel) == 0:
                continue
            j = match[pidx, sel]
            ok = ~taken[c1, sel] & ~taken[c2, j]
            sel, j = sel[ok], j[ok]
            if len(sel) == 0:
                continue
            ids = m.alloc_points(len(sel))
            m.pt_pos[ids] = Xw[pidx, sel].astype(np.float32)
            m.pt_first_kf[ids] = kf
            for i, p in enumerate(ids):
                m.add_observation(int(p), kf, c1, int(sel[i]))
                m.add_observation(int(p), kf, c2, int(j[i]))
                self.recent_pts.append((int(p), kf))
            taken[c1, sel] = True
            taken[c2, j] = True
            new_ids.append(ids)
        if new_ids:
            m.update_point_stats(np.concatenate(new_ids), self._M_c_np,
                                 self.scale_factor, self.n_levels)

    def _median_depth_of_kf(self, kf: int) -> float:
        """cMultiKeyFrame::ComputeSceneMedianDepth (body frame)."""
        m = self.map
        pts = m.kf_pt[kf]
        pts = np.unique(pts[pts >= 0])
        if len(pts) == 0:
            return 0.0
        M = se3_np.cayley2hom(m.kf_pose[kf])
        return float(np.median(np.linalg.norm(m.pt_pos[pts] - M[:3, 3], axis=1)))

    # ------------------------------------------------------------------

    def _fuse_in_neighbors(self, kf: int):
        """SearchInNeighbors (:385-454): project this keyframe's points into
        its 1st and 2nd degree neighbours and fuse duplicates (one batched
        call over all targets), then the reverse direction."""
        m = self.map
        targets = m.covisible_keyframes(kf, best_n=10)
        second = []
        for t in targets[:5]:
            second.extend(m.covisible_keyframes(t, best_n=5))
        all_targets = [t for t in dict.fromkeys(targets + second)
                       if t != kf and m.kf_features[t] is not None]

        kf_pts = m.kf_pt[kf]
        kf_pts = np.unique(kf_pts[kf_pts >= 0])
        self.fuse_into_keyframes(kf_pts, all_targets)
        if all_targets:
            arr = m.kf_pt[np.asarray(all_targets, np.int64)]
            neigh_pts = np.unique(arr[arr >= 0])
            self.fuse_into_keyframes(neigh_pts, [kf])
        self._update_point_stats_for_kf(kf)

    def fuse_into_keyframes(self, pts: np.ndarray, targets: list[int]):
        """Project candidate landmarks into every target keyframe and fuse
        duplicates (Fuse, cORBmatcher.cpp:1265-1420): one batched frustum
        and match call over the stacked targets, then the merge / add
        bookkeeping per target in covisibility order."""
        m = self.map
        targets = [t for t in targets if m.kf_features[t] is not None]
        pts = np.asarray(pts, np.int64)
        pts = pts[m.pt_valid[pts]] if len(pts) else pts
        if len(pts) == 0 or not targets:
            return
        P = len(pts)
        cap = coarse_bucket(P, 1024)
        pad = lambda a, fill=0: np.concatenate(
            [a, np.full((cap - P,) + a.shape[1:], fill, a.dtype)], 0)
        Tn = len(targets)
        Tcap = coarse_bucket(Tn, 4)
        tg = targets + [targets[-1]] * (Tcap - Tn)
        feats = _stack_features([m.kf_features[t] for t in tg])
        poses = np.stack([m.kf_pose[t] for t in tg]).astype(np.float32)
        occ = np.stack([m.kf_pt[t] >= 0 for t in tg])
        match = fetch(self._fuse(
            self.rig, self._to_dev(poses), feats, self._to_dev(occ),
            self._to_dev(pad(m.pt_pos[pts])), self._to_dev(pad(m.pt_normal[pts])),
            self._to_dev(pad(m.pt_min_dist[pts])),
            self._to_dev(pad(m.pt_max_dist[pts], 1.0)),
            self._to_dev(np.arange(cap) < P), self._to_dev(pad(m.pt_desc[pts])),
            self._to_dev(pad(m.pt_desc_mask[pts])), self.params, th=3.0,
            n_levels=self.n_levels, scale_factor=self.scale_factor))[0]
        for t_idx, t in enumerate(targets):
            self._apply_fuse_matches(pts, t, match[t_idx], P)

    def _apply_fuse_matches(self, pts: np.ndarray, kf: int,
                            match: np.ndarray, P: int):
        m = self.map
        C = match.shape[0]
        for c in range(C):
            for i in np.nonzero(match[c, :P] >= 0)[0]:
                p = int(pts[i])
                # follow merges made earlier in this fuse pass
                while not m.pt_valid[p] and m.pt_forward[p] != p:
                    p = int(m.pt_forward[p])
                if not m.pt_valid[p]:
                    continue
                slot = int(match[c, i])
                existing = int(m.kf_pt[kf, c, slot])
                if existing >= 0 and existing != p:
                    # merge: keep the landmark with more observations
                    if len(m.pt_obs[existing]) >= len(m.pt_obs[p]):
                        m.replace_point(p, existing)
                    else:
                        m.replace_point(existing, p)
                elif existing < 0:
                    dup = [o for o in m.pt_obs[p] if o[0] == kf and o[1] == c]
                    if not dup:
                        m.add_observation(p, kf, c, slot)

    # ------------------------------------------------------------------

    def _local_bundle_adjustment(self, kf: int):
        """LocalBundleAdjustment (cOptimizer.cpp:461-874): the local
        keyframes are kf and its covisible set, the other observers of the
        local points are fixed, the points are marginalized; observations
        with high chi2 are pruned afterwards."""
        m = self.map
        local = [kf] + m.covisible_keyframes(kf)
        arr = m.kf_pt[np.asarray(local, np.int64)]
        pts = np.unique(arr[arr >= 0])
        pts = pts[m.pt_valid[pts]]
        if len(pts) == 0:
            return
        # fixed keyframes: out-of-window observers of the local points
        in_local_pts = np.zeros(m.pt_pos.shape[0], bool)
        in_local_pts[pts] = True
        in_window = np.zeros(m.kf_pt.shape[0], bool)
        in_window[np.asarray(local, np.int64)] = True
        rows = m.obs_rows()
        okf = rows[in_local_pts[rows[:, 0]], 1]
        fixed = set(np.unique(okf[~in_window[okf]]).tolist())
        kfs = local + sorted(fixed)
        # always fix keyframe 0 (gauge) and the out-of-window observers
        fixed_mask = np.zeros(len(kfs), bool)
        for i, k in enumerate(kfs):
            if k in fixed or k == 0:
                fixed_mask[i] = True
        if not (~fixed_mask).any():
            return
        built = assemble_ba_problem(m, kfs, fixed_mask, self.scale_factor,
                                    device=self.dev)
        if built is None:
            return
        problem, mt0, X0, pts, rows = built
        self._last_ba = (problem, mt0, X0)
        mt, X, chi2 = fetch(*self._bundle_adjust(
            self.rig, self._to_dev(mt0), self._to_dev(X0), problem,
            huber=opt.HUBER_LOCAL, iters=self.ba_iters))
        for i, k in enumerate(kfs):
            if not fixed_mask[i]:
                m.kf_pose[k] = mt[i]
        m.pt_pos[pts] = X[:len(pts)].astype(np.float32)
        # prune high-chi2 observations (cOptimizer.cpp:766-816)
        th = opt.HUBER_LOCAL ** 2
        for i in np.nonzero(chi2[:len(rows)] > th * 4)[0]:
            p, okf, c, s = rows[i]
            m.erase_observation(int(p), int(okf), int(c), int(s))
        # the BA moved poses and points: refresh the viewing rays and
        # distance ranges (cMapPoint::UpdateNormalAndDepth)
        self.map.update_point_stats(np.asarray(pts, np.int64), self._M_c_np,
                                    self.scale_factor, self.n_levels)

    # ------------------------------------------------------------------

    def _cull_keyframes(self, kf: int):
        """KeyFrameCulling (cLocalMapping.cpp:517-593): a covisible keyframe
        is redundant if 90% of its landmark observations are backed by at
        least maxNrObs = 5 other keyframes observing the point at
        finer-or-equal scale (level <= own level + 1). Only points with
        Observations() > 3 count (:548), and only each other keyframe's
        first observation of a point (:565)."""
        m = self.map
        cands = [c for c in m.covisible_keyframes(kf)
                 if c != 0 and m.kf_valid[c] and m.kf_host(c) is not None]
        if not cands:
            return
        rows = m.obs_rows()
        n_obs_per_pt = np.bincount(rows[:, 0], minlength=m.pt_pos.shape[0])
        # per-row octave, gathered per keyframe
        lvl_row = np.zeros(len(rows), np.int32)
        ok_row = np.zeros(len(rows), bool)
        srt = np.argsort(rows[:, 1], kind="stable")
        rs = rows[srt]
        uk, starts = np.unique(rs[:, 1], return_index=True)
        for i, okf in enumerate(uk):
            end = starts[i + 1] if i + 1 < len(uk) else len(rows)
            sl = srt[starts[i]:end]
            host = m.kf_host(int(okf))
            if host is None:
                continue
            lvl_row[sl] = host.level[rows[sl, 2], rows[sl, 3]]
            ok_row[sl] = True
        # each other keyframe's first observation of a point, in log order
        key = rows[:, 0].astype(np.int64) * m.kf_pt.shape[0] + rows[:, 1]
        _, first_idx = np.unique(key, return_index=True)
        first = np.zeros(len(rows), bool)
        first[first_idx] = True

        for cand in cands:
            if not m.kf_valid[cand]:
                continue
            host_cand = m.kf_host(cand)
            if host_cand is None:
                continue
            cams, slots = np.nonzero(m.kf_pt[cand] >= 0)
            if len(cams) == 0:
                continue
            p_i = m.kf_pt[cand, cams, slots]
            lvl_i = host_cand.level[cams, slots].astype(np.int32)
            uniq, inv = np.unique(p_i, return_inverse=True)
            pt_idx_of = np.full(m.pt_pos.shape[0], -1, np.int64)
            pt_idx_of[uniq] = np.arange(len(uniq))
            selr = (first & ok_row & (rows[:, 1] != cand)
                    & (pt_idx_of[rows[:, 0]] >= 0))
            hist = np.zeros((len(uniq), self.n_levels), np.int32)
            np.add.at(hist, (pt_idx_of[rows[selr, 0]],
                             np.clip(lvl_row[selr], 0, self.n_levels - 1)), 1)
            cum = np.cumsum(hist, axis=1)
            n_finer = cum[inv, np.clip(lvl_i + 1, 0, self.n_levels - 1)]
            redundant = ((n_obs_per_pt[p_i] > KF_CULL_PREGATE_OBS)
                         & (n_finer >= KF_CULL_MIN_OBS))
            if redundant.sum() > KF_CULL_REDUNDANT * len(cams):
                m.remove_keyframe(cand)
                # mask out the removed keyframe's rows for later candidates
                dead = rows[:, 1] == cand
                ok_row[dead] = False
                first[dead] = False
                n_obs_per_pt = n_obs_per_pt - np.bincount(
                    rows[dead, 0], minlength=len(n_obs_per_pt))
