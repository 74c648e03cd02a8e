"""Loop closing (cLoopClosing.{h,cpp} and cSim3Solver).

Port of ``multicol_slam_tpu/models/loop_closing.py``. The reference's
pipeline per keyframe (cLoopClosing.cpp:63-98):
  DetectLoop (:113-245): >= 10 keyframes since the last loop; minScore is
    the lowest BoW score among the query's covisible keyframes; database
    candidates must stay covisibility-consistent over 3 detections.
  ComputeSim3 (:247-427): SearchByBoW >= 15 pairs, Sim3 RANSAC (Horn on
    3 pairs, bidirectional rig-reprojection gate), guided SearchBySim3,
    OptimizeSim3 >= 20 inliers, then >= 20 matches with the candidate's
    neighbourhood.
  CorrectLoop (:429-595): correct the current covisible group and its
    points, fuse duplicates, add loop edges, optimize the essential graph,
    tell the tracker.

The BoW transform, both SearchByBoW sites, the Sim3 hypotheses and their
scoring, the guided searches and both optimizations are device batches on
the rig's device; candidate bookkeeping and map surgery are host numpy.
Every descriptor search launches the Hamming-NN kernel's entry A
(``matcher.search_by_bow``, ``matcher.fuse_candidates`` and the mapper's
fuse).

The JAX package jits four units on this path: ``optimize_sim3``,
``optimize_essential_graph``, ``fuse_candidates`` (the guided
SearchBySim3 and the neighbourhood support) and the post-loop global
``bundle_adjustment``. On the card the closer runs them as CUDA graphs
(``utils/graphs.py``) in the pool it is given (the system hands it the
mapper's, whose thread it runs on under async mapping, and the mapper's
graphed BA); on the CPU it calls the modules' functions. Their inputs are
padded so that a graph's key comes back: the Sim3 pairs and the
projected landmarks to ``coarse_bucket``s, the essential graph's edges
and keyframes too. The Sim3 RANSAC stays eager, as the JAX package's
``vmap`` of it stays outside ``jit``.

The BoW transform (the JAX package's jitted ``_transform_impl``) runs on
two threads: a keyframe's on the closer's (``kf_transform``, a graph in
the closer's pool on the card), a relocalizing frame's on the tracker's
(``frame_transform``, which the system hands over from the tracker, a
graph of the tracker's pool), since graphs of one pool replay one at a
time. ``bow_match_frame`` transforms the frame once per relocalization.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..ops import se3_np
from ..ops.rig import Rig
from ..ops.sim3 import Sim3, horn_alignment, sim3_exp, sim3_from_se3, sim3_log
from ..utils import graphs
from . import matcher
from . import optimizer as opt
from . import sim3_opt
from .global_ba import run_global_ba
from .keyframe_database import KeyFrameDatabase
from .local_mapping import coarse_bucket
from .map import MapStore
from .tracking import fetch, frustum_check, to_device
from . import vocabulary
from .vocabulary import Vocabulary, bow_score_l1, bow_vector

MIN_KFS_BETWEEN_LOOPS = 10     # cLoopClosing.cpp:125
CONSISTENCY_TH = 3             # 3 consecutive consistent detections
MIN_BOW_MATCHES = 15           # :258
MIN_SIM3_INLIERS = 20          # :343-364
MIN_TOTAL_MATCHES = 20         # :400-424
MIN_FEAT_GRAPH = 100           # cOptimizerLoopStuff.cpp:303 minNumFeat
RANSAC_HYPS = 256
RANSAC_CHI2 = 9.21             # per-direction gate (cSim3Solver.cpp:374-415)
# the smallest padded sizes (each grows by fours, ``coarse_bucket``): Sim3
# pairs, landmarks projected through a Sim3, essential-graph edges and
# keyframes
SIM3_PAIRS_MIN = 256
PROJECTED_MIN = 256
GRAPH_EDGES_MIN = 64
GRAPH_KFS_MIN = 16
# the jitted units of the loop path, by the module that defines each
UNITS = {"optimize_sim3": sim3_opt, "optimize_essential_graph": sim3_opt,
         "fuse_candidates": matcher, "bundle_adjustment": opt}


def sample_sim3_sets(gen: torch.Generator, n_hyps: int, n: int) -> torch.Tensor:
    """(n_hyps, 3) indices of the Sim3 RANSAC's 3-pair samples, uniform
    over the n pairs, on ``gen``'s device. Tests replace it to inject the
    JAX package's draws."""
    return torch.randint(0, n, (n_hyps, 3), generator=gen, device=gen.device)


def _sim3_np(S: Sim3):
    """(s, R, t) of a Sim3 (batched or not) as float64 numpy."""
    return tuple(a.astype(np.float64) for a in fetch(S.s, S.R, S.t))


def _apply_sim3_np(S, X: np.ndarray) -> np.ndarray:
    """Host-side Sim3 apply on (N, 3) numpy points; S is a Sim3 or its
    ``_sim3_np`` tuple."""
    s, R, t = _sim3_np(S) if isinstance(S, Sim3) else S
    return s * X @ R.T + t


def _index(S: Sim3, i) -> Sim3:
    return Sim3(S.s[i], S.R[i], S.t[i])


@dataclasses.dataclass
class LoopCloser:
    rig: Rig
    map: MapStore
    voc: Vocabulary
    db: KeyFrameDatabase
    params: matcher.MatchParams
    # the rig is metric, so Sim3 scale is observable: hold it in
    # OptimizeSim3 and the essential graph (see optimize_essential_graph)
    fix_scale: bool = True
    fuser: object = None          # LocalMapper for the post-correction fuse
    # post-loop global BA (ORB-SLAM2's RunGlobalBundleAdjustment), off by
    # default as in the JAX package: from an undistributed init it can
    # bend the map it should unbend
    global_ba_iters: int = 0
    scale_factor: float = 1.2
    n_levels: int = 8
    # on the card: the graphs.Pool of the units' graphs (a pool of the
    # closer's own if None) and a (graphed) bundle_adjustment to share
    pool: object = None
    bundle_adjust: object = None
    # the tracker's BoW transform of a frame (vocabulary.transform_words'
    # signature; its graph on the card), for bow_match_frame; the
    # closer's own transform if None
    frame_transform: object = None

    def __post_init__(self):
        self.dev = self.rig.M_c.device
        self.voc = self.voc.to(self.dev)
        self.last_loop_kf = -MIN_KFS_BETWEEN_LOOPS
        self.consistent_groups: list[tuple[set[int], int]] = []
        self.kf_words: dict[int, np.ndarray] = {}
        self.kf_nodes: dict[int, np.ndarray] = {}
        self.on_loop = None          # callback(kf, loop_kf) after a correction
        # the Sim3 RANSAC's sampling stream (the JAX package's PRNGKey(7))
        self.gen = torch.Generator(device=self.dev).manual_seed(7)
        # the jitted units: CUDA graphs on the card, none on the CPU
        self.graphs: dict = {}
        if self.dev.type == "cuda":
            if self.pool is None:
                self.pool = graphs.Pool("loop")
            pool = self.pool
            self.graphs = {name: graphs.jit(getattr(mod, name), pool)
                           for name, mod in UNITS.items()}
            if self.bundle_adjust is not None:
                self.graphs["bundle_adjustment"] = self.bundle_adjust
        # a keyframe's BoW transform, on the closer's thread: a graph of its
        # pool on the card, vocabulary.transform_words at the call on the CPU
        self.kf_transform = (graphs.jit(vocabulary.transform_words, pool)
                             if self.dev.type == "cuda" else None)
        self._frame_nodes = None     # (features, vocabulary, nodes) of the last frame

    def unit(self, name: str):
        """The jitted unit ``name`` of ``UNITS``: its graph on the card; on
        the CPU the module's function as it stands at the call."""
        g = self.graphs.get(name)
        return g if g is not None else getattr(UNITS[name], name)

    def _to_dev(self, a, dtype=None) -> torch.Tensor:
        return to_device(a, self.dev, dtype)

    def reset(self):
        """cLoopClosing::RequestReset (cTracking.cpp:1327-1375): clear the
        inverted file and the BoW caches, so a fresh map's reused
        keyframe ids meet no stale entries."""
        self.db.clear()
        self.kf_words.clear()
        self.kf_nodes.clear()
        self.consistent_groups.clear()
        self.last_loop_kf = -MIN_KFS_BETWEEN_LOOPS
        self._frame_nodes = None

    def set_vocabulary(self, voc: Vocabulary):
        """Swap in a (re)trained vocabulary and rebuild the BoW caches and
        the inverted file of every keyframe in the database."""
        self.voc = voc.to(self.dev)
        self.kf_words.clear()
        self.kf_nodes.clear()
        kfs = list(self.db.kf_bow)
        self.db.clear()
        for kf in kfs:
            if self.map.kf_valid[kf] and self.map.kf_features[kf] is not None:
                self.db.add(kf, bow_vector(self.voc, self._bow_of_kf(kf)[0]))

    def forget_keyframe(self, kf: int):
        """A culled keyframe leaves the place-recognition state
        (cMultiKeyFrame::SetBadFlag erases it from the database);
        otherwise it keeps winning candidacies it cannot serve and resets
        the consistency chain."""
        self.db.erase(kf)
        self.kf_words.pop(kf, None)
        self.kf_nodes.pop(kf, None)
        self.consistent_groups = [
            (g - {kf}, c) for g, c in self.consistent_groups if g - {kf}]

    # ------------------------------------------------------------------

    def _transform(self, feats, transform=None):
        """(word, node at depth 1) per slot of a Features batch, on its
        device, through ``transform`` (the closer's own by default).
        Words score at leaf resolution; SearchByBoW gates on the depth-1
        nodes (levelsup = levels - 1), since a vocabulary trained on the
        map's own frames quantizes deeper nodes unstably across a loop's
        change of viewpoint."""
        transform = transform or self.kf_transform or vocabulary.transform_words
        W = feats.desc.shape[-1]
        return transform(self.voc, feats.desc.reshape(-1, W),
                         feats.valid.reshape(-1), levelsup=self.voc.levels - 1)

    def _bow_of_kf(self, kf: int, transform=None):
        """A keyframe's (words, depth-1 nodes) on the host, cached; computed
        through ``transform`` (the caller thread's) when not cached yet."""
        if kf not in self.kf_words:
            words, nodes = fetch(*self._transform(self.map.kf_features[kf], transform))
            self.kf_words[kf] = words
            self.kf_nodes[kf] = nodes
        return self.kf_words[kf], self.kf_nodes[kf]

    def insert_keyframe(self, kf: int) -> bool:
        """Process one keyframe; returns True if a loop was closed."""
        words, _ = self._bow_of_kf(kf)
        bow = bow_vector(self.voc, words)
        candidates = self._detect_loop(kf, bow)
        self.db.add(kf, bow)
        for cand in candidates:
            if self._compute_sim3_and_correct(kf, cand):
                self.last_loop_kf = kf
                self.consistent_groups.clear()
                return True
        return False

    def _detect_loop(self, kf: int, bow) -> list[int]:
        """DetectLoop (cLoopClosing.cpp:113-245)."""
        m = self.map
        if kf < self.last_loop_kf + MIN_KFS_BETWEEN_LOOPS:
            return []
        # exclusion: the connected keyframes (GetConnectedKeyFrames,
        # cMultiKeyFrameDatabase.cpp:85-105)
        connected = set(m.connected_keyframes(kf))
        # minScore: the lowest BoW score of the covisibility list (:132-151)
        min_score = 1.0
        for ckf in m.covisible_keyframes(kf):
            if ckf in self.db.kf_bow:
                min_score = min(min_score, bow_score_l1(bow, self.db.kf_bow[ckf]))
        cands = self.db.detect_loop_candidates(kf, bow, min_score, m, connected)
        cands = [c for c in cands if m.kf_valid[c] and m.kf_features[c] is not None]
        if not cands:
            self.consistent_groups = []
            return []
        # covisibility consistency over consecutive detections (:166-241)
        new_groups: list[tuple[set[int], int]] = []
        enough: list[int] = []
        for cand in cands:
            group = set(m.connected_keyframes(cand)) | {cand}
            matched = False
            for prev_group, count in self.consistent_groups:
                if group & prev_group:
                    new_groups.append((group, count + 1))
                    matched = True
                    if count + 1 >= CONSISTENCY_TH:
                        enough.append(cand)
                    break
            if not matched:
                new_groups.append((group, 1))
        self.consistent_groups = new_groups
        return enough

    # ------------------------------------------------------------------

    def _matched_point_pairs(self, kf1: int, kf2: int):
        """SearchByBoW between two keyframes (cORBmatcher.cpp:885): the
        slots carrying landmarks, gated to equal depth-1 nodes, one kernel
        call over all cameras. Returns (pt1, pt2, cam1, slot1, cam2, slot2)
        tuples."""
        m = self.map
        f1, f2 = m.kf_features[kf1], m.kf_features[kf2]
        if f1 is None or f2 is None:
            return []
        _, nodes1 = self._bow_of_kf(kf1)
        _, nodes2 = self._bow_of_kf(kf2)
        C, K = m.kf_pt.shape[1:3]
        W = f1.desc.shape[-1]
        match = fetch(matcher.search_by_bow(
            f1.desc.reshape(-1, W), self._to_dev((m.kf_pt[kf1] >= 0).reshape(-1)),
            self._to_dev(nodes1), f2.desc.reshape(-1, W),
            self._to_dev((m.kf_pt[kf2] >= 0).reshape(-1)), self._to_dev(nodes2),
            self.params))[0]
        idx = np.nonzero(match >= 0)[0]
        c1, s1 = np.divmod(idx, K)
        c2, s2 = np.divmod(match[idx], K)
        p1 = m.kf_pt[kf1, c1, s1]
        p2 = m.kf_pt[kf2, c2, s2]
        ok = (p1 >= 0) & (p2 >= 0)
        ok &= m.pt_valid[np.clip(p1, 0, None)] & m.pt_valid[np.clip(p2, 0, None)]
        return list(zip(p1[ok].tolist(), p2[ok].tolist(), c1[ok].tolist(),
                        s1[ok].tolist(), c2[ok].tolist(), s2[ok].tolist()))

    def bow_match_frame(self, kf: int, feats) -> list[tuple[int, int, int]]:
        """SearchByBoW(KF, F) (cORBmatcher.cpp:179-323), relocalization's
        matcher: the keyframe's landmark slots against a frame's features,
        gated to equal depth-1 nodes. Returns (point, frame cam, frame
        slot) triples."""
        m = self.map
        f1 = m.kf_features[kf]
        if f1 is None:
            return []
        _, nodes1 = self._bow_of_kf(kf, self.frame_transform)
        K = m.kf_pt.shape[2]
        W = f1.desc.shape[-1]
        # the frame's nodes once per relocalization: every candidate
        # keyframe is matched against the same features
        fn = self._frame_nodes
        if fn is None or fn[0] is not feats or fn[1] is not self.voc:
            fn = self._frame_nodes = (feats, self.voc,
                                      self._transform(feats, self.frame_transform)[1])
        nodes2 = fn[2]
        match = fetch(matcher.search_by_bow(
            f1.desc.reshape(-1, W), self._to_dev((m.kf_pt[kf] >= 0).reshape(-1)),
            self._to_dev(nodes1), feats.desc.reshape(-1, W), feats.valid.reshape(-1),
            nodes2, self.params))[0]
        K2 = feats.desc.shape[1]
        idx = np.nonzero(match >= 0)[0]
        c1, s1 = np.divmod(idx, K)
        p = m.kf_pt[kf, c1, s1]
        ok = (p >= 0) & m.pt_valid[np.clip(p, 0, None)]
        c2, s2 = np.divmod(match[idx[ok]], K2)
        return list(zip(p[ok].tolist(), c2.tolist(), s2.tolist()))

    def _body_frame_points(self, kf: int, pt_ids) -> np.ndarray:
        Minv = np.linalg.inv(se3_np.cayley2hom(self.map.kf_pose[kf]))
        X = self.map.pt_pos[np.asarray(pt_ids, np.int32)]
        return X @ Minv[:3, :3].T + Minv[:3, 3]

    def _compute_sim3_and_correct(self, kf: int, cand: int) -> bool:
        """ComputeSim3 (cLoopClosing.cpp:247-427), then CorrectLoop."""
        # pairs of one landmark on both sides carry no alignment
        # information (tracking already re-associated them) and only vote
        # for a no-op correction
        pairs = [p for p in self._matched_point_pairs(kf, cand) if p[0] != p[1]]
        if len(pairs) < MIN_BOW_MATCHES:
            return False
        S12 = self._compute_sim3(kf, cand, pairs)
        if S12 is None:
            return False
        self._correct_loop(kf, cand, S12)
        if self.on_loop:
            self.on_loop(kf, cand)
        return True

    def _compute_sim3(self, kf: int, cand: int, pairs) -> Sim3 | None:
        """ComputeSim3's estimation on the BoW pairs (kf1 point, kf2 point,
        cam1, slot1, cam2, slot2): Sim3 RANSAC, OptimizeSim3, the guided
        round and the neighbourhood support. Returns S12 (cand body -> kf
        body) or None when a gate fails."""
        X1 = self._body_frame_points(kf, [p[0] for p in pairs])
        X2 = self._body_frame_points(cand, [p[1] for p in pairs])
        obs = self._make_sim3_obs(kf, cand, pairs, X1, X2)

        # Sim3 RANSAC: Horn on 3 pairs per hypothesis, scored by the
        # bidirectional reprojection gate through the rig
        idx = sample_sim3_sets(self.gen, RANSAC_HYPS, len(pairs)).to(self.dev).long()
        S_hyp = horn_alignment(obs.X1[idx], obs.X2[idx], fix_scale=self.fix_scale)
        c1, c2 = sim3_opt.sim3_chi2(self.rig, S_hyp, obs)
        scores = ((c1 <= RANSAC_CHI2) & (c2 <= RANSAC_CHI2) & obs.valid).sum(1)
        best = int(torch.argmax(scores))
        if int(scores[best]) < MIN_SIM3_INLIERS // 2:
            return None

        # OptimizeSim3
        S12, _, n_in = self.unit("optimize_sim3")(self.rig, _index(S_hyp, best), obs,
                                                  iters=10, fix_scale=self.fix_scale)
        n_in = int(n_in)
        if n_in < MIN_SIM3_INLIERS:
            return None

        # guided SearchBySim3 (:343-364): the candidate's landmarks through
        # S12 pick up pairs BoW missed; the enlarged set is re-optimized
        extra = self._guided_sim3_pairs(kf, cand, S12, {(a, b) for a, b, *_ in pairs})
        if extra:
            pairs2 = pairs + extra
            obs2 = self._make_sim3_obs(
                kf, cand, pairs2, self._body_frame_points(kf, [p[0] for p in pairs2]),
                self._body_frame_points(cand, [p[1] for p in pairs2]))
            S12b, _, n_in2 = self.unit("optimize_sim3")(self.rig, S12, obs2, iters=10,
                                                        fix_scale=self.fix_scale)
            if int(n_in2) >= n_in:
                S12, n_in = S12b, int(n_in2)

        # the loop neighbourhood's support (:400-424)
        if n_in + self._count_neighborhood_support(kf, cand, S12) < MIN_TOTAL_MATCHES:
            return None
        return S12

    def _project_through_sim3(self, kf: int, cand: int, pts: np.ndarray, S12: Sim3):
        """Landmarks ``pts`` of the candidate's side mapped into kf's body
        by S12, projected into kf at the frustum gate with the distance
        range widened 2x (the estimate carries the loop drift), then one
        fuse search at TH_HIGH (SearchBySim3, cORBmatcher.cpp:1869).
        Returns (C, P) kf slot per point."""
        m = self.map
        P = len(pts)
        Xk = fetch(S12.apply(self._to_dev(self._body_frame_points(cand, pts))))[0]
        M_kf = se3_np.cayley2hom(m.kf_pose[kf])
        Xw = Xk @ M_kf[:3, :3].T + M_kf[:3, 3]
        cap = coarse_bucket(P, PROJECTED_MIN)
        pad = lambda a, fill=0: self._to_dev(np.concatenate(
            [a, np.full((cap - P,) + a.shape[1:], fill, a.dtype)], 0))
        uv, ok, lvl, _ = frustum_check(
            self.rig, self._to_dev(m.kf_pose[kf]), pad(Xw.astype(np.float32)),
            pad(m.pt_normal[pts]), pad(m.pt_min_dist[pts]), pad(m.pt_max_dist[pts], 1.0),
            n_levels=self.n_levels, scale_factor=self.scale_factor, dist_slack=2.0)
        ok = ok & (torch.arange(cap, device=self.dev) < P)
        match = self.unit("fuse_candidates")(
            m.kf_features[kf], self._to_dev(m.kf_pt[kf] >= 0), pad(m.pt_desc[pts]),
            pad(m.pt_desc_mask[pts]), uv, ok, lvl, self.params, th=7.5,
            loose_desc=True)
        return fetch(match)[0][:, :P]

    def _guided_sim3_pairs(self, kf, cand, S12: Sim3, have):
        """SearchBySim3: the candidate's landmarks projected into kf
        through S12 against kf's landmark slots. The reverse measurement of
        each new pair is p2's own first observation in the candidate, the
        reference's GetIndexInKeyFrame(pKF2) (cOptimizerLoopStuff.cpp:128)."""
        m = self.map
        arr = m.kf_pt[cand]
        cand_pts = np.unique(arr[arr >= 0])
        cand_pts = cand_pts[m.pt_valid[cand_pts]]
        if len(cand_pts) == 0:
            return []
        match = self._project_through_sim3(kf, cand, cand_pts, S12)
        rows = m.obs_rows()
        rows = rows[rows[:, 1] == cand]
        _, first = np.unique(rows[:, 0], return_index=True)
        obs_cam = np.full(m.pt_pos.shape[0], -1, np.int32)
        obs_slot = np.full(m.pt_pos.shape[0], -1, np.int32)
        obs_cam[rows[first, 0]] = rows[first, 2]
        obs_slot[rows[first, 0]] = rows[first, 3]
        cidx, iidx = np.nonzero(match >= 0)
        slots = match[cidx, iidx]
        p1 = m.kf_pt[kf, cidx, slots]
        p2 = cand_pts[iidx]
        ok = (p1 >= 0) & m.pt_valid[np.clip(p1, 0, None)] & (obs_cam[p2] >= 0)
        return [(int(a), int(b), int(c), int(s), int(c2), int(s2))
                for a, b, c, s, c2, s2
                in zip(p1[ok], p2[ok], cidx[ok], slots[ok], obs_cam[p2[ok]],
                       obs_slot[p2[ok]])
                if (int(a), int(b)) not in have]

    def _count_neighborhood_support(self, kf, cand, S12: Sim3) -> int:
        """Matches of the landmarks of the candidate's covisible
        neighbourhood (not the candidate's own) projected into kf through
        S12."""
        m = self.map
        neigh = m.covisible_keyframes(cand, best_n=10)
        if not neigh:
            return 0
        arr = m.kf_pt[np.asarray(neigh, np.int64)]
        pts = np.unique(arr[arr >= 0])
        pts = pts[m.pt_valid[pts]]
        own = m.kf_pt[cand]
        pts = pts[~np.isin(pts, own[own >= 0])].astype(np.int32)
        if len(pts) == 0:
            return 0
        return int((self._project_through_sim3(kf, cand, pts, S12) >= 0).sum())

    def _make_sim3_obs(self, kf1, kf2, pairs, X1, X2) -> sim3_opt.Sim3Obs:
        """The pairs' Sim3Obs, padded to ``coarse_bucket(n, SIM3_PAIRS_MIN)``
        rows: a padded row repeats the first pair with ``valid`` False, a
        finite point in front of its camera (a zero point's projection
        Jacobian is NaN, and NaN times a zero weight is NaN in H), so it
        adds exact zeros to OptimizeSim3's H, g and cost."""
        m = self.map
        h1, h2 = m.kf_host(kf1), m.kf_host(kf2)
        n = len(pairs)
        rows = np.concatenate([np.arange(n), np.zeros(coarse_bucket(n, SIM3_PAIRS_MIN) - n,
                                                      np.int64)])
        a = np.asarray(pairs, np.int64).reshape(-1, 6)[rows]
        X1, X2 = np.asarray(X1)[rows], np.asarray(X2)[rows]
        c1, s1, c2, s2 = a[:, 2], a[:, 3], a[:, 4], a[:, 5]
        sf = self.params.scale_factor
        return sim3_opt.Sim3Obs(
            X1=self._to_dev(X1), X2=self._to_dev(X2),
            uv1=self._to_dev(h1.xy[c1, s1]),
            uv2=self._to_dev(h2.xy[c2, s2]),
            cam1=self._to_dev(c1.astype(np.int32)), cam2=self._to_dev(c2.astype(np.int32)),
            inv_sigma2_1=self._to_dev(sf ** (-2.0 * h1.level[c1, s1].astype(np.float64))),
            inv_sigma2_2=self._to_dev(sf ** (-2.0 * h2.level[c2, s2].astype(np.float64))),
            valid=self._to_dev(np.arange(len(rows)) < n))

    # ------------------------------------------------------------------

    def _siw_logs(self, poses: np.ndarray) -> np.ndarray:
        """sim3_log of each world-to-body transform of (N, 6) poses."""
        Minv = np.stack([np.linalg.inv(se3_np.cayley2hom(p)) for p in poses])
        return fetch(sim3_log(sim3_from_se3(self._to_dev(Minv))))[0]

    def _body_poses(self, S: Sim3) -> np.ndarray:
        """Body-to-world cayley poses of world-to-body Sim3s (SE3 with t / s,
        cOptimizerLoopStuff.cpp:480-484)."""
        return np.stack([se3_np.hom2cayley(np.linalg.inv(T))
                         for T in fetch(S.to_se3())[0].reshape(-1, 4, 4)])

    def _correct_loop(self, kf: int, loop_kf: int, S12: Sim3):
        """CorrectLoop (cLoopClosing.cpp:429-595) and the essential graph
        (cOptimizerLoopStuff.cpp:267-513), in the reference's order:

        1. snapshot every keyframe's pre-correction world->body Sim3
           (NonCorrectedSim3, :448-470);
        2. correct the current covisible group and its points, each member
           through its own relative pose to kf, S_i_new = S_i S_kf^-1
           S_corr (:471-524), which keeps intra-group relative poses exact;
        3. SearchAndFuse the loop region's landmarks into the group (:548);
        4. collect the new links the fusion made (LoopConnections,
           :550-570);
        5. optimize the essential graph: the new loop edges measured from
           the corrected estimates, spanning-tree, old-loop and strong
           covisibility edges from the pre-correction poses, so the loop
           error spreads over the trajectory (:330-428);
        6. write the poses back and remap each point through its corrected
           reference or first observer (:490-512);
        then record the loop edge (after the graph, so the fired pair is
        in it only as a loop edge) and run the optional global BA."""
        m = self.map
        kf_ids = m.keyframe_ids().tolist()
        idx_of = {k: i for i, k in enumerate(kf_ids)}
        N = len(kf_ids)
        exp = lambda logs: sim3_exp(self._to_dev(logs))

        # (1)
        logs_pre = self._siw_logs(m.kf_pose[kf_ids])
        S_kf = exp(logs_pre[idx_of[kf]])
        S_corr = S12.compose(exp(logs_pre[idx_of[loop_kf]]))

        group = set(m.covisible_keyframes(kf)) | {kf}
        # the loop keyframe anchors the correction (fixed in the graph):
        # never correct it, even if tracking made it covisible
        group.discard(loop_kf)
        pre_conn = {g: set(m.covisible_keyframes(g)) for g in group}

        # (2)
        logs_init = logs_pre.copy()
        corrected_by: dict[int, int] = {}     # point -> corrected reference
        S_kf_inv = S_kf.inverse()
        for gkf in group:
            i = idx_of[gkf]
            S_old = exp(logs_pre[i])
            S_new = S_old.compose(S_kf_inv).compose(S_corr)
            logs_init[i] = fetch(sim3_log(S_new))[0]
            arr = m.kf_pt[gkf]
            pts = np.unique(arr[arr >= 0])
            pts = pts[m.pt_valid[pts]] if len(pts) else pts
            pts = np.asarray([p for p in pts if int(p) not in corrected_by], np.int32)
            if len(pts):
                Xb = _apply_sim3_np(S_old, m.pt_pos[pts].astype(np.float64))
                m.pt_pos[pts] = _apply_sim3_np(S_new.inverse(), Xb).astype(np.float32)
                for p in pts:
                    corrected_by[int(p)] = i
            m.kf_pose[gkf] = self._body_poses(S_new)[0]

        # (3)
        if self.fuser is not None:
            nks = np.asarray([loop_kf] + m.covisible_keyframes(loop_kf, best_n=10), np.int64)
            arr2 = m.kf_pt[nks]
            loop_pts = np.unique(arr2[arr2 >= 0])
            loop_pts = loop_pts[m.pt_valid[loop_pts]].astype(np.int32)
            self.fuser.fuse_into_keyframes(loop_pts, [g for g in group if m.kf_valid[g]])

        # (4)
        loop_connections: list[tuple[int, int]] = [(kf, loop_kf)]
        for g in group:
            if not m.kf_valid[g]:
                continue
            for nk in set(m.covisible_keyframes(g)) - pre_conn[g] - group:
                loop_connections.append((g, nk))

        # (5) the pre-measured spanning-tree edges are added independently
        # of the loop edges: a boundary pair may carry both, and the
        # pre edge's residual is what the graph spreads around the cycle
        edges = []        # (i, j, measured from the corrected estimates)
        loop_pairs = set()
        # new loop constraints at minNumFeat = 100 except the fired pair
        # (cOptimizerLoopStuff.cpp:362-365): fusion also makes weak
        # cross-links that would staple the graph in its broken state
        for a, b in loop_connections:
            if a not in idx_of or b not in idx_of:
                continue
            if (a, b) in loop_pairs or (b, a) in loop_pairs:
                continue
            if not (a == kf and b == loop_kf) \
                    and m.covisibility_weights(a).get(b, 0) < MIN_FEAT_GRAPH:
                continue
            loop_pairs.add((a, b))
            edges.append((idx_of[a], idx_of[b], True))
        # odometry-era constraints: spanning tree, earlier loops and strong
        # covisibility, pre-correction; covisibility pairs with a loop edge
        # are skipped (the drifted relative would fight it one to one)
        for k in kf_ids:
            par = int(m.kf_parent[k])
            if par >= 0 and par in idx_of:
                edges.append((idx_of[par], idx_of[k], False))
            for le in m.kf_loop_edges.get(k, ()):
                if le in idx_of and le < k:
                    edges.append((idx_of[le], idx_of[k], False))
            for ok_, wt in m.covisibility_weights(k).items():
                if wt >= MIN_FEAT_GRAPH and ok_ in idx_of and ok_ < k \
                        and (ok_, k) not in loop_pairs and (k, ok_) not in loop_pairs:
                    edges.append((idx_of[ok_], idx_of[k], False))
        if not edges:
            return
        e = np.asarray(edges, np.int64)
        src = np.where(e[:, 2:3] == 1, logs_init[e[:, 0]], logs_pre[e[:, 0]])
        dst = np.where(e[:, 2:3] == 1, logs_init[e[:, 1]], logs_pre[e[:, 1]])
        meas = fetch(sim3_log(exp(src).compose(exp(dst).inverse())))[0]
        # padded to buckets that grow by fours, as the JAX package pads
        # against recompiles (its buckets grow by 16 edges and 8 keyframes)
        E = len(e)
        Ecap, Ncap = coarse_bucket(E, GRAPH_EDGES_MIN), coarse_bucket(N, GRAPH_KFS_MIN)
        fixed = np.ones(Ncap, bool)       # padding vertices held fixed
        fixed[:N] = False
        fixed[idx_of[loop_kf]] = True
        pad_e = lambda a: np.concatenate([a, np.zeros((Ecap - E,) + a.shape[1:], a.dtype)])
        graph = sim3_opt.EssentialGraph(
            edge_i=self._to_dev(pad_e(e[:, 0])), edge_j=self._to_dev(pad_e(e[:, 1])),
            meas=self._to_dev(pad_e(meas)), valid=self._to_dev(np.arange(Ecap) < E),
            fixed=self._to_dev(fixed))
        logs_in = np.concatenate([logs_init, np.zeros((Ncap - N, 7), logs_init.dtype)])
        logs_opt = fetch(self.unit("optimize_essential_graph")(
            self._to_dev(logs_in), graph, iters=20, fix_scale=self.fix_scale))[0][:N]

        # (6)
        m.kf_pose[kf_ids] = self._body_poses(exp(logs_opt))
        S_init = _sim3_np(exp(logs_init))
        S_opt_inv = _sim3_np(exp(logs_opt).inverse())
        by_ref: dict[int, list[int]] = {}
        for p in m.point_ids():
            p = int(p)
            if p in corrected_by:
                by_ref.setdefault(corrected_by[p], []).append(p)
            else:
                obs = m.pt_obs.get(p)
                if obs and obs[0][0] in idx_of:
                    by_ref.setdefault(idx_of[obs[0][0]], []).append(p)
        for i, plist in by_ref.items():
            pts = np.asarray(plist, np.int32)
            Xb = _apply_sim3_np(tuple(x[i] for x in S_init), m.pt_pos[pts].astype(np.float64))
            m.pt_pos[pts] = _apply_sim3_np(tuple(x[i] for x in S_opt_inv), Xb
                                           ).astype(np.float32)

        m.kf_loop_edges[kf].add(loop_kf)
        m.kf_loop_edges[loop_kf].add(kf)
        if self.global_ba_iters > 0:
            self._global_ba(loop_kf)

    def _global_ba(self, fixed_kf: int):
        """Post-loop global BA through ``global_ba.run_global_ba``, the
        loop keyframe as the gauge so the corrected region anchors the
        map, with the closer's bundle_adjustment unit and, sharded, the
        closer's pool (the mapper's when the system wires it)."""
        run_global_ba(self.rig, self.map, [fixed_kf], self.scale_factor,
                      iters=self.global_ba_iters,
                      bundle_adjust=self.unit("bundle_adjustment"), pool=self.pool)

