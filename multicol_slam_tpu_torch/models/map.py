"""Map store: fixed-capacity landmark and keyframe pools on the host.

Port of ``multicol_slam_tpu/models/map.py`` (reference cMap.h:42-89,
cMapPoint.h, cMultiKeyFrame.h): landmarks live in a growable pool with
validity masks and keyframes in another; the covisibility graph
(cMultiKeyFrame.cpp:406-500), spanning tree (:502-560) and observation
lists are host numpy and Python, as in the JAX package, since they drive
control flow. Device work consumes padded snapshots of the pools.

Observation bookkeeping mirrors cMapPoint::observations (one
observation per keyframe and camera, cMapPoint.h:124): a point's
observations are a list of (kf, cam, slot) triples, and each keyframe
keeps the inverse table kf_pt[(kf, cam, slot)] -> point id.

Packed descriptors are uint32 here, as in the JAX package's map, and
int32 bit patterns on the device (``ops/hamming.py``); ``kf_features``
holds the port's ``Features``. The distinctive descriptor
(min-median Hamming) is computed in numpy, bit-exact with the JAX
package's native runtime (``runtime/mapcore.cpp``).
"""

from __future__ import annotations

import dataclasses
from collections import defaultdict
from typing import NamedTuple, Optional

import numpy as np

from ..ops import se3_np
from .extractor import Features

_POPCOUNT8 = np.array([bin(i).count("1") for i in range(256)], np.uint8)


def distinctive_descriptors_batch(descs_u32: np.ndarray,
                                  offsets: np.ndarray) -> np.ndarray:
    """Per segment p = rows [offsets[p], offsets[p+1]) of a packed (O, W)
    uint32 table, the segment-relative index of the row whose median
    Hamming distance to the segment's rows (itself included) is smallest:
    the median is the sorted row's element o // 2 and ties go to the
    first row (cMapPoint::ComputeDistinctiveDescriptors,
    cMapPoint.cpp:294-388, as runtime/mapcore.cpp computes it). -1 for
    empty segments. Segments are batched by size, so the work is a few
    numpy calls."""
    offsets = np.asarray(offsets, np.int64)
    counts = np.diff(offsets)
    out = np.full(len(counts), -1, np.int32)
    out[counts == 1] = 0
    descs = np.ascontiguousarray(descs_u32, np.uint32)
    for o in np.unique(counts[counts > 1]):
        segs = np.nonzero(counts == o)[0]
        rows = offsets[segs][:, None] + np.arange(o)            # (S, o)
        d = descs[rows]                                         # (S, o, W)
        x = (d[:, :, None, :] ^ d[:, None, :, :]).view(np.uint8)
        ham = _POPCOUNT8[x].sum(-1, dtype=np.int32)             # (S, o, o)
        med = np.sort(ham, axis=-1)[..., o // 2]
        out[segs] = np.argmin(med, axis=-1)
    return out


class KFHostView(NamedTuple):
    """Host (numpy) copy of the per-keyframe feature arrays the map
    bookkeeping reads, fetched from the device once per keyframe and
    cached; descriptors as uint32."""

    xy: np.ndarray         # (C, K, 2)
    level: np.ndarray      # (C, K)
    desc: np.ndarray       # (C, K, W) uint32
    desc_mask: np.ndarray  # (C, K, W) uint32
    ray: np.ndarray        # (C, K, 3)


@dataclasses.dataclass
class MapStore:
    """Fixed-capacity SLAM map."""

    capacity_pts: int = 30000
    capacity_kfs: int = 256
    n_cams: int = 3
    k_per_cam: int = 400
    desc_words: int = 8

    def __post_init__(self):
        P, N = self.capacity_pts, self.capacity_kfs
        C, K, W = self.n_cams, self.k_per_cam, self.desc_words
        self.pt_valid = np.zeros(P, bool)
        self.pt_pos = np.zeros((P, 3), np.float32)
        self.pt_desc = np.zeros((P, W), np.uint32)
        self.pt_desc_mask = np.full((P, W), 0xFFFFFFFF, np.uint32)
        self.pt_normal = np.zeros((P, 3), np.float32)
        self.pt_min_dist = np.zeros(P, np.float32)
        self.pt_max_dist = np.zeros(P, np.float32)
        self.pt_visible = np.zeros(P, np.int32)   # mnVisible
        self.pt_found = np.zeros(P, np.int32)     # mnFound
        self.pt_first_kf = np.full(P, -1, np.int32)
        self.pt_obs: dict[int, list[tuple[int, int, int]]] = defaultdict(list)
        # flat APPEND-ONLY observation log for vectorized queries
        # (local-map voting, BA assembly): rows are (pt, kf, cam, slot).
        # A row is LIVE iff the keyframe slot still holds the point
        # (kf_pt[kf, cam, slot] == pt) — erase/replace/cull update kf_pt,
        # so liveness is ONE vectorized gather and the log itself never
        # needs surgery. Host cost of map queries stays flat as the map
        # grows (cTracking::UpdateReference is O(local map), not O(map),
        # cTracking.cpp:1014-1123).
        self._obs_log = np.zeros((8192, 4), np.int32)
        self._obs_n = 0
        self.pt_replaced: dict[int, int] = {}   # old id -> merged-into id
        # replacement forwarding as a flat table (vectorized resolution)
        self.pt_forward = np.arange(P, dtype=np.int32)
        # incremental covisibility (cMultiKeyFrame::UpdateConnections kept
        # live on add/erase instead of re-scanned per query):
        # _covis[kf][other] = #shared map points; _pt_kfs[pt][kf] =
        # observation multiplicity of pt in kf (multi-camera -> can be >1)
        self._covis: dict[int, dict[int, int]] = defaultdict(dict)
        self._pt_kfs: dict[int, dict[int, int]] = {}

        self.kf_valid = np.zeros(N, bool)
        self.kf_pose = np.zeros((N, 6), np.float64)   # M_t cayley (body->world)
        self.kf_features: list[Optional[Features]] = [None] * N
        self.kf_pt = np.full((N, C, K), -1, np.int32)
        self.kf_parent = np.full(N, -1, np.int32)     # spanning tree
        self.kf_loop_edges: dict[int, set[int]] = defaultdict(set)
        self.kf_frame_id = np.full(N, -1, np.int64)   # source frame id
        self._kf_host: dict[int, KFHostView] = {}     # lazy host copies

        self._next_pt = 0
        self._next_kf = 0
        # SetBadFlag fan-out: the reference erases a culled keyframe
        # from the BoW keyframe database (cMultiKeyFrame::SetBadFlag ->
        # mpKeyFrameDB->erase); subscribers (loop closer) hook this
        self.on_kf_removed = None

    # ------------------------------------------------------------------
    # allocation
    # ------------------------------------------------------------------

    def _grow_point_pool(self, need: int):
        """Double the point pool until ``need`` slots fit. Ids are stable
        (arrays only ever grow at the tail) so forwarding, observation
        lists and outstanding references all survive — the reference's
        map is an unbounded pointer set (cMap.h:42-89) and never fails
        an insert; neither does this pool."""
        old, new = self.capacity_pts, self.capacity_pts
        while new < need:
            new *= 2
        grow = lambda a, fill=0: np.concatenate(
            [a, np.full((new - old,) + a.shape[1:], fill, a.dtype)], 0)
        self.pt_valid = grow(self.pt_valid)
        self.pt_pos = grow(self.pt_pos)
        self.pt_desc = grow(self.pt_desc)
        self.pt_desc_mask = grow(self.pt_desc_mask, 0xFFFFFFFF)
        self.pt_normal = grow(self.pt_normal)
        self.pt_min_dist = grow(self.pt_min_dist)
        self.pt_max_dist = grow(self.pt_max_dist)
        self.pt_visible = grow(self.pt_visible)
        self.pt_found = grow(self.pt_found)
        self.pt_first_kf = grow(self.pt_first_kf, -1)
        self.pt_forward = np.concatenate(
            [self.pt_forward, np.arange(old, new, dtype=np.int32)])
        self.capacity_pts = new

    def _grow_kf_pool(self, need: int):
        """Double the keyframe pool (see _grow_point_pool)."""
        old, new = self.capacity_kfs, self.capacity_kfs
        while new < need:
            new *= 2
        grow = lambda a, fill=0: np.concatenate(
            [a, np.full((new - old,) + a.shape[1:], fill, a.dtype)], 0)
        self.kf_valid = grow(self.kf_valid)
        self.kf_pose = grow(self.kf_pose)
        self.kf_features.extend([None] * (new - old))
        self.kf_pt = grow(self.kf_pt, -1)
        self.kf_parent = grow(self.kf_parent, -1)
        self.kf_frame_id = grow(self.kf_frame_id, -1)
        self.capacity_kfs = new

    def alloc_points(self, n: int) -> np.ndarray:
        """Allocate n point slots. BUMP-ONLY: dead ids are never reused,
        so stale references (tracker frames, queued work) can always be
        resolved through ``pt_replaced`` or detected as dead — the
        array-pool analogue of the reference's mpReplaced pointer
        (cMapPoint::Replace). The pool GROWS when exhausted instead of
        failing mid-track (the reference map is unbounded)."""
        if self._next_pt + n > self.capacity_pts:
            self._grow_point_pool(self._next_pt + n)
        ids = np.arange(self._next_pt, self._next_pt + n, dtype=np.int32)
        self._next_pt += n
        self.pt_valid[ids] = True
        return ids

    def resolve_points(self, ids: np.ndarray) -> np.ndarray:
        """Follow replacement forwarding for an int32 array of point ids
        (-1 passes through); dead unreplaced ids stay as-is (callers
        filter by pt_valid). Vectorized: iterate the flat forwarding
        table to a fixpoint (chains are short; merges only ever point at
        older-or-newer live ids, never cycles)."""
        out = np.asarray(ids).copy()
        flat = out.reshape(-1)
        live = flat >= 0
        for _ in range(32):
            nxt = np.where(live, self.pt_forward[np.clip(flat, 0, None)],
                           flat)
            if np.array_equal(nxt, flat):
                break
            flat[...] = nxt
        return out

    def alloc_keyframe(self, pose_min: np.ndarray, feats: Features,
                       frame_id: int) -> int:
        if self._next_kf >= self.capacity_kfs:
            self._grow_kf_pool(self._next_kf + 1)
        kf = self._next_kf
        self._next_kf += 1
        self.kf_valid[kf] = True
        self.kf_pose[kf] = np.asarray(pose_min, np.float64)
        self.kf_features[kf] = feats
        self.kf_frame_id[kf] = frame_id
        return kf

    def kf_host(self, kf: int) -> Optional[KFHostView]:
        """Host copy of keyframe ``kf``'s feature arrays (fetched once,
        then cached)."""
        v = self._kf_host.get(kf)
        if v is None:
            f = self.kf_features[kf]
            if f is None:
                return None
            host = [t.detach().cpu().numpy() for t in
                    (f.xy, f.level, f.desc, f.desc_mask, f.ray)]
            host[2] = host[2].view(np.uint32)
            host[3] = host[3].view(np.uint32)
            v = KFHostView(*host)
            self._kf_host[kf] = v
        return v

    # ------------------------------------------------------------------
    # observations
    # ------------------------------------------------------------------

    def _covis_link(self, pt: int, kf: int):
        """kf gained its FIRST observation of pt (multiplicity 0 -> 1):
        bump the pair count with every other observing keyframe."""
        c = self._pt_kfs.setdefault(pt, {})
        if c.get(kf, 0) == 0:
            for other in c:
                self._covis[kf][other] = self._covis[kf].get(other, 0) + 1
                self._covis[other][kf] = self._covis[other].get(kf, 0) + 1
        c[kf] = c.get(kf, 0) + 1

    def _covis_unlink(self, pt: int, kf: int):
        c = self._pt_kfs.get(pt)
        if not c or kf not in c:
            return
        c[kf] -= 1
        if c[kf] == 0:
            del c[kf]
            for other in c:
                w = self._covis[kf].get(other, 0) - 1
                if w > 0:
                    self._covis[kf][other] = w
                    self._covis[other][kf] = w
                else:
                    self._covis[kf].pop(other, None)
                    self._covis[other].pop(kf, None)
            if not c:
                self._pt_kfs.pop(pt, None)

    def _obs_append(self, pt: int, kf: int, cam: int, slot: int):
        if self._obs_n == len(self._obs_log):
            self._obs_log = np.concatenate(
                [self._obs_log, np.zeros_like(self._obs_log)], 0)
        self._obs_log[self._obs_n] = (pt, kf, cam, slot)
        self._obs_n += 1

    def obs_rows(self) -> np.ndarray:
        """(n, 4) int32 (pt, kf, cam, slot) rows of the observation log
        that are still LIVE (the keyframe slot still holds the point).
        Re-added observations can appear twice; callers that feed an
        optimizer dedupe with np.unique(axis=0)."""
        rows = self._obs_log[:self._obs_n]
        live = self.kf_pt[rows[:, 1], rows[:, 2], rows[:, 3]] == rows[:, 0]
        return rows[live]

    def rebuild_obs_log(self):
        """Regenerate the flat log from pt_obs (checkpoint load)."""
        self._obs_n = 0
        total = sum(len(l) for l in self.pt_obs.values())
        self._obs_log = np.zeros((max(8192, total), 4), np.int32)
        for pt, lst in self.pt_obs.items():
            for kf, cam, slot in lst:
                self._obs_append(pt, kf, cam, slot)

    def add_observation(self, pt: int, kf: int, cam: int, slot: int):
        self.pt_obs[pt].append((kf, cam, slot))
        self.kf_pt[kf, cam, slot] = pt
        self._obs_append(pt, kf, cam, slot)
        self._covis_link(pt, kf)

    def erase_observation(self, pt: int, kf: int, cam: int, slot: int):
        try:
            self.pt_obs[pt].remove((kf, cam, slot))
        except ValueError:
            return
        if self.kf_pt[kf, cam, slot] == pt:
            self.kf_pt[kf, cam, slot] = -1
        self._covis_unlink(pt, kf)
        # a point with < 2 observations is no landmark (cMapPoint SetBadFlag
        # trigger in EraseObservation)
        if len(self.pt_obs[pt]) < 2:
            self.remove_point(pt)

    def remove_point(self, pt: int):
        if not self.pt_valid[pt]:
            return
        for kf, cam, slot in self.pt_obs.pop(pt, []):
            if self.kf_pt[kf, cam, slot] == pt:
                self.kf_pt[kf, cam, slot] = -1
            self._covis_unlink(pt, kf)
        self.pt_valid[pt] = False

    def replace_point(self, old: int, new: int):
        """cMapPoint::Replace (cMapPoint.cpp:231-239) - rebind all
        observations of ``old`` to ``new``; where ``new`` is already
        observed in the same (keyframe, camera), the old match is ERASED
        instead of duplicated (a duplicate would double-count BA
        residuals and inflate covisibility)."""
        if old == new or not self.pt_valid[old]:
            return
        for kf, cam, slot in self.pt_obs.pop(old, []):
            self._covis_unlink(old, kf)
            existing = [o for o in self.pt_obs[new]
                        if o[0] == kf and o[1] == cam]
            if any(s == slot for _, _, s in existing):
                self.kf_pt[kf, cam, slot] = new
            elif existing:
                # new already matched elsewhere in this (kf, cam): drop
                # old's slot rather than double-observe
                if self.kf_pt[kf, cam, slot] == old:
                    self.kf_pt[kf, cam, slot] = -1
            else:
                self.pt_obs[new].append((kf, cam, slot))
                self.kf_pt[kf, cam, slot] = new
                self._obs_append(new, kf, cam, slot)
                self._covis_link(new, kf)
        self.pt_found[new] += self.pt_found[old]
        self.pt_visible[new] += self.pt_visible[old]
        self.pt_valid[old] = False
        self.pt_replaced[old] = new
        self.pt_forward[old] = new

    def remove_keyframe(self, kf: int):
        """cMultiKeyFrame::SetBadFlag (simplified: observations detached,
        children re-parented to this KF's parent)."""
        if not self.kf_valid[kf]:
            return
        C, K = self.kf_pt.shape[1:]
        for cam in range(C):
            for slot in np.nonzero(self.kf_pt[kf, cam] >= 0)[0]:
                pt = int(self.kf_pt[kf, cam, slot])
                self.erase_observation(pt, kf, cam, int(slot))
        parent = self.kf_parent[kf]
        self.kf_parent[self.kf_parent == kf] = parent
        self.kf_valid[kf] = False
        self.kf_features[kf] = None
        self._kf_host.pop(kf, None)
        if self.on_kf_removed is not None:
            self.on_kf_removed(kf)

    # ------------------------------------------------------------------
    # covisibility (cMultiKeyFrame::UpdateConnections semantics)
    # ------------------------------------------------------------------

    def covisibility_weights(self, kf: int) -> dict[int, int]:
        """#shared map points between ``kf`` and every other keyframe.

        Served from the INCREMENTAL pair-count table maintained by
        add/erase/replace (cMultiKeyFrame::UpdateConnections semantics,
        cMultiKeyFrame.cpp:406-500, kept live like the reference instead
        of re-scanning the observation table per query) — O(neighbors)
        per call regardless of map size."""
        return {k: w for k, w in self._covis.get(kf, {}).items()
                if self.kf_valid[k]}

    def recompute_covisibility(self):
        """Full rebuild of the incremental covisibility state from
        pt_obs (checkpoint load; invariant tests compare this against
        the live-maintained counts)."""
        self._covis = defaultdict(dict)
        self._pt_kfs = {}
        for pt, lst in self.pt_obs.items():
            for kf, _, _ in lst:
                self._covis_link(pt, kf)

    def connected_keyframes(self, kf: int) -> list[int]:
        """The CONNECTION-GRAPH neighbours of ``kf`` (the loop-candidate
        exclusion set and the loop consistency groups,
        GetConnectedKeyFrames, cMultiKeyFrame.cpp:215-222).

        The reference's mConnectedKeyFrameWeights is a SNAPSHOT: it is
        assigned the full >=1-shared-point counter only when ``kf``
        itself runs UpdateConnections (cMultiKeyFrame.cpp:488), and
        afterwards grows only through AddConnection calls gated at
        weight >= th=30 (or the caller's single strongest neighbour,
        cMultiKeyFrame.cpp:458-473). Our MapStore computes the set LIVE
        from the covisibility counters, so a literal >=1 filter would
        also sweep in links created after ``kf``'s processing — and a
        handful of weak cross-era matches (weight 1..29, picked up when
        the rig physically revisits a drifted place) would silently
        exclude the true revisit keyframes from loop candidacy
        (measured on the organic-loop episode: the >=1-landmark
        exclusion wholesale-removed era A from the database query and
        no loop could ever fire). We therefore apply the reference's
        post-snapshot growth gate uniformly: weight >= 30, falling back
        to the single strongest neighbour (the ordered-connections rule,
        cMultiKeyFrame.cpp:452-473)."""
        w = {k: v for k, v in self.covisibility_weights(kf).items()
             if self.kf_valid[k]}
        if not w:
            return []
        out = [k for k, v in w.items() if v >= 30]
        if not out:
            out = [max(w.items(), key=lambda kv: kv[1])[0]]
        return out

    def covisible_keyframes(self, kf: int, min_weight: int = 30,
                            best_n: int | None = None) -> list[int]:
        """Covisible KFs sorted by weight (UpdateConnections threshold
        th=30, cMultiKeyFrame.cpp:450; GetBestCovisibilityKeyFrames with
        best_n)."""
        w = self.covisibility_weights(kf)
        ordered = sorted(w.items(), key=lambda kv: -kv[1])
        out = [k for k, v in ordered if v >= min_weight]
        if not out and ordered:
            out = [ordered[0][0]]  # keep the single best (reference rule)
        return out[:best_n] if best_n else out

    def update_spanning_tree(self, kf: int):
        """Parent = strongest covisible older KF (UpdateConnections tail)."""
        w = self.covisibility_weights(kf)
        older = {k: v for k, v in w.items() if k < kf}
        if older:
            self.kf_parent[kf] = max(older.items(), key=lambda kv: kv[1])[0]

    # ------------------------------------------------------------------
    # point statistics (cMapPoint::UpdateNormalAndDepth,
    # ComputeDistinctiveDescriptors)
    # ------------------------------------------------------------------

    def update_point_stats(self, pts: np.ndarray, M_c: np.ndarray,
                           scale_factor: float = 1.2, n_levels: int = 8):
        """Recompute mean viewing ray + scale-invariance distances for the
        given points (min*0.8 / max*1.2 rule, cMapPoint.cpp:449-504) and
        the distinctive descriptor (min-median Hamming,
        cMapPoint.cpp:294-388).

        Fully batched: keyframe poses are gathered ONCE, camera centers /
        normals / depth ranges are numpy over a packed (point, obs)
        table, and the distinctive descriptors are one batched call over
        the packed table. ``M_c``: (C, 4, 4) rig extrinsics (numpy)."""
        pts = np.atleast_1d(np.asarray(pts, np.int64))
        sel: list[int] = []
        row_pt: list[int] = []
        row_kf: list[int] = []
        row_cam: list[int] = []
        row_slot: list[int] = []
        for p in pts:
            p = int(p)
            obs = self.pt_obs.get(p)
            if not obs or not self.pt_valid[p]:
                continue
            i = len(sel)
            sel.append(p)
            for kf, cam, slot in obs:
                row_pt.append(i)
                row_kf.append(kf)
                row_cam.append(cam)
                row_slot.append(slot)
        if not sel:
            return
        sel_a = np.asarray(sel, np.int64)
        row_pt_a = np.asarray(row_pt, np.int64)
        row_kf_a = np.asarray(row_kf, np.int64)
        row_cam_a = np.asarray(row_cam, np.int64)
        row_slot_a = np.asarray(row_slot, np.int64)
        M_c = np.asarray(M_c, np.float64)

        # camera centers per observation: (M_t[kf] @ M_c[cam])[:3, 3]
        ukf, inv = np.unique(row_kf_a, return_inverse=True)
        M_kf = se3_np.cayley2hom(self.kf_pose[ukf])       # (U, 4, 4)
        centers = (np.einsum("oij,oj->oi", M_kf[inv, :3, :3],
                             M_c[row_cam_a, :3, 3])
                   + M_kf[inv, :3, 3])
        d = self.pt_pos[sel_a][row_pt_a].astype(np.float64) - centers
        dist = np.linalg.norm(d, axis=1)
        good = dist > 1e-9
        dn = np.where(good[:, None], d / np.maximum(dist, 1e-9)[:, None], 0.0)
        acc = np.zeros((len(sel_a), 3))
        np.add.at(acc, row_pt_a, dn)
        any_good = np.zeros(len(sel_a), bool)
        any_good[row_pt_a[good]] = True
        nm = np.linalg.norm(acc, axis=1)
        normals = np.where(nm[:, None] > 1e-9,
                           acc / np.maximum(nm, 1e-9)[:, None], acc)
        self.pt_normal[sel_a[any_good]] = \
            normals[any_good].astype(np.float32)

        # per-observation level / descriptor / mask from the host caches
        # (grouped by keyframe: one fancy-index gather per KF)
        O = len(row_pt_a)
        lvl_row = np.zeros(O, np.int32)
        desc_row = np.zeros((O, self.desc_words), np.uint32)
        mask_row = np.full((O, self.desc_words), 0xFFFFFFFF, np.uint32)
        row_ok = np.zeros(O, bool)
        for u, kf in enumerate(ukf):
            host = self.kf_host(int(kf))
            if host is None:
                continue
            r = np.nonzero(inv == u)[0]
            lvl_row[r] = host.level[row_cam_a[r], row_slot_a[r]]
            desc_row[r] = host.desc[row_cam_a[r], row_slot_a[r]]
            mask_row[r] = host.desc_mask[row_cam_a[r], row_slot_a[r]]
            row_ok[r] = True

        # scale-invariance range from the FIRST observation with features
        # (reference iterates observations in insertion order,
        # cMapPoint.cpp:449-504)
        order = np.lexsort((np.arange(O), np.where(row_ok, 0, 1), row_pt_a))
        first_of = np.zeros(len(sel_a), np.int64)
        seen = np.zeros(len(sel_a), bool)
        srt_pt = row_pt_a[order]
        first_idx = np.unique(srt_pt, return_index=True)[1]
        first_of[srt_pt[first_idx]] = order[first_idx]
        seen[srt_pt[first_idx]] = True
        ref_ok = seen & row_ok[first_of]
        ref_rows = first_of[ref_ok]
        max_d = dist[ref_rows] * scale_factor ** lvl_row[ref_rows].astype(
            np.float64)
        min_d = max_d / (scale_factor ** (n_levels - 1))
        self.pt_min_dist[sel_a[ref_ok]] = (min_d * 0.8).astype(np.float32)
        self.pt_max_dist[sel_a[ref_ok]] = (max_d * 1.2).astype(np.float32)

        # distinctive descriptor: pack feature-backed rows per point and
        # pick min-median-Hamming in one batched call (cMapPoint.cpp:294-388)
        keep = np.nonzero(row_ok)[0]
        if len(keep) == 0:
            return
        kp_pt = row_pt_a[keep]
        cnt = np.bincount(kp_pt, minlength=len(sel_a))
        offsets = np.zeros(len(sel_a) + 1, np.int32)
        np.cumsum(cnt, out=offsets[1:])
        ordk = keep[np.argsort(kp_pt, kind="stable")]
        best_rel = distinctive_descriptors_batch(
            desc_row[ordk], offsets)
        has = best_rel >= 0
        best_rows = ordk[np.clip(offsets[:-1] + best_rel, 0, None)]
        w = sel_a[has]
        self.pt_desc[w] = desc_row[best_rows[has]]
        self.pt_desc_mask[w] = mask_row[best_rows[has]]

    # ------------------------------------------------------------------
    # snapshots for device work
    # ------------------------------------------------------------------

    def n_points(self) -> int:
        return int(self.pt_valid.sum())

    def n_keyframes(self) -> int:
        return int(self.kf_valid.sum())

    def point_ids(self) -> np.ndarray:
        return np.nonzero(self.pt_valid)[0].astype(np.int32)

    def keyframe_ids(self) -> np.ndarray:
        return np.nonzero(self.kf_valid)[0].astype(np.int32)

    def clear(self):
        self.__post_init__()
