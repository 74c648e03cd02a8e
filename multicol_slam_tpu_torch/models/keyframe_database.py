"""Keyframe database: the BoW inverted file and the loop and
relocalization candidate queries (cMultiKeyFrameDatabase.{h,cpp}).

Port of ``multicol_slam_tpu/models/keyframe_database.py``, host Python as
there. Reference semantics: an inverted file by word id (:36-50);
DetectLoopCandidates (:82-211) counts shared words with every keyframe
sharing one (the query's connected set excluded), keeps those above 0.8
of the most, scores them by BoW similarity >= minScore, accumulates the
scores over covisibility groups and keeps groups above 0.75 of the best;
DetectRelocalisationCandidates (:213-330) is the same without the
exclusion and the minimum score.
"""

from __future__ import annotations

from collections import defaultdict

from .map import MapStore
from .vocabulary import bow_score_l1


class KeyFrameDatabase:
    def __init__(self):
        self.inverted: dict[int, list[int]] = defaultdict(list)
        self.kf_bow: dict[int, dict[int, float]] = {}

    def add(self, kf: int, bow: dict[int, float]):
        self.kf_bow[kf] = bow
        for w in bow:
            self.inverted[w].append(kf)

    def erase(self, kf: int):
        bow = self.kf_bow.pop(kf, {})
        for w in bow:
            try:
                self.inverted[w].remove(kf)
            except ValueError:
                pass

    def clear(self):
        """cMultiKeyFrameDatabase::clear (the system's reset)."""
        self.inverted.clear()
        self.kf_bow.clear()

    def _shared_word_counts(self, bow: dict[int, float],
                            exclude: set[int]) -> dict[int, int]:
        counts: dict[int, int] = defaultdict(int)
        for w in bow:
            for kf in self.inverted.get(w, ()):
                if kf not in exclude:
                    counts[kf] += 1
        return counts

    def _group_best(self, scored: list[tuple[int, float]],
                    map_store: MapStore) -> list[int]:
        """Accumulate the scores over each candidate's group (itself and
        its 10 best covisible keyframes); each group above 0.75 of the best
        accumulation names its best-scoring keyframe, once."""
        smap = dict(scored)
        best_acc = 0.0
        groups = []
        for cand, s in scored:
            acc, best_kf, best_s = 0.0, cand, s
            for g in [cand] + map_store.covisible_keyframes(cand, best_n=10):
                gs = smap.get(g)
                if gs is not None:
                    acc += gs
                    if gs > best_s:
                        best_kf, best_s = g, gs
            groups.append((acc, best_kf))
            best_acc = max(best_acc, acc)
        th = 0.75 * best_acc
        out, seen = [], set()
        for acc, best_kf in groups:
            if acc > th and best_kf not in seen:
                seen.add(best_kf)
                out.append(best_kf)
        return out

    def detect_loop_candidates(self, kf: int, bow: dict[int, float],
                               min_score: float, map_store: MapStore,
                               connected: set[int]) -> list[int]:
        """cMultiKeyFrameDatabase::DetectLoopCandidates (:82-211)."""
        counts = self._shared_word_counts(bow, set(connected) | {kf})
        if not counts:
            return []
        min_common = 0.8 * max(counts.values())
        scored = []
        for cand, c in counts.items():
            if c <= min_common:
                continue
            s = bow_score_l1(bow, self.kf_bow.get(cand, {}))
            if s >= min_score:
                scored.append((cand, s))
        if not scored:
            return []
        return self._group_best(scored, map_store)

    def detect_reloc_candidates(self, bow: dict[int, float],
                                map_store: MapStore) -> list[int]:
        """DetectRelocalisationCandidates (:213-330)."""
        counts = self._shared_word_counts(bow, set())
        if not counts:
            return []
        min_common = 0.8 * max(counts.values())
        scored = [(cand, bow_score_l1(bow, self.kf_bow.get(cand, {})))
                  for cand, c in counts.items() if c > min_common]
        if not scored:
            return []
        return self._group_best(scored, map_store)
