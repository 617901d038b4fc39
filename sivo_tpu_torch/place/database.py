"""Keyframe database: BoW inverted file + candidate retrieval.

Replaces the reference's KeyFrameDatabase
(ref: src/orbslam/KeyFrameDatabase.cc): a word -> keyframe inverted
file with the exact loop/relocalization candidate policies —
shared-word counting, the 0.8*maxCommonWords cutoff, the minScore gate,
covisibility-accumulated group scores, and the 0.75*bestAccScore
retention. This bookkeeping is light (sparse integer sets at keyframe
rate), so it stays host-side; the heavy part — quantizing 2048
descriptors through the vocabulary tree — runs on device
(place/vocabulary.transform).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from sivo_tpu_torch.place import vocabulary as voc_mod


@dataclass
class KeyFrameDatabase:
    """ref: KeyFrameDatabase.cc:31 (inverted file sized to the vocab)."""

    n_words: int
    inverted: dict[int, list[int]] = field(default_factory=dict)
    bow: dict[int, dict[int, float]] = field(default_factory=dict)
    # sorted-array mirror of ``bow`` for vectorized L1 scoring
    # (rebuilt lazily after compaction rewrites ``bow`` directly)
    bow_arr: dict[int, tuple] = field(default_factory=dict)

    def add(self, kf_idx: int, bow_vec: dict[int, float]) -> None:
        """ref: KeyFrameDatabase.cc:35-47."""
        self.bow[kf_idx] = bow_vec
        self.bow_arr[kf_idx] = voc_mod.bow_arrays(bow_vec)
        for wid in bow_vec:
            self.inverted.setdefault(wid, []).append(kf_idx)

    def erase(self, kf_idx: int) -> None:
        """ref: KeyFrameDatabase.cc:49-65."""
        vec = self.bow.pop(kf_idx, None)
        self.bow_arr.pop(kf_idx, None)
        if vec is None:
            return
        for wid in vec:
            lst = self.inverted.get(wid)
            if lst and kf_idx in lst:
                lst.remove(kf_idx)

    def score(self, query_arr: tuple, kf_idx: int) -> float:
        """Vectorized L1 score of a query (bow_arrays form) against a
        stored keyframe."""
        arr = self.bow_arr.get(kf_idx)
        if arr is None:  # bow rewritten externally (compaction)
            arr = self.bow_arr[kf_idx] = voc_mod.bow_arrays(
                self.bow[kf_idx]
            )
        return voc_mod.l1_score_arrays(query_arr, arr)

    def _shared_word_counts(
        self, bow_vec: dict[int, float], exclude: set[int]
    ) -> dict[int, int]:
        counts: dict[int, int] = {}
        for wid in bow_vec:
            for kf in self.inverted.get(wid, ()):  # inverted-file walk
                if kf not in exclude:
                    counts[kf] = counts.get(kf, 0) + 1
        return counts

    def detect_loop_candidates(
        self,
        kf_idx: int,
        bow_vec: dict[int, float],
        min_score: float,
        connected: set[int],
        covisible_groups: dict[int, list[int]],
        score_fn=None,
        scores_out: dict | None = None,
    ) -> list[int]:
        """ref: KeyFrameDatabase.cc:72-202 DetectLoopCandidates.

        Args:
          connected: covisible KFs of the query (excluded).
          covisible_groups: kf -> its top covisible neighbors (for
            accumulated group scores).
          score_fn: optional (bow_a, bow_b) -> similarity over dict
            vectors; default is the built-in vectorized L1 (identical
            result, ~100x faster at session scale).
          scores_out: optional dict filled with {kf: l1_score} for
            every shared-word-gated candidate (the caller's Sim3
            pre-gate reads it — saves re-scoring).
        """
        exclude = set(connected) | {kf_idx}
        counts = self._shared_word_counts(bow_vec, exclude)
        if not counts:
            return []
        max_common = max(counts.values())
        min_common = 0.8 * max_common  # ref: :120-129
        query_arr = voc_mod.bow_arrays(bow_vec)
        # score candidates above the shared-word and minScore gates
        scored = []
        for kf, c in counts.items():
            if c <= min_common:
                continue
            s = (
                score_fn(bow_vec, self.bow[kf])
                if score_fn is not None
                else self.score(query_arr, kf)
            )
            if scores_out is not None:
                scores_out[kf] = s
            if s >= min_score:  # ref: :147
                scored.append((kf, s))
        if not scored:
            return []
        # accumulate scores over covisibility groups (ref: :153-183)
        best_acc = 0.0
        groups = []
        for kf, s in scored:
            acc = s
            best_kf, best_s = kf, s
            for nb in covisible_groups.get(kf, [])[:10]:
                for kf2, s2 in scored:
                    if kf2 == nb:
                        acc += s2
                        if s2 > best_s:
                            best_kf, best_s = kf2, s2
            groups.append((acc, best_kf))
            best_acc = max(best_acc, acc)
        # retain groups above 0.75 * best (ref: :185-201)
        th = 0.75 * best_acc
        out = []
        seen = set()
        for acc, kf in groups:
            if acc > th and kf not in seen:
                seen.add(kf)
                out.append(kf)
        return out

    def detect_relocalization_candidates(
        self,
        bow_vec: dict[int, float],
        covisible_groups: dict[int, list[int]],
        score_fn=None,
    ) -> list[int]:
        """ref: KeyFrameDatabase.cc:204-324 — like loop candidates but
        no minScore / no connected exclusion."""
        counts = self._shared_word_counts(bow_vec, set())
        if not counts:
            return []
        max_common = max(counts.values())
        min_common = 0.8 * max_common
        query_arr = voc_mod.bow_arrays(bow_vec)
        scored = [
            (
                kf,
                score_fn(bow_vec, self.bow[kf])
                if score_fn is not None
                else self.score(query_arr, kf),
            )
            for kf, c in counts.items()
            if c > min_common
        ]
        if not scored:
            return []
        best_acc = 0.0
        groups = []
        for kf, s in scored:
            acc = s
            best_kf, best_s = kf, s
            for nb in covisible_groups.get(kf, [])[:10]:
                for kf2, s2 in scored:
                    if kf2 == nb:
                        acc += s2
                        if s2 > best_s:
                            best_kf, best_s = kf2, s2
            groups.append((acc, best_kf))
            best_acc = max(best_acc, acc)
        th = 0.75 * best_acc
        out = []
        seen = set()
        for acc, kf in groups:
            if acc > th and kf not in seen:
                seen.add(kf)
                out.append(kf)
        return out
