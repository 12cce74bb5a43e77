"""Keyframe database: sparse BoW rows + batched candidate retrieval.

JAX rebuild of the reference's KeyFrameDatabase (reference:
src/KeyFrameDatabase.cc): the word->keyframe inverted file becomes sparse
(word-id, tf-idf weight) rows [K_max, T] — memory independent of the
vocabulary size, so the tree can scale toward the reference's 10^6 leaves
(TemplatedVocabulary.h:109). Loop/relocalization candidate retrieval is
one batched histogram-intersection score (== the DBoW2 L1 score for
L1-normalized vectors) against every keyframe at once, followed by the
reference's gating: exclude covisible keyframes, require score >= minScore,
accumulate scores over each candidate's top-10 covisibility group and keep
those above 0.75 x best accumulated score
(reference: DetectLoopCandidates :76-197, DetectRelocalizationCandidates
:199-309 — word-sharing prefilters were inverted-file bookkeeping; batched
scoring subsumes them).

All device work is jit-compiled once per vocabulary: BoW transform +
database update is ONE device call per keyframe, candidate scoring ONE
call per query (the covisibility matrix arrives batched from
mapstate.covisibility_matrix).
"""
from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from ..mapstate.map import MapState, covisibility_matrix
from . import vocabulary as V


class KeyFrameDatabase:
    """Host-managed SPARSE BoW database aligned with MapState keyframe
    slots: (word-id [K, T], weight [K, T]) pairs — memory independent of
    vocabulary size (the dense [K, n_words] rows of earlier rounds capped
    the tree at ~10^4 words; the reference vocabulary is 10^6 leaves)."""

    def __init__(self, voc: V.Vocabulary, k_max: int, bow_cap: int = 1024):
        self.voc = voc
        self.bow_idx = jnp.full((k_max, bow_cap), -1, jnp.int32)
        self.bow_w = jnp.zeros((k_max, bow_cap), jnp.float32)
        n_words = int(voc.n_words)
        # jit once per vocabulary: the tree arrays are closure constants
        self._frame_vec = jax.jit(
            lambda desc, valid: V.bow_sparse(
                voc, V.transform(voc, desc, valid), valid, bow_cap))
        def _add(bi, bw, kf, desc, valid):
            idx, w = V.bow_sparse(
                voc, V.transform(voc, desc, valid), valid, bow_cap)
            return bi.at[kf].set(idx), bw.at[kf].set(w)
        self._add = jax.jit(_add, donate_argnums=(0, 1))
        self._scores = jax.jit(
            lambda bi, bw, qi, qw, kf_valid: jnp.where(
                kf_valid,
                V.score_l1_sparse(qi, qw, bi, bw, n_words), -1.0))

    def add(self, kf: int, desc: jax.Array, valid: jax.Array):
        self.bow_idx, self.bow_w = self._add(
            self.bow_idx, self.bow_w, kf, desc, valid)

    def permute(self, live_slots: np.ndarray, n_live: int):
        """Mirror a keyframe compaction (mapstate.compact_keyframes): live
        rows move to the front in order, evicted rows are cleared (the
        reference erases culled keyframes from the inverted file,
        KeyFrameDatabase::erase)."""
        k_max = self.bow_idx.shape[0]
        order = np.zeros(k_max, np.int32)
        order[:n_live] = live_slots[:n_live]
        mask = jnp.arange(k_max) < n_live
        self.bow_idx = jnp.where(mask[:, None],
                                 self.bow_idx[jnp.asarray(order)], -1)
        self.bow_w = jnp.where(mask[:, None],
                               self.bow_w[jnp.asarray(order)], 0.0)

    def grow(self, k_max: int):
        """Re-pad the row dimension after map capacity growth."""
        k0 = self.bow_idx.shape[0]
        if k_max > k0:
            self.bow_idx = jnp.pad(self.bow_idx, ((0, k_max - k0), (0, 0)),
                                   constant_values=-1)
            self.bow_w = jnp.pad(self.bow_w, ((0, k_max - k0), (0, 0)))

    def frame_vector(self, desc: jax.Array, valid: jax.Array):
        return self._frame_vec(desc, valid)

    def scores(self, vec, kf_valid: jax.Array) -> jax.Array:
        """vec: sparse (idx, w) pair from frame_vector / a stored row."""
        qi, qw = vec
        return self._scores(self.bow_idx, self.bow_w, qi, qw, kf_valid)

    def detect_loop_candidates(self, m: MapState, kf: int, min_score: float,
                               max_candidates: int = 5,
                               covis: np.ndarray | None = None,
                               scores: np.ndarray | None = None) -> list[int]:
        """Reference gating (KeyFrameDatabase.cc:76-197) over dense scores.

        covis/scores: optional precomputed covisibility matrix / score
        vector (numpy) to avoid extra device round trips."""
        if covis is None:
            covis = np.asarray(covisibility_matrix(m))
        s = (np.array(scores) if scores is not None
             else np.array(self.scores(
                 (self.bow_idx[kf], self.bow_w[kf]), m.kf_valid)))
        s[kf] = -1
        s[covis[kf] > 0] = -1
        s[~np.asarray(m.kf_valid)] = -1
        cand = np.where(s >= min_score)[0]
        if len(cand) == 0:
            return []
        # accumulate over each candidate's top-10 covisibility group
        acc = {}
        for c in cand:
            wc = covis[int(c)]
            group = np.argsort(-wc)[:10]
            group = [int(g) for g in group if wc[g] > 0] + [int(c)]
            group_scores = [s[g] for g in group if s[g] > 0]
            acc[int(c)] = float(sum(group_scores)) if group_scores else float(s[c])
        best_acc = max(acc.values())
        keep = [c for c, a in acc.items() if a > 0.75 * best_acc]
        keep.sort(key=lambda c: -s[c])
        return keep[:max_candidates]

    def detect_reloc_candidates(self, m: MapState, desc: jax.Array,
                                valid: jax.Array,
                                max_candidates: int = 5) -> list[int]:
        """Relocalization candidates for a frame with the reference's
        gating (reference: DetectRelocalizationCandidates :199-309):
        accumulate each candidate's score over its top-10 covisibility
        group, keep groups above 0.75 x best accumulated score, and return
        each surviving group's best member, ordered by accumulated score.
        (The inverted file's shared-word prefilters are subsumed by the
        dense scoring: a zero-word-overlap keyframe scores 0.)"""
        vec = self.frame_vector(desc, valid)
        s = np.asarray(self.scores(vec, m.kf_valid))
        s = np.where(np.asarray(m.kf_valid), s, -1.0)
        cand = np.where(s > 0)[0]
        if len(cand) == 0:
            return []
        # No raw-score prefilter before group accumulation: the reference's
        # 0.8 gate is on shared-WORD counts (inverted-file bookkeeping) and
        # its 0.75 cut applies to ACCUMULATED group scores
        # (KeyFrameDatabase.cc:231,268-299) — a candidate with a weak
        # individual score but a strong covisibility group must survive to
        # the accumulation stage. A word-count proxy: drop only candidates
        # whose score is negligible relative to the best (guards the O(K)
        # host loop, not recall).
        cand = cand[s[cand] >= 0.05 * s[cand].max()]
        covis = np.asarray(covisibility_matrix(m))
        acc: dict[int, float] = {}
        best_of_group: dict[int, int] = {}
        for c in cand:
            wc = covis[int(c)]
            group = np.argsort(-wc)[:10]
            group = [int(g) for g in group if wc[g] > 0] + [int(c)]
            g_scores = [(s[g], g) for g in group if s[g] > 0]
            acc[int(c)] = (float(sum(v for v, _ in g_scores))
                           if g_scores else float(s[c]))
            best_of_group[int(c)] = (max(g_scores)[1] if g_scores
                                     else int(c))
        best_acc = max(acc.values())
        keep = [(a, best_of_group[c]) for c, a in acc.items()
                if a >= 0.75 * best_acc]
        keep.sort(key=lambda x: -x[0])
        out: list[int] = []
        for _, g in keep:
            if g not in out:
                out.append(g)
        return out[:max_candidates]
