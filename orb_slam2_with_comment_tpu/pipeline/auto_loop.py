"""On-device loop closing for the autonomous tracker.

The host-driven LoopCloser (pipeline.loop_closing) re-expresses the
reference's LoopClosing thread as a host sequencer: detection scores are
read back, consistency groups are Python sets, Sim3 gates are host ints,
and the essential-graph edge list is built with numpy. Those readbacks are
exactly what the autonomous tracker must not do (pipeline/auto.py
docstring), so this module re-expresses the ENTIRE loop-closing pass —
BoW detection, covisibility-consistency confirmation, Sim3 RANSAC +
refinement, Sim3 propagation, essential-graph optimization and bounded
global BA — as pure array transforms with static shapes, runnable inside
the keyframe branch of the autonomous per-frame step.

Reference semantics preserved (SURVEY §2.6 "Loop closing"):
- >=10 keyframes since the last loop (LoopClosing.cc:116);
- candidate score >= min covisible-BoW score of the current keyframe
  (LoopClosing.cc:126-140);
- group-score accumulation over each candidate's top-10 covisibility
  group, keep > 0.75 * best (KeyFrameDatabase.cc:151-176);
- covisibility-consistency across 3 consecutive keyframes
  (LoopClosing.cc:43,164-244) — previous candidate groups become a fixed
  [C_MAX, K] boolean matrix + chain counters in the device carry;
- Sim3: >=20 BoW matches per candidate, RANSAC (P=0.99 via 300 batched
  hypotheses, 3-pt Horn, two-sided chi2) >=20 inliers, refine >=20
  (LoopClosing.cc:333,342,408);
- correction (CorrectLoop :509-719): Sim3 propagation over the current
  covisibility group, landmark correction, essential-graph optimization
  (loop keyframe fixed, Optimizer.cc:891), bounded-iteration global BA
  (the reference's asynchronous GBA thread, SURVEY §2.5 P3/P6).

The vocabulary is the packaged offline-trained tree
(place.vocabulary.load_default_vocabulary — our ORBvoc.txt counterpart),
kept as HOST numpy arrays so traced code embeds it as constants.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp

from ..geometry import se3, sim3
from ..mapstate.map import (MapState, covisibility_matrix,
                            covisibility_weights, rebuild_observations)
from ..matching import search as msearch
from ..ops import prims
from ..optim import ba, pose_graph, sim3_opt
from ..place import vocabulary as V
from ..solvers import sim3solver

C_MAX = 4  # candidate groups tracked for consistency
CONSISTENCY_TH = 3  # reference mnCovisibilityConsistencyTh
MIN_GAP = 10  # keyframes between loops (reference LoopClosing.cc:116)

# OSLAM_LOOP_DEBUG=1 prints every detection/Sim3 gate decision via
# jax.debug.print (diagnosis aid; zero cost when unset — the prints are
# simply not traced in)
import os as _os
_LOOP_DEBUG = bool(int(_os.environ.get("OSLAM_LOOP_DEBUG", "0")))


class LoopCarry(NamedTuple):
    """Device-resident loop-closing state (part of AutoState)."""
    # sparse per-keyframe tf-idf rows: (word id [K, T] int32 -1-padded,
    # weight [K, T] f32) — O(K*T) memory independent of vocabulary size
    # (dense [K, n_words] rows capped the tree at ~10^4 words; the
    # reference vocabulary is 10^6, TemplatedVocabulary.h:109)
    bow_idx: jax.Array
    bow_w: jax.Array
    prev_groups: jax.Array  # [C_MAX, K] bool: last KF's candidate groups
    prev_counts: jax.Array  # [C_MAX] int32 consistency chain lengths
    last_loop_kf: jax.Array  # [] int32 keyframe slot of last closed loop
    n_loops: jax.Array  # [] int32
    key: jax.Array  # PRNG key for Sim3 RANSAC
    # accepted loop edges (upper-triangular bool): the reference's
    # essential graph includes ALL past loop edges (Optimizer.cc:908-919)
    loop_edges: jax.Array  # [K, K] bool


def empty_loop_carry(k_max: int, bow_cap: int) -> LoopCarry:
    """bow_cap: sparse-row capacity — lossless at >= n_feat (a keyframe
    touches at most n_feat distinct words)."""
    return LoopCarry(
        bow_idx=jnp.full((k_max, bow_cap), -1, jnp.int32),
        bow_w=jnp.zeros((k_max, bow_cap), jnp.float32),
        prev_groups=jnp.zeros((C_MAX, k_max), bool),
        prev_counts=jnp.zeros(C_MAX, jnp.int32),
        last_loop_kf=jnp.int32(-MIN_GAP),
        n_loops=jnp.int32(0),
        key=jax.random.PRNGKey(7),
        loop_edges=jnp.zeros((k_max, k_max), bool),
    )


def permute_loop_carry(loop: LoopCarry, order, rank, valid) -> LoopCarry:
    """Mirror a keyframe compaction (mapstate.compact_keyframes) in the
    device-resident loop state: permute BoW rows, consistency groups and
    the loop-edge matrix by the same stable live-first permutation.

    ``order``: new->old slot permutation; ``rank``: old->new (count of
    live slots strictly before); ``valid``: pre-compaction liveness."""
    K = loop.bow_idx.shape[0]
    live_new = valid[order]  # whether the new slot holds a live keyframe
    bow_idx = jnp.where(live_new[:, None], loop.bow_idx[order], -1)
    bow_w = jnp.where(live_new[:, None], loop.bow_w[order], 0.0)
    groups = loop.prev_groups[:, order] & live_new[None, :]
    edges = loop.loop_edges[order][:, order]
    edges = edges & live_new[:, None] & live_new[None, :]
    last = loop.last_loop_kf
    was_live = (last >= 0) & (last < K) & valid[jnp.clip(last, 0, K - 1)]
    # a culled last-loop keyframe must NOT keep its stale slot index (it
    # would alias an unrelated keyframe post-compaction and skew the
    # min-gap detection gate) — drop to the "no loop yet" sentinel
    last = jnp.where(was_live, rank[jnp.clip(last, 0, K - 1)],
                     jnp.where(last >= 0, jnp.int32(-MIN_GAP), last))
    return loop._replace(bow_idx=bow_idx, bow_w=bow_w, prev_groups=groups,
                         loop_edges=edges, last_loop_kf=last)


def add_keyframe_bow(loop: LoopCarry, voc, kf, desc, valid) -> LoopCarry:
    """Compute and store the new keyframe's sparse BoW row (reference:
    KeyFrame::ComputeBoW + KeyFrameDatabase::add)."""
    words = V.transform(voc, desc, valid)
    idx, w = V.bow_sparse(voc, words, valid, loop.bow_idx.shape[1])
    return loop._replace(bow_idx=loop.bow_idx.at[kf].set(idx),
                         bow_w=loop.bow_w.at[kf].set(w))


def detect(loop: LoopCarry, m: MapState, kf,
           n_words: int) -> tuple[jax.Array, LoopCarry]:
    """DetectLoop on device. Returns (candidate slot or -1, new carry)."""
    K = loop.bow_idx.shape[0]
    ids = jnp.arange(K, dtype=jnp.int32)
    W_cov = covisibility_matrix(m)  # [K, K]
    covis_row = W_cov[kf] > 0
    s = V.score_l1_sparse(loop.bow_idx[kf], loop.bow_w[kf],
                          loop.bow_idx, loop.bow_w, n_words)  # [K]
    live = m.kf_valid & (ids != kf) & (ids < m.n_kf)
    # min score over the current keyframe's covisible keyframes
    # (reference LoopClosing.cc:126-140); 0.5 guard when none.
    covis_scores = jnp.where(covis_row & live, s, jnp.inf)
    has_covis = jnp.any(covis_row & live)
    min_score = jnp.where(has_covis, jnp.min(covis_scores), 0.5)
    min_score = jnp.maximum(min_score, 0.0)
    gated = live & ~covis_row & (s >= min_score)
    s_gated = jnp.where(gated, s, -1.0)
    # group-score accumulation over top-10 covisibility neighbors
    # (KeyFrameDatabase.cc:151-176)
    top_w, top_i = prims.sort_top_k(W_cov, 10)  # [K, 10] per candidate
    grp_scores = jnp.where((top_w > 0) & (s_gated[top_i] > 0),
                           s_gated[top_i], 0.0)
    acc = jnp.sum(grp_scores, axis=1) + jnp.maximum(s_gated, 0.0)
    acc = jnp.where(gated, acc, -1.0)
    best_acc = jnp.max(acc)
    keep = gated & (acc > 0.75 * best_acc)
    s_keep = jnp.where(keep, s, -1.0)
    # top-C candidates by raw score
    cand_s, cand_i = prims.sort_top_k(s_keep, C_MAX)
    cand_ok = cand_s > 0
    cand_i = cand_i.astype(jnp.int32)
    # consistency groups: candidate's covisibility group as boolean rows
    onehot = cand_i[:, None] == ids[None, :]
    groups = ((W_cov[cand_i] > 0) | onehot) & cand_ok[:, None]  # [C, K]
    inter = jnp.any(groups[:, None, :] & loop.prev_groups[None, :, :],
                    axis=2)  # [C, C]
    counts = jnp.max(jnp.where(inter, loop.prev_counts[None, :] + 1, 0),
                     axis=1)  # [C]
    accepted = cand_ok & (counts + 1 >= CONSISTENCY_TH)
    # gap gate (>=10 keyframes since last loop) — also clears groups
    gap_ok = (kf - loop.last_loop_kf) >= MIN_GAP
    accepted = accepted & gap_ok
    # earliest accepted candidate (they are score-ordered)
    first = jnp.argmax(accepted.astype(jnp.int32))
    cand = jnp.where(jnp.any(accepted), cand_i[first], jnp.int32(-1))
    if _LOOP_DEBUG:
        jax.debug.print(
            "[loopdbg] detect kf={kf} min_s={ms:.4f} best_s={bs:.4f} "
            "n_gated={ng} n_keep={nk} cand_s={cs} counts={c} gap_ok={g} "
            "cand={cand}", kf=kf, ms=min_score,
            bs=jnp.max(jnp.where(live & ~covis_row, s, -1.0)),
            ng=jnp.sum(gated.astype(jnp.int32)),
            nk=jnp.sum(keep.astype(jnp.int32)), cs=cand_s, c=counts + 1,
            g=gap_ok, cand=cand)
    loop = loop._replace(
        prev_groups=jnp.where(gap_ok, groups, jnp.zeros_like(groups)),
        prev_counts=jnp.where(gap_ok, counts, jnp.zeros_like(counts)),
    )
    return cand, loop


def _kf_landmark_set(m: MapState, kf):
    """Per-feature landmark bundle of a keyframe: row i = the landmark
    matched to feature i (valid where one exists)."""
    lm = m.kf_lm[kf]
    safe = jnp.clip(lm, 0)
    has = (lm >= 0) & m.kf_feat_valid[kf] & m.lm_valid[safe]
    return msearch.LandmarkSet(
        m.lm_pw[safe], m.lm_normal[safe], m.lm_dmin[safe], m.lm_dmax[safe],
        m.lm_desc[safe], has), has


def sim3_grow_matches(m: MapState, cam, kf, cand, idx, matched,
                      R12, t12, s12):
    """SearchBySim3 match growing (reference: LoopClosing.cc:400 ->
    ORBmatcher::SearchBySim3 ORBmatcher.cc:1285+): mutually-consistent
    cross-projection matches through the RANSAC Sim3, unioned with the
    existing BoW matches (the reference only fills empty vpMatches1 slots).

    Returns (grow_idx [N] feature-of-cand or -1, valid [N])."""
    N = m.kf_lm.shape[1]
    lmset1, has1 = _kf_landmark_set(m, kf)
    lmset2, has2 = _kf_landmark_set(m, cand)
    feats1 = msearch.FeatureSet(
        m.kf_xy[kf], m.kf_ur[kf], m.kf_octave[kf], m.kf_angle[kf],
        m.kf_desc[kf], m.kf_feat_valid[kf])
    feats2 = msearch.FeatureSet(
        m.kf_xy[cand], m.kf_ur[cand], m.kf_octave[cand], m.kf_angle[cand],
        m.kf_desc[cand], m.kf_feat_valid[cand])
    idx21, mutual = msearch.search_by_sim3(
        cam, R12, t12, s12, m.kf_R[kf], m.kf_t[kf],
        m.kf_R[cand], m.kf_t[cand], lmset1, lmset2, feats1, feats2,
        None, None)
    grow_idx = jnp.where(matched, idx,
                         jnp.where(mutual & has1 & has2[jnp.clip(idx21, 0)],
                                   idx21, -1))
    return grow_idx, grow_idx >= 0


def sim3_accept_gate(m: MapState, cam, kf, cand, R12, t12, s12,
                     already_feats, width: int, height: int,
                     lm_cap: int = 4096):
    """Final loop acceptance (reference: LoopClosing.cc:440-480): project
    the loop keyframe group's landmarks into the current keyframe through
    Scw = S12 o T_cand_w (SearchByProjection th=10, ORBmatcher.cc:359-478)
    and count total matched features (Sim3 matches + projections) — the
    loop is accepted only at >= 40 (reference :471).

    already_feats [N] bool: current-KF features already matched by the
    (grown) Sim3 match set. Returns (total, ok40)."""
    K = m.kf_R.shape[0]
    w_cand = covisibility_weights(m, cand)
    loop_gm = (w_cand > 0) | (jnp.arange(K) == cand)
    obs_in_loop = jnp.any(
        loop_gm[jnp.clip(m.lm_obs_kf, 0)] & (m.lm_obs_kf >= 0),
        axis=1) & m.lm_valid
    sel, g_ok = prims.gather_mask_indices(obs_in_loop, lm_cap)
    lmset = msearch.LandmarkSet(
        m.lm_pw[sel], m.lm_normal[sel], m.lm_dmin[sel], m.lm_dmax[sel],
        m.lm_desc[sel], g_ok)
    feats = msearch.FeatureSet(
        m.kf_xy[kf], m.kf_ur[kf], m.kf_octave[kf], m.kf_angle[kf],
        m.kf_desc[kf], m.kf_feat_valid[kf])
    Rcw, tcw, scw = sim3.compose(R12, t12, s12,
                                 m.kf_R[cand], m.kf_t[cand], jnp.ones(()))
    idx, ok = msearch.search_by_scw_projection(
        cam, Rcw, tcw, scw, lmset, feats, already_feats,
        width, height, th=10.0)
    N = feats.xy.shape[0]
    # distinct matched features (batched sweep can double-assign; the
    # reference's sequential vpMatched[idx] writes are first-wins)
    proj_feat = jnp.zeros(N, jnp.int32).at[jnp.clip(idx, 0)].add(
        ok.astype(jnp.int32)) > 0
    total = (jnp.sum(proj_feat.astype(jnp.int32))
             + jnp.sum(already_feats.astype(jnp.int32)))
    return total, total >= 40


def _sim3_solve(loop: LoopCarry, m: MapState, cam, kf, cand,
                fix_scale: bool):
    """ComputeSim3 on device (reference: LoopClosing.cc:291-487): brute
    Hamming match between the two keyframes' landmark features, batched
    Horn RANSAC, SearchBySim3 match growing, Sim3 refinement.
    Returns (ok, R12, t12, s12, new_key, lm_cur, lm_cand, pair_ok,
    matched_feats)."""
    lm1 = m.kf_lm[kf]
    lm2 = m.kf_lm[cand]
    has1 = (lm1 >= 0) & m.kf_feat_valid[kf] & m.lm_valid[jnp.clip(lm1, 0)]
    has2 = (lm2 >= 0) & m.kf_feat_valid[cand] & m.lm_valid[jnp.clip(lm2, 0)]
    idx, dist, matched = msearch.search_brute(
        m.kf_desc[kf], m.kf_desc[cand], has1, has2, ratio=0.75,
        angle_q=m.kf_angle[kf], angle_t=m.kf_angle[cand])
    n_matches = jnp.sum(matched.astype(jnp.int32))
    safe_idx = jnp.where(matched, idx, 0)
    l1 = jnp.clip(lm1, 0)
    l2 = jnp.clip(m.kf_lm[cand][safe_idx], 0)
    X1c = se3.transform(m.kf_R[kf], m.kf_t[kf], m.lm_pw[l1])
    X2c = se3.transform(m.kf_R[cand], m.kf_t[cand], m.lm_pw[l2])
    uv1 = m.kf_xy[kf]
    uv2 = m.kf_xy[cand][safe_idx]
    s2_1 = msearch.sigma2_at(m.kf_octave[kf])
    s2_2 = msearch.sigma2_at(m.kf_octave[cand][safe_idx])
    valid = matched & has1
    K_cam = (cam.fx, cam.fy, cam.cx, cam.cy)
    key, sub = jax.random.split(loop.key)
    res = sim3solver.solve_ransac(
        sub, K_cam, K_cam, X1c, X2c, uv1, uv2, s2_1, s2_2, valid,
        max_iters=300, min_inliers=20, fix_scale=fix_scale)
    # SearchBySim3 growth through the RANSAC model (reference :400)
    grow_idx, grown = sim3_grow_matches(
        m, cam, kf, cand, idx, matched, res.R, res.t, res.s)
    safe_g = jnp.clip(grow_idx, 0)
    l2g = jnp.clip(m.kf_lm[cand][safe_g], 0)
    X2c_g = se3.transform(m.kf_R[cand], m.kf_t[cand], m.lm_pw[l2g])
    uv2_g = m.kf_xy[cand][safe_g]
    s2_2g = msearch.sigma2_at(m.kf_octave[cand][safe_g])
    valid_g = grown & has1
    ref = sim3_opt.optimize_sim3(
        K_cam, K_cam, res.R, res.t, res.s, X1c, X2c_g, uv1, uv2_g,
        1.0 / s2_1, 1.0 / s2_2g, valid_g, iters=10, fix_scale=fix_scale)
    ok = ((n_matches >= 20) & (res.n_inliers >= 20)
          & (ref.n_inliers >= 20))  # reference :333,408
    if _LOOP_DEBUG:
        _, _, m_all = msearch.search_brute(
            m.kf_desc[kf], m.kf_desc[cand], m.kf_feat_valid[kf],
            m.kf_feat_valid[cand], ratio=0.75,
            angle_q=m.kf_angle[kf], angle_t=m.kf_angle[cand])
        jax.debug.print(
            "[loopdbg] sim3 kf={kf}(f{fk}) cand={cand}(f{fc}) n_lm1={n1} "
            "n_lm2={n2} n_bow={nm} n_unmasked={nu} ransac_inl={ri} "
            "ref_inl={fi} s={s:.4f} ok={ok}",
            kf=kf, cand=cand, fk=m.kf_frame_id[kf],
            fc=m.kf_frame_id[cand], n1=jnp.sum(has1.astype(jnp.int32)),
            n2=jnp.sum(has2.astype(jnp.int32)), nm=n_matches,
            nu=jnp.sum(m_all.astype(jnp.int32)),
            ri=res.n_inliers, fi=ref.n_inliers, s=ref.s, ok=ok)
    # matched landmark pairs for the correction's Replace pass
    pair_ok = ref.inliers & valid_g & (l1 != l2g)
    lm_cur = jnp.where(pair_ok, l1, -1)
    lm_cand = jnp.where(pair_ok, l2g, -1)
    return (ok, ref.R, ref.t, ref.s, key, lm_cur, lm_cand, pair_ok,
            valid_g)


def _correct(m: MapState, cam, kf, cand, R12, t12, s12, fix_scale: bool,
             lm_cur, lm_cand, pair_ok, loop_edges, width: int,
             height: int) -> MapState:
    """CorrectLoop on device: Sim3 propagation over the current
    covisibility group, landmark correction, matched-pair Replace,
    SearchAndFuse welding, essential-graph optimization with the
    reference's edge families, bounded global BA."""
    from ..mapstate.map import merge_landmarks
    from . import steps
    K = m.kf_R.shape[0]
    # corrected current pose: S_cur_w = S12 o T_cand_w
    Rc, tc, sc = sim3.compose(R12, t12, s12,
                              m.kf_R[cand], m.kf_t[cand], jnp.ones(()))
    # world correction G = S_cur_w_corr^-1 o T_cur_w (old world -> new)
    Rg, tg, sg = sim3.compose(*sim3.inverse(Rc, tc, sc),
                              m.kf_R[kf], m.kf_t[kf], jnp.ones(()))
    Rgi, tgi, sgi = sim3.inverse(Rg, tg, sg)
    w = covisibility_weights(m, kf)
    gm = (w > 0) | (jnp.arange(K) == kf)
    # pre-propagation poses: essential-graph edge measurements must come
    # from the UNCORRECTED estimates (the reference's NonCorrectedSim3,
    # LoopClosing.cc:546-580) or every non-loop edge starts at zero
    # residual and the graph distributes nothing
    R_old_all, t_old_all = m.kf_R, m.kf_t
    Ri, ti, si = sim3.compose(
        m.kf_R, m.kf_t, jnp.ones(K),
        jnp.broadcast_to(Rgi, (K, 3, 3)), jnp.broadcast_to(tgi, (K, 3)),
        jnp.broadcast_to(sgi, (K,)))
    kf_R = jnp.where(gm[:, None, None], Ri, m.kf_R)
    kf_t = jnp.where(gm[:, None], ti / jnp.clip(si, 1e-9, None)[:, None],
                     m.kf_t)
    # Full CORRECTED Sim3 per group vertex (reference CorrectedSim3 map,
    # LoopClosing.cc:532-545): the essential graph must see the scale
    # part of the correction or it cannot distribute monocular scale
    # drift around the loop (Optimizer.cc:860-886 inserts vScw with
    # si != 1 for corrected vertices). For fix_scale=True s12 is 1, so
    # these equal the SE3 arrays and nothing changes.
    t_sim = jnp.where(gm[:, None], ti, m.kf_t)
    s_sim = jnp.where(gm, si, jnp.ones(K))
    lm_ref_in_group = gm[jnp.clip(m.lm_ref_kf, 0, K - 1)] & m.lm_valid
    pw_corr = sim3.transform(Rg, tg, sg, m.lm_pw)
    lm_pw = jnp.where(lm_ref_in_group[:, None], pw_corr, m.lm_pw)
    m = m._replace(kf_R=kf_R, kf_t=kf_t, lm_pw=lm_pw)

    # --- matched-pair Replace (reference :638-661): loop landmark wins ---
    rep_ok = pair_ok & (lm_cur >= 0) & (lm_cand >= 0) & (lm_cur != lm_cand)
    m = merge_landmarks(m, jnp.clip(lm_cand, 0), jnp.clip(lm_cur, 0), rep_ok)

    # --- SearchAndFuse (reference :661-692, :725-754): project the loop
    # group's landmarks into the corrected keyframes ---
    w_cand = covisibility_weights(m, cand)
    loop_gm = (w_cand > 0) | (jnp.arange(K) == cand)
    obs_in_loop = jnp.any(
        loop_gm[jnp.clip(m.lm_obs_kf, 0)] & (m.lm_obs_kf >= 0), axis=1)
    top_w, top_i = prims.sort_top_k(w, 15)
    group_kfs = jnp.concatenate(
        [kf[None].astype(jnp.int32),
         jnp.where(top_w > 0, top_i.astype(jnp.int32), -1)])
    m = steps.loop_search_and_fuse(m, cam, obs_in_loop, group_kfs,
                                   width, height)

    # --- essential graph (reference: Optimizer.cc:908-1053 edge families:
    # loop edges incl. past ones + spanning-tree equivalent temporal chain
    # + covisibility w >= 100) ---
    W_cov = covisibility_matrix(m)
    live = m.kf_valid.astype(jnp.int32)
    rank = jnp.cumsum(live) - live
    if K <= 64:
        # all-pairs triu, masked — cheap at this size, exhaustive
        iu, ju = np.triu_indices(K, k=1)
        e_i = jnp.asarray(iu, jnp.int32)
        e_j = jnp.asarray(ju, jnp.int32)
        w_e = W_cov[e_i, e_j]
        is_loop_edge = (((e_i == jnp.minimum(kf, cand))
                         & (e_j == jnp.maximum(kf, cand)))
                        | loop_edges[e_i, e_j] | loop_edges[e_j, e_i])
        is_chain = (m.kf_valid[e_i] & m.kf_valid[e_j]
                    & (rank[e_j] == rank[e_i] + 1))
        e_valid = (((w_e >= 100) | is_loop_edge | is_chain)
                   & m.kf_valid[e_i] & m.kf_valid[e_j])
    else:
        # bounded top-k extraction: the all-pairs triu is O(K^2) edges
        # (~524k at K=1024, each with two 7x7 jacfwd blocks). Per vertex:
        # its top-8 covisibility neighbors (w>=100 gate), plus the
        # temporal chain, plus up to 64 stored loop edges — O(K) total,
        # the same families g2o's sparse graph holds.
        TOPC = 8
        LOOP_CAP = 64
        top_w, top_j = prims.sort_top_k(W_cov, TOPC)  # per-row [K, TOPC]
        ids = jnp.arange(K, dtype=jnp.int32)
        ci = jnp.repeat(ids, TOPC)
        cj = top_j.astype(jnp.int32).reshape(-1)
        # i<j keeps each undirected pair once (both endpoints list strong
        # mutual neighbors, so the i>j duplicates add nothing)
        cov_ok = (top_w.reshape(-1) >= 100) & (ci < cj)
        # temporal chain over LIVE slots: gather live indices in slot
        # order, then chain consecutive entries — this bridges culled
        # (kf_valid=False) gaps exactly like the dense path's
        # rank[e_j] == rank[e_i] + 1 test, so loop corrections propagate
        # past dead slots (reference spanning tree: Optimizer.cc:934-948)
        live_sel, live_ok = prims.gather_mask_indices(m.kf_valid, K)
        chain_i = live_sel[:-1]
        chain_j = live_sel[1:]
        chain_ok = live_ok[:-1] & live_ok[1:]
        # stored loop edges, bounded gather from the [K,K] bool matrix
        flat_sel, flat_ok = prims.gather_mask_indices(
            loop_edges.reshape(-1), LOOP_CAP)
        li = (flat_sel // K).astype(jnp.int32)
        lj = jnp.mod(flat_sel, K).astype(jnp.int32)
        cur_i = jnp.minimum(kf, cand)[None]
        cur_j = jnp.maximum(kf, cand)[None]
        e_i = jnp.concatenate([ci, chain_i, li, cur_i])
        e_j = jnp.concatenate([cj, chain_j, lj, cur_j])
        e_valid = jnp.concatenate([
            cov_ok, chain_ok, flat_ok, jnp.ones(1, bool)])
        e_valid = (e_valid & m.kf_valid[e_i] & m.kf_valid[e_j]
                   & (e_i != e_j))
        is_loop_edge = jnp.concatenate([
            jnp.zeros(ci.shape[0], bool), jnp.zeros(K - 1, bool),
            flat_ok, jnp.ones(1, bool)])
    # measurements: pre-propagation poses everywhere EXCEPT loop edges,
    # which carry the new (corrected) constraint as a FULL Sim3 — the
    # scale ratio of the loop edge is what drives the 7th dof when
    # fix_scale=False (reference Optimizer.cc:925-931: Sji from the
    # corrected Scw entries)
    use_new = is_loop_edge[:, None, None]
    Ri_ = jnp.where(use_new, m.kf_R[e_i], R_old_all[e_i])
    ti_ = jnp.where(use_new[:, :, 0], t_sim[e_i], t_old_all[e_i])
    si_ = jnp.where(is_loop_edge, s_sim[e_i], jnp.ones_like(s_sim[e_i]))
    Rj_ = jnp.where(use_new, m.kf_R[e_j], R_old_all[e_j])
    tj_ = jnp.where(use_new[:, :, 0], t_sim[e_j], t_old_all[e_j])
    sj_ = jnp.where(is_loop_edge, s_sim[e_j], jnp.ones_like(s_sim[e_j]))
    iRi, iti, isi = sim3.inverse(Ri_, ti_, si_)
    mR, mt, ms = sim3.compose(Rj_, tj_, sj_, iRi, iti, isi)
    fixed = (jnp.zeros(K, bool).at[cand].set(True) | ~m.kf_valid)
    prob = pose_graph.PoseGraphProblem(
        m.kf_R, t_sim, s_sim, e_i, e_j, mR, mt,
        ms, e_valid, fixed)
    if K > 256:  # dense [K*7]^2 solve is a memory wall beyond ~256
        res = pose_graph.optimize_pose_graph_cg(prob, iters=20,
                                                fix_scale=fix_scale)
    else:
        res = pose_graph.optimize_pose_graph(prob, iters=20,
                                             fix_scale=fix_scale)
    # landmark re-anchoring (reference LoopClosing correct-via-reference
    # semantics, Optimizer.cc:1061-1080): P_new = S_wr_new.map(T_rw_old
    # .map(P)) — camera coords through the OLD reference pose, back to
    # world through the INVERSE of the optimized Sim3, whose 1/s factor
    # rescales the depth so the map stays metrically consistent with the
    # corrected (t/s) poses. With all scales 1 this is the SE3 identity.
    ref_kf_ = jnp.clip(m.lm_ref_kf, 0, K - 1)
    # forward map through the reference vertex's INITIAL Sim3 (vScw in
    # the reference — the corrected Sim3 for group members, the old SE3
    # elsewhere), so landmarks already corrected by the propagation are
    # not double-moved
    s_new = jnp.clip(res.s[ref_kf_], 1e-9, None)
    Xc = sim3.transform(m.kf_R[ref_kf_], t_sim[ref_kf_], s_sim[ref_kf_],
                        m.lm_pw)
    iRn, itn = se3.inverse(res.R[ref_kf_], res.t[ref_kf_])
    pw = se3.transform(iRn, itn, Xc) / s_new[:, None]
    lm_pw = jnp.where(m.lm_valid[:, None], pw, m.lm_pw)
    kf_t_new = res.t / jnp.clip(res.s, 1e-9, None)[:, None]
    m = m._replace(kf_R=res.R, kf_t=kf_t_new, lm_pw=lm_pw)

    # --- bounded global BA (reference: GBA 10 iters, LoopClosing.cc:795).
    # Dense Schur for small maps (all-matmul), CG-on-Schur beyond (the
    # one-hot [D,L,P] tensor is quadratic-in-P memory) ---
    obs_valid = m.lm_obs_kf >= 0
    kf_idx = jnp.clip(m.lm_obs_kf, 0)
    feat_idx = m.lm_obs_feat
    uv = m.kf_xy[kf_idx, feat_idx]
    ur = m.kf_ur[kf_idx, feat_idx]
    uvr = jnp.concatenate([uv, ur[..., None]], axis=-1)
    octv = m.kf_octave[kf_idx, feat_idx]
    wgt = jnp.where(obs_valid & m.lm_valid[:, None],
                    msearch.inv_sigma2_at(octv), 0.0)
    fixed_ba = jnp.zeros(K, bool).at[0].set(True) | ~m.kf_valid
    prob_ba = ba.BAProblem(m.kf_R, m.kf_t, m.lm_pw, kf_idx, uvr, wgt,
                           fixed_ba, m.lm_valid)
    if K <= 64:
        res_ba = ba.ba_solve(cam, prob_ba, iters=10, robust=True)
    else:
        res_ba = ba.ba_solve_cg(cam, prob_ba, iters=10, robust=True)
    m = m._replace(kf_R=res_ba.R, kf_t=res_ba.t, lm_pw=res_ba.X)
    return rebuild_observations(m)


def close_loop_step(loop: LoopCarry, m: MapState, cam, kf, voc,
                    fix_scale: bool, width: int = 640,
                    height: int = 480,
                    add_bow: bool = True) -> tuple[MapState, LoopCarry]:
    """Full loop-closing pass for a freshly inserted keyframe ``kf``:
    BoW row -> detection -> consistency -> (cond) Sim3 -> (cond) correction.
    Pure; intended to run inside the keyframe branch of the autonomous
    step. The untaken Sim3/correction branches cost nothing at runtime.
    ``add_bow=False`` when the caller stored the BoW row at insertion
    (the amortized-maintenance path)."""
    if add_bow:
        loop = add_keyframe_bow(loop, voc, kf, m.kf_desc[kf],
                                m.kf_feat_valid[kf])
    cand, loop = detect(loop, m, kf, int(voc.n_words))

    def try_sim3(args):
        m, loop = args
        (ok, R12, t12, s12, key, lm_cur, lm_cand, pair_ok,
         matched_feats) = _sim3_solve(loop, m, cam, kf, cand, fix_scale)
        loop = loop._replace(key=key)

        def check40(args):
            m, loop = args
            # final acceptance: loop-group landmark projection must reach
            # >= 40 total matches (reference: LoopClosing.cc:459-471)
            total, ok40 = sim3_accept_gate(
                m, cam, kf, cand, R12, t12, s12, matched_feats,
                width, height)
            if _LOOP_DEBUG:
                jax.debug.print(
                    "[loopdbg] gate40 kf={kf} cand={cand} total={t} "
                    "ok40={ok}", kf=kf, cand=cand, t=total, ok=ok40)

            def do_correct(args):
                m, loop = args
                m = _correct(m, cam, kf, cand, R12, t12, s12, fix_scale,
                             lm_cur, lm_cand, pair_ok, loop.loop_edges,
                             width, height)
                i, j = jnp.minimum(kf, cand), jnp.maximum(kf, cand)
                return m, loop._replace(
                    last_loop_kf=kf, n_loops=loop.n_loops + 1,
                    loop_edges=loop.loop_edges.at[i, j].set(True))

            return jax.lax.cond(ok40, do_correct, lambda a: a, (m, loop))

        return jax.lax.cond(ok, check40, lambda a: a, (m, loop))

    return jax.lax.cond(cand >= 0, try_sim3, lambda a: a, (m, loop))
