"""Loop detection, Sim3 computation, and loop correction.

JAX rebuild of the reference's LoopClosing thread (reference:
src/LoopClosing.cc): BoW candidate retrieval with covisibility-consistency
confirmation across consecutive keyframes (DetectLoop :105-264,
mnCovisibilityConsistencyTh=3), Sim3 RANSAC + refinement with inlier gates
(ComputeSim3 :291-487: >=20 BoW matches, >=20 Sim3 inliers, >=40 total),
and loop correction (CorrectLoop :509-719): Sim3 pose propagation over the
current covisibility group, landmark correction via reference keyframes,
duplicate fusion, essential-graph optimization, and a bounded global BA
(the reference's asynchronous GBA thread becomes a bounded-iteration call —
SURVEY §2.5 P3/P6).

Runs synchronously after keyframe insertion, as a host sequencer over
jitted steps.
"""
from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from ..geometry import se3, sim3
from ..mapstate.map import (MapState, covisibility_matrix,
                             covisibility_weights, rebuild_observations)
from ..matching import search as msearch
from ..optim import ba, pose_graph, sim3_opt
from ..optim.residuals import CamParams
from ..place.database import KeyFrameDatabase
from ..solvers import sim3solver
from typing import NamedTuple


class Sim3Result(NamedTuple):
    """Accepted loop transform + the landmark matches that supported it
    (needed by the correction's Replace pass, reference
    LoopClosing.cc:638-661)."""
    R: jax.Array  # maps candidate-camera coords into current-camera coords
    t: jax.Array
    s: float
    n_inliers: int
    lm_cur: jax.Array   # [N] current-KF landmark per matched pair
    lm_cand: jax.Array  # [N] loop-KF landmark per matched pair
    pair_ok: jax.Array  # [N] bool inlier mask


class LoopCloser:
    def __init__(self, cam: CamParams, db: KeyFrameDatabase,
                 fix_scale: bool = True, covis_consistency: int = 3,
                 min_gap: int = 10, width: int = 640, height: int = 480):
        self.cam = cam
        self.db = db
        self.width = int(width)
        self.height = int(height)
        self.fix_scale = fix_scale
        self.consistency_th = covis_consistency
        self.min_gap = min_gap  # >=10 keyframes since last loop (ref :116)
        self.last_loop_kf = -self.min_gap
        self.prev_groups: list[tuple[set[int], int]] = []
        self.key = jax.random.PRNGKey(7)
        self.n_loops_closed = 0
        # accepted loop edges, kept across closures: the reference's
        # essential graph includes ALL past loop edges
        # (KeyFrame::GetLoopEdges, Optimizer.cc:908-919)
        self.loop_edges: list[tuple[int, int]] = []
        # asynchronous global BA (reference: RunGlobalBundleAdjustment
        # thread, LoopClosing.cc:711,790-901): the 10 GBA iterations run
        # as bounded chunks polled once per frame (poll_gba), on a problem
        # SNAPSHOT taken at correction time; a newer loop aborts a
        # still-running GBA exactly like the reference's mnFullBAIdx
        # generation counter (:518-530, 794-803)
        self._gba = None
        self.gba_generation = 0
        self.gba_chunk_iters = 2
        self.gba_total_iters = 10
        # multi-device GBA backend: when a Mesh is attached (e.g. by the
        # distributed launcher, scripts/launch_distributed.py), global-BA
        # chunks dispatch to parallel.dist_ba.ba_solve_sharded instead of
        # the single-device engines
        self.mesh = None
        # ONE device program for the whole detection pass (covisibility
        # matrix + BoW scores) instead of separate eager calls per
        # keyframe
        from ..place import vocabulary as V

        n_words = int(db.voc.n_words)

        def _detect_dev(m: MapState, bow_idx, bow_w, kf):
            s = jnp.where(
                m.kf_valid,
                V.score_l1_sparse(bow_idx[kf], bow_w[kf], bow_idx, bow_w,
                                  n_words), -1.0)
            return covisibility_matrix(m), s

        self._detect_dev = jax.jit(_detect_dev)

    def remap_slots(self, rank: np.ndarray, valid: np.ndarray):
        """Mirror a keyframe compaction: remap slot-keyed detection state
        (last loop keyframe, covisibility-consistency groups) through the
        old->new slot map; members of consistency groups that were culled
        simply drop out."""
        if 0 <= self.last_loop_kf < len(rank):
            self.last_loop_kf = int(rank[self.last_loop_kf])
        self.prev_groups = [
            ({int(rank[j]) for j in group if 0 <= j < len(valid) and valid[j]},
             count)
            for group, count in self.prev_groups]
        self.prev_groups = [(g, c) for g, c in self.prev_groups if g]
        # accepted loop edges survive compaction only while both endpoints
        # live (a culled endpoint means the constraint is already absorbed)
        self.loop_edges = [
            (int(rank[i]), int(rank[j])) for i, j in self.loop_edges
            if i < len(valid) and j < len(valid) and valid[i] and valid[j]]
        # a pending GBA snapshot is keyed by pre-compaction slots: abort it
        # (the next loop, or nothing, restarts it — same as the reference
        # dropping a GBA whose map changed underneath, :518-530)
        self._gba = None

    # -- detection ------------------------------------------------------
    def _covis_group(self, m: MapState, kf: int) -> set[int]:
        w = np.asarray(covisibility_weights(m, jnp.int32(kf)))
        return {int(j) for j in np.where(w > 0)[0]} | {kf}

    def detect(self, m: MapState, kf: int) -> int | None:
        """Returns a consistent loop-candidate keyframe id, or None."""
        if kf - self.last_loop_kf < self.min_gap:
            self.prev_groups = []
            return None
        # one batched covisibility matrix + one score sweep for the whole
        # detection pass (was one device round trip per keyframe row)
        W_dev, s_dev = self._detect_dev(m, self.db.bow_idx, self.db.bow_w,
                                     jnp.int32(kf))
        W = np.asarray(W_dev)
        s_all = np.asarray(s_dev)
        covis = np.where(W[kf] > 0)[0]
        min_score = float(min([s_all[int(j)] for j in covis], default=0.5))
        min_score = max(min_score, 0.0)
        candidates = self.db.detect_loop_candidates(m, kf, min_score,
                                                    covis=W, scores=s_all)
        return self._consistency(W, candidates)

    # -- Sim3 -----------------------------------------------------------
    def compute_sim3(self, m: MapState, kf: int, cand: int):
        """Match landmarks of the two keyframes, RANSAC+refine S_cur_cand.

        Returns (R12, t12, s12, n_inliers) with convention: maps candidate-
        camera coordinates into current-camera coordinates, or None.
        """
        cam = self.cam
        lm1 = m.kf_lm[kf]
        lm2 = m.kf_lm[cand]
        has1 = (lm1 >= 0) & m.kf_feat_valid[kf] & m.lm_valid[jnp.clip(lm1, 0)]
        has2 = (lm2 >= 0) & m.kf_feat_valid[cand] & m.lm_valid[jnp.clip(lm2, 0)]
        idx, dist, matched = msearch.search_brute(
            m.kf_desc[kf], m.kf_desc[cand], has1, has2, ratio=0.75,
            angle_q=m.kf_angle[kf], angle_t=m.kf_angle[cand])
        n_matches = int(jnp.sum(matched))
        if n_matches < 20:  # reference :333
            return None
        # camera-frame coordinates of the matched landmark pairs
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
        K = (float(cam.fx), float(cam.fy), float(cam.cx), float(cam.cy))
        self.key, sub = jax.random.split(self.key)
        res = sim3solver.solve_ransac(
            sub, K, K, X1c, X2c, uv1, uv2, s2_1, s2_2, valid,
            max_iters=300, min_inliers=20, fix_scale=self.fix_scale)
        if int(res.n_inliers) < 20:  # reference :408
            return None
        # SearchBySim3 match growing through the RANSAC model (reference:
        # LoopClosing.cc:400 -> ORBmatcher::SearchBySim3 :1285+), then
        # refine on the grown set
        from . import auto_loop
        grow_idx, grown = auto_loop.sim3_grow_matches(
            m, cam, jnp.int32(kf), jnp.int32(cand), idx, matched,
            res.R, res.t, res.s)
        safe_g = jnp.clip(grow_idx, 0)
        l2g = jnp.clip(m.kf_lm[cand][safe_g], 0)
        X2c_g = se3.transform(m.kf_R[cand], m.kf_t[cand], m.lm_pw[l2g])
        uv2_g = m.kf_xy[cand][safe_g]
        s2_2g = msearch.sigma2_at(m.kf_octave[cand][safe_g])
        valid_g = grown & has1
        ref = sim3_opt.optimize_sim3(
            K, K, res.R, res.t, res.s, X1c, X2c_g, uv1, uv2_g,
            1.0 / s2_1, 1.0 / s2_2g, valid_g,
            iters=10, fix_scale=self.fix_scale)
        if int(ref.n_inliers) < 20:
            return None
        # final acceptance: project the loop group's landmarks through
        # Scw (th=10) and require >= 40 total matches (reference :459-471)
        _, ok40 = auto_loop.sim3_accept_gate(
            m, cam, jnp.int32(kf), jnp.int32(cand), ref.R, ref.t, ref.s,
            valid_g, self.width, self.height)
        if not bool(ok40):
            return None
        # exclude self-pairs (a landmark matched to itself across the two
        # keyframes would Replace a point with itself) — mirrors the
        # device path's (l1 != l2g) guard in _sim3_solve
        pair_ok = valid_g & (l1 != l2g)
        return Sim3Result(ref.R, ref.t, ref.s, int(ref.n_inliers),
                          jnp.where(pair_ok, l1, -1),
                          jnp.where(pair_ok, l2g, -1),
                          ref.inliers & pair_ok)

    # -- correction -----------------------------------------------------
    def correct(self, m: MapState, kf: int, cand: int,
                S12: Sim3Result, sync_gba: bool = True) -> MapState:
        """Loop correction (reference: LoopClosing.cc:509-719): Sim3-
        consistent pose update of the current covisibility group, landmark
        correction via reference keyframes, matched-point Replace,
        SearchAndFuse welding, essential-graph optimization, bounded
        global BA."""
        R12, t12, s12 = S12.R, S12.t, S12.s
        K = m.kf_R.shape[0]
        # corrected current pose: T_cur<-w = S12 * T_cand<-w  (cand frame
        # mapped into cur camera), i.e. S_cur_w_corr = S12 o T_cand_w
        Rc, tc, sc = sim3.compose(
            R12, t12, jnp.asarray(s12),
            m.kf_R[cand], m.kf_t[cand], jnp.ones(()))
        # correction transform in world: G = S_cur_w_corr^-1 o T_cur_w
        # applied to the current covisibility group's poses/landmarks
        Rg, tg, sg = sim3.compose(
            *sim3.inverse(Rc, tc, sc), m.kf_R[kf], m.kf_t[kf], jnp.ones(()))
        # G maps old-world -> corrected-world?  S_kf_w_corr = S_kf_w o G^-1
        Rgi, tgi, sgi = sim3.inverse(Rg, tg, sg)
        w = np.asarray(covisibility_weights(m, jnp.int32(kf)))
        group = [int(j) for j in np.where(w > 0)[0]] + [kf]
        group_mask = np.zeros(K, bool)
        group_mask[group] = True
        gm = jnp.asarray(group_mask)
        # pre-propagation pose snapshot: essential-graph edge MEASUREMENTS
        # must come from the uncorrected estimates (the reference's
        # NonCorrectedSim3, LoopClosing.cc:546-580 + Optimizer.cc:930-1010)
        # or every non-loop edge starts at zero residual and the pose graph
        # distributes nothing
        R_old, t_old = m.kf_R, m.kf_t
        # corrected poses: T_i_w o G^-1 (as Sim3, scale folded into t)
        Ri, ti, si = sim3.compose(
            m.kf_R, m.kf_t, jnp.ones(K), *(jnp.broadcast_to(Rgi, (K, 3, 3)),
                                           jnp.broadcast_to(tgi, (K, 3)),
                                           jnp.broadcast_to(sgi, (K,))))
        # convert Sim3 poses (R, t, s) back to SE3 with scale absorbed:
        # x_cam = s R x + t  ->  SE3 with R, t/s is the reference's recovery
        kf_R = jnp.where(gm[:, None, None], Ri, m.kf_R)
        kf_t = jnp.where(gm[:, None], ti / jnp.clip(si, 1e-9, None)[:, None], m.kf_t)
        # landmarks observed by the group: correct via old->new world map G
        lm_ref_in_group = gm[jnp.clip(m.lm_ref_kf, 0, K - 1)] & m.lm_valid
        pw_corr = sim3.transform(Rg, tg, sg, m.lm_pw)
        lm_pw = jnp.where(lm_ref_in_group[:, None], pw_corr, m.lm_pw)
        m = m._replace(kf_R=kf_R, kf_t=kf_t, lm_pw=lm_pw)

        # --- matched-point Replace (reference: LoopClosing.cc:638-661):
        # the Sim3 inlier pairs are the SAME physical points seen from both
        # sides of the loop; merge them, loop side winning (longer history)
        from ..mapstate.map import merge_landmarks
        from . import steps
        pair_ok = (S12.pair_ok & (S12.lm_cur >= 0) & (S12.lm_cand >= 0)
                   & (S12.lm_cur != S12.lm_cand))
        m = merge_landmarks(m, jnp.clip(S12.lm_cand, 0),
                            jnp.clip(S12.lm_cur, 0), pair_ok)

        # --- SearchAndFuse (reference :661-692 via :725-754): project the
        # loop group's landmarks into every corrected keyframe
        w_cand = np.asarray(covisibility_weights(m, jnp.int32(cand)))
        loop_group = [int(j) for j in np.where(w_cand > 0)[0]] + [cand]
        loop_kf_mask = np.zeros(K, bool)
        loop_kf_mask[loop_group] = True
        lkm = jnp.asarray(loop_kf_mask)
        obs_in_loop = jnp.any(
            lkm[jnp.clip(m.lm_obs_kf, 0)] & (m.lm_obs_kf >= 0), axis=1)
        G = 32
        group_pad = np.full(G, -1, np.int32)
        group_pad[:min(len(group), G)] = group[:G]
        m = steps.loop_search_and_fuse(
            m, self.cam, obs_in_loop, jnp.asarray(group_pad),
            self.width, self.height)

        # --- essential-graph optimization over all keyframes ---
        valid_kf = np.asarray(m.kf_valid)
        n_valid = int(valid_kf.sum())
        self.loop_edges.append((min(kf, cand), max(kf, cand)))
        if n_valid >= 4:
            m = self._essential_graph(m, kf, cand, R_old, t_old,
                                      group_mask=gm, group_scale=sgi)
        m = rebuild_observations(m)
        # --- global BA (reference: new GBA thread, :711): synchronous
        # drain for the simple process() API, chunked/polled for the
        # tracker path; starting it aborts any still-running older GBA
        # (generation counter, :518-530)
        if sync_gba:
            m = self._global_ba(m)
        else:
            self._start_gba(m)
        self.last_loop_kf = kf
        self.n_loops_closed += 1
        return m

    def _essential_graph(self, m: MapState, kf: int, cand: int,
                         R_old=None, t_old=None, group_mask=None,
                         group_scale=None) -> MapState:
        """Essential-graph edge families (reference: Optimizer.cc:908-1053):
        (1) loop edges — current + all past accepted loops;
        (2) spanning-tree equivalent — each keyframe chained to its
            temporal predecessor (the reference's parent is the top
            covisible at insertion, which is the predecessor in practice;
            this chain guarantees connectivity whatever the covisibility
            threshold prunes);
        (3) covisibility edges with weight >= 100 (the reference's
            minFeat=100 gate, Optimizer.cc:860 — NOT every w>=15 pair).
        Edge extraction is one vectorized triu scan, not an O(K^2) Python
        loop."""
        K = m.kf_R.shape[0]
        valid = np.asarray(m.kf_valid)
        W = np.asarray(covisibility_matrix(m))
        W = np.where(valid[:, None] & valid[None, :], W, 0)
        ei, ej = np.nonzero(np.triu(W, 1) >= 100)
        pairs = set(zip(ei.tolist(), ej.tolist()))
        # temporal chain over live slots (stable compaction preserves order)
        live = np.where(valid)[0]
        for a, b in zip(live[:-1], live[1:]):
            pairs.add((int(a), int(b)))
        for e in self.loop_edges:
            if valid[e[0]] and valid[e[1]]:
                pairs.add(e)
        loop_pair = (min(kf, cand), max(kf, cand))
        pairs.add(loop_pair)
        pairs = sorted(pairs)
        e_i = jnp.asarray([p[0] for p in pairs], jnp.int32)
        e_j = jnp.asarray([p[1] for p in pairs], jnp.int32)
        # measurements from the PRE-propagation poses (NonCorrectedSim3);
        # the loop edge alone is measured from the corrected poses — it
        # carries the new constraint the graph distributes
        if R_old is None:
            R_old, t_old = m.kf_R, m.kf_t
        # vertex initial state as FULL Sim3 (reference vScw): corrected
        # group members carry the propagation scale so the 7th dof can
        # distribute monocular scale drift around the loop
        # (Optimizer.cc:860-886, :925-931); all-ones when fix_scale.
        if group_mask is not None and group_scale is not None:
            gm_v = jnp.asarray(group_mask)
            sg = jnp.asarray(group_scale)
            s_sim = jnp.where(gm_v, sg, jnp.ones(K))
            t_sim = jnp.where(gm_v[:, None], m.kf_t * s_sim[:, None],
                              m.kf_t)
        else:
            s_sim = jnp.ones(K)
            t_sim = m.kf_t
        is_loop = jnp.asarray([p == loop_pair or p in self.loop_edges[:-1]
                               for p in pairs])
        Ri = jnp.where(is_loop[:, None, None], m.kf_R[e_i], R_old[e_i])
        ti = jnp.where(is_loop[:, None], t_sim[e_i], t_old[e_i])
        si = jnp.where(is_loop, s_sim[e_i], jnp.ones(len(pairs)))
        Rj = jnp.where(is_loop[:, None, None], m.kf_R[e_j], R_old[e_j])
        tj = jnp.where(is_loop[:, None], t_sim[e_j], t_old[e_j])
        sj = jnp.where(is_loop, s_sim[e_j], jnp.ones(len(pairs)))
        iRi, iti, isi = sim3.inverse(Ri, ti, si)
        mR, mt, ms = sim3.compose(Rj, tj, sj, iRi, iti, isi)
        # slice the vertex set to the live prefix, pow2-bucketed (the dense
        # [N*7, N*7] pose-graph solve must not scale with map CAPACITY)
        n_kf = int(np.max(np.where(valid)[0])) + 1 if valid.any() else 1
        Np = K if n_kf > K // 2 else max(
            64, 1 << (max(n_kf - 1, 1)).bit_length())
        Np = min(Np, K)
        fixed = np.zeros(Np, bool)
        fixed[cand] = True  # reference fixes ONLY the loop KF (:891-892)
        fixed[~valid[:Np]] = True
        prob = pose_graph.PoseGraphProblem(
            m.kf_R[:Np], t_sim[:Np], s_sim[:Np], e_i, e_j, mR, mt, ms,
            jnp.ones(len(pairs), bool), jnp.asarray(fixed))
        # dense [N*7, N*7] Cholesky below ~256 vertices (all-matmul, no
        # scatters); matrix-free block-Jacobi CG beyond (the dense H is
        # ~441 MB at K=1500 — reference: g2o's solve is sparse,
        # Optimizer.cc:829-1118)
        if Np > 256:
            res = pose_graph.optimize_pose_graph_cg(
                prob, iters=20, fix_scale=self.fix_scale)
        else:
            res = pose_graph.optimize_pose_graph(
                prob, iters=20, fix_scale=self.fix_scale)
        res_R = m.kf_R.at[:Np].set(res.R)
        res_t_s = res.t / jnp.clip(res.s, 1e-9, None)[:, None]
        # re-map landmarks through their reference keyframe's correction:
        # forward through the vertex's INITIAL Sim3 (vScw — the corrected
        # Sim3 for group members), back through the OPTIMIZED inverse
        # whose 1/s rescales depth (reference Optimizer.cc:1061-1080)
        ref = jnp.clip(m.lm_ref_kf, 0, Np - 1)
        Xc = sim3.transform(m.kf_R[ref], t_sim[ref], s_sim[ref], m.lm_pw)
        R_new = res_R[ref]
        t_new = m.kf_t.at[:Np].set(res.t)[ref]
        s_den = jnp.clip(jnp.ones(K).at[:Np].set(res.s)[ref],
                         1e-9, None)
        iRn, itn = se3.inverse(R_new, t_new)
        pw = se3.transform(iRn, itn, Xc) / s_den[:, None]
        lm_pw = jnp.where(m.lm_valid[:, None], pw, m.lm_pw)
        return m._replace(kf_R=res_R,
                          kf_t=m.kf_t.at[:Np].set(res_t_s),
                          lm_pw=lm_pw)

    def _build_gba_problem(self, m: MapState):
        """Global-BA problem over the LIVE prefix of the slot arrays
        (keyframes/landmarks are append-only + compacted, so rows >=
        n_kf / n_lm are empty) padded to a power of two — at dataset scale
        the full-capacity arrays would waste most of the work, and pow2
        bucketing bounds jit recompiles to O(log) over a run."""
        K, L = m.kf_R.shape[0], m.lm_pw.shape[0]
        n_kf = int(m.n_kf)
        n_lm = int(m.n_lm)
        Pp = K if n_kf > K // 2 else max(64, 1 << (max(n_kf - 1, 1)).bit_length())
        Lp = L if n_lm > L // 2 else max(1024, 1 << (max(n_lm - 1, 1)).bit_length())
        Pp, Lp = min(Pp, K), min(Lp, L)
        obs_kf = m.lm_obs_kf[:Lp]
        obs_valid = (obs_kf >= 0) & (obs_kf < Pp)
        kf_idx = jnp.clip(obs_kf, 0)
        feat_idx = m.lm_obs_feat[:Lp]
        uv = m.kf_xy[kf_idx, feat_idx]
        ur = m.kf_ur[kf_idx, feat_idx]
        uvr = jnp.concatenate([uv, ur[..., None]], axis=-1)
        octv = m.kf_octave[kf_idx, feat_idx]
        wgt = jnp.where(obs_valid & m.lm_valid[:Lp, None],
                        msearch.inv_sigma2_at(octv), 0.0)
        fixed = jnp.zeros(Pp, bool).at[0].set(True) | ~m.kf_valid[:Pp]
        # COPY the sliced map arrays: at Pp == K (or Lp == L) `x[:n]`
        # returns the live array itself, and the tracker's next donated
        # step deletes that buffer under the snapshot ("Array has been
        # deleted" on the second GBA chunk). Snapshot semantics require
        # the copy regardless (the live map evolves while GBA runs).
        cp = lambda a: jnp.array(a, copy=True)
        prob = ba.BAProblem(cp(m.kf_R[:Pp]), cp(m.kf_t[:Pp]),
                            cp(m.lm_pw[:Lp]),
                            kf_idx, uvr, wgt, fixed, cp(m.lm_valid[:Lp]))
        return prob, Pp, Lp

    def _start_gba(self, m: MapState):
        """Snapshot the GBA problem and bump the generation counter: a
        still-running older GBA is discarded here — the reference's
        mbStopGBA + mnFullBAIdx abort (LoopClosing.cc:518-530)."""
        prob, Pp, Lp = self._build_gba_problem(m)
        self.gba_generation += 1
        self._gba = {
            "prob": prob, "Pp": Pp, "Lp": Lp,
            # snapshot extents: slots beyond these at snapshot time were
            # EMPTY — anything living there when GBA finishes was born
            # during the run and must ride the chain correction, not be
            # overwritten with padding
            "n_kf": int(m.n_kf), "n_lm": int(m.n_lm),
            "left": self.gba_total_iters,
            "gen": self.gba_generation,
            # LM damping carried ACROSS chunks so the chunked GBA follows
            # the same damping schedule as one continuous 10-iteration run
            "lam": jnp.float32(1e-4),
        }

    def gba_running(self) -> bool:
        return self._gba is not None

    def poll_gba(self, m: MapState) -> MapState | None:
        """Advance the pending global BA by one bounded chunk (called once
        per frame by the tracker — SURVEY §2.5 P3/P6: interruption =
        'don't launch the next chunk'). Returns the reconciled map when
        the last chunk completes, else None."""
        g = self._gba
        if g is None:
            return None
        iters = min(self.gba_chunk_iters, g["left"])
        prob = g["prob"]
        if self.mesh is not None and g["Lp"] % self.mesh.devices.size == 0:
            # multi-device GBA: landmark shards + psum-reduced camera
            # system over the mesh (parallel.dist_ba — SURVEY §2.5 P7).
            # Fixed damping per chunk (the sharded engine favors fixed
            # schedules over per-iteration host sync).
            from ..parallel import dist_ba
            Rn, tn, Xn, _ = dist_ba.ba_solve_sharded(
                self.cam, prob, self.mesh, iters=iters,
                lam=float(g["lam"]), robust=True)
            g["prob"] = prob._replace(R=Rn, t=tn, X=Xn)
        elif g["Pp"] <= 64:
            res = ba.ba_solve(self.cam, prob, iters=iters, robust=True,
                              init_lambda=g["lam"])
            g["prob"] = prob._replace(R=res.R, t=res.t, X=res.X)
            g["lam"] = res.final_lambda
        else:
            res = ba.ba_solve_cg(self.cam, prob, iters=iters, robust=True,
                                 init_lambda=g["lam"])
            g["prob"] = prob._replace(R=res.R, t=res.t, X=res.X)
            g["lam"] = res.final_lambda
        g["left"] -= iters
        if g["left"] > 0:
            return None
        self._gba = None
        return self._apply_gba(m, g)

    def _apply_gba(self, m: MapState, g) -> MapState:
        """Reconcile a finished GBA snapshot into the CURRENT map
        (reference: RunGlobalBundleAdjustment write-back,
        LoopClosing.cc:823-889): snapshot keyframes take their GBA poses
        outright; keyframes inserted during the GBA are corrected through
        the temporal chain (child = rel-to-anchor o anchor_GBA — the
        reference walks the spanning tree); snapshot landmarks take their
        GBA positions, newer landmarks ride their reference keyframe's
        correction."""
        Pp, Lp = g["Pp"], g["Lp"]
        prob = g["prob"]
        K = m.kf_R.shape[0]
        n_kf_s, n_lm_s = g["n_kf"], g["n_lm"]
        # keyframes inserted during GBA: rel = T_cur(k) o T_cur(anchor)^-1,
        # T_new(k) = rel o T_gba(anchor), anchor = last snapshot keyframe
        anchor = max(n_kf_s - 1, 0)
        iRa, ita = se3.inverse(m.kf_R[anchor], m.kf_t[anchor])
        relR, relt = se3.compose(m.kf_R, m.kf_t, iRa, ita)  # [K,...]
        newR, newt = se3.compose(relR, relt,
                                 prob.R[anchor], prob.t[anchor])
        in_snap = jnp.arange(K) < n_kf_s
        kf_R_old, kf_t_old = m.kf_R, m.kf_t
        kf_R = jnp.where(in_snap[:, None, None],
                         m.kf_R.at[:Pp].set(prob.R), newR)
        kf_t = jnp.where(in_snap[:, None],
                         m.kf_t.at[:Pp].set(prob.t), newt)
        # landmarks born after the snapshot: correct via their reference
        # keyframe's old->new pose change (reference :852-889)
        L = m.lm_pw.shape[0]
        ref = jnp.clip(m.lm_ref_kf, 0, K - 1)
        Xc = se3.transform(kf_R_old[ref], kf_t_old[ref], m.lm_pw)
        iRn, itn = se3.inverse(kf_R[ref], kf_t[ref])
        pw_ride = se3.transform(iRn, itn, Xc)
        in_snap_lm = jnp.arange(L) < n_lm_s
        lm_pw = jnp.where(in_snap_lm[:, None],
                          m.lm_pw.at[:Lp].set(prob.X), pw_ride)
        lm_pw = jnp.where(m.lm_valid[:, None], lm_pw, m.lm_pw)
        return m._replace(kf_R=kf_R, kf_t=kf_t, lm_pw=lm_pw)

    def _global_ba(self, m: MapState, iters: int = 10) -> MapState:
        """Synchronous global BA: start + drain (the simple process() API;
        the tracker instead polls chunks across frames)."""
        self.gba_total_iters = iters
        self._start_gba(m)
        out = None
        while out is None:
            out = self.poll_gba(m)
        return out

    # -- entry ----------------------------------------------------------
    def process(self, m: MapState, kf: int) -> MapState:
        """Run detection -> Sim3 -> correction for a new keyframe."""
        cand = self.detect(m, kf)
        if cand is None:
            return m
        S12 = self.compute_sim3(m, kf, cand)
        if S12 is None:
            return m
        return self.correct(m, kf, cand, S12)

    # -- split entry: device submit now, host gating later ---------------
    def begin(self, m: MapState, kf: int):
        """Submit the detection device program and start the async
        device->host copy; returns an opaque handle for finish().

        Forcing detection results synchronously at keyframe insertion
        stalled the host on the whole device queue (keyframe maintenance
        was just enqueued); the reference's LoopClosing thread is
        likewise asynchronous to Tracking (LoopClosing.cc:57-90)."""
        if kf - self.last_loop_kf < self.min_gap:
            self.prev_groups = []
            return None
        W_dev, s_dev = self._detect_dev(m, self.db.bow_idx, self.db.bow_w,
                                     jnp.int32(kf))
        try:
            W_dev.copy_to_host_async()
            s_dev.copy_to_host_async()
        except Exception:
            pass
        return (kf, W_dev, s_dev)

    def finish(self, m: MapState, handle) -> MapState | None:
        """Complete a begin(): host-side gating + consistency; on a
        confirmed candidate runs Sim3 + correction. Returns the corrected
        map, or None when no loop closed."""
        if handle is None:
            return None
        kf, W_dev, s_dev = handle
        W = np.asarray(W_dev)
        s_all = np.asarray(s_dev)
        covis = np.where(W[kf] > 0)[0]
        min_score = max(float(min([s_all[int(j)] for j in covis],
                                  default=0.5)), 0.0)
        candidates = self.db.detect_loop_candidates(
            m, kf, min_score, covis=W, scores=s_all)
        cand = self._consistency(W, candidates)
        if cand is None:
            return None
        S12 = self.compute_sim3(m, kf, cand)
        if S12 is None:
            return None
        return self.correct(m, kf, cand, S12, sync_gba=False)

    def _consistency(self, W: np.ndarray, candidates: list[int]) -> int | None:
        """Covisibility-consistency over consecutive keyframes
        (reference: LoopClosing.cc:164-244, mnCovisibilityConsistencyTh=3)."""
        if not candidates:
            self.prev_groups = []
            return None
        new_groups: list[tuple[set[int], int]] = []
        enough: list[int] = []
        for c in candidates:
            group = {int(j) for j in np.where(W[c] > 0)[0]} | {c}
            count = 0
            for prev_set, prev_count in self.prev_groups:
                if group & prev_set:
                    count = max(count, prev_count + 1)
            new_groups.append((group, count))
            if count + 1 >= self.consistency_th:
                enough.append(c)
        self.prev_groups = new_groups
        return enough[0] if enough else None
