"""Autonomous on-device tracking: the zero-readback steady state.

The host-driven Tracker (pipeline.tracking) re-expresses the reference's
Tracking thread as a Python state machine over fused device steps; its
decisions (initialization gate, keyframe need, lost detection — reference:
Tracking.cc:287-581) consume a handful of scalar readbacks per frame, and
each readback makes the host wait for the device.

This module moves the ENTIRE per-frame state machine onto the device
instead, so the host never waits inside a sequence. All tracking state — the map, the previous frame bundle, pose,
velocity, reference keyframe, initialization/lost flags, and the
trajectory itself — lives in a single AutoState pytree that one jitted
step transforms per frame:

    state' = auto_step(state, img, depth)       # one dispatch, no readback

Decisions become lax.cond branches (initialize / track / freeze-when-lost)
and arithmetic on the in-step statistics vector (NeedNewKeyFrame,
reference: Tracking.cc:1140-1244). Keyframe maintenance (fuse /
triangulate via depth / cull / local BA — the reference's LocalMapping
thread) runs as a cond branch of the same program. Trajectory poses are
appended to on-device ring buffers and read back ONCE at finalize().

The reference's three threads + mutexes (SURVEY.md §2.5 P1/P5) become a
single functional stream: frames in, state evolves on device, trajectory
out at the end. The host does no per-frame work but feeding numpy frames
to the dispatcher, so a sequence of any length runs at device speed.

Reference semantics preserved (SURVEY.md §2.6): stereo-init >500 features
(Tracking.cc:586), keyframe decision rules c1a/c1b/c1c & c2 with
close-point accounting (Tracking.cc:1140-1244), lost when pose tracking
<10 inliers or local map <30 (Tracking.cc:916,1119), depth landmarks
close-or-100-nearest (Tracking.cc:1271-1324).

Loop closing runs on device too (pipeline.auto_loop): BoW detection with
covisibility-consistency, Sim3 RANSAC + refinement, Sim3 propagation,
essential-graph optimization and bounded global BA execute as conditional
branches of the keyframe step, against the packaged offline-trained
vocabulary (place.vocabulary.load_default_vocabulary). Relocalization too
(reference: Tracking.cc:1582-1778): while lost, each frame attempts BoW
candidate retrieval -> EPnP RANSAC -> pose optimization -> local-map
refill entirely on device, resuming tracking at >=50 inliers; frames
remain marked invalid until recovery, visible in finalize().
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp

from ..frontend import OrbExtractor
from ..geometry import se3
from ..mapstate.map import MapState, empty_map

# OSLAM_INIT_DEBUG=1 prints the monocular-bootstrap gate values via
# jax.debug.print (CPU diagnosis aid; not traced in when unset)
import os as _os
_INIT_DEBUG = bool(int(_os.environ.get("OSLAM_INIT_DEBUG", "0")))
from ..matching.search import FeatureSet
from .tracking import TrackerConfig
from . import auto_loop, steps


class AutoState(NamedTuple):
    """Everything the per-frame step reads and writes, device-resident."""
    map: MapState
    # previous frame bundle (FrameObs flattened: NamedTuple-in-NamedTuple
    # is fine for jax pytrees)
    prev: steps.FrameObs
    last_R: jax.Array  # [3,3]
    last_t: jax.Array  # [3]
    vel_R: jax.Array  # [3,3]
    vel_t: jax.Array  # [3]
    have_vel: jax.Array  # [] bool
    ref_kf: jax.Array  # [] int32
    last_kf_frame: jax.Array  # [] int32
    frame_idx: jax.Array  # [] int32 frames processed so far
    initialized: jax.Array  # [] bool
    lost: jax.Array  # [] int32 frame index where tracking was lost, -1 ok
    loop: auto_loop.LoopCarry  # on-device loop-closing state
    # monocular two-view bootstrap: frame index of the stored reference
    # frame (-1 = none; the reference bundle itself lives in `prev`)
    init_frame_id: jax.Array  # [] int32
    # amortized keyframe maintenance (the reference's LocalMapping thread,
    # LocalMapping.cc:47-128, re-expressed as bounded per-frame phases):
    # a freshly inserted keyframe only creates its depth landmarks in the
    # insert frame; fusion / triangulation / merging / refresh / culling /
    # local BA / loop closing run as ONE phase per subsequent frame, so no
    # single frame pays the whole maintenance chunk. A new keyframe
    # preempts an unfinished predecessor (reference: mbAbortBA,
    # LocalMapping.cc:134).
    maint_kf: jax.Array  # [] int32 keyframe under maintenance (-1 idle)
    maint_phase: jax.Array  # [] int32 next phase index
    maint_neighbors: jax.Array  # [10] int32 covis window (-1 padded)
    maint_lambda: jax.Array  # [] f32 local-BA damping carried across chunks
    # map-lifecycle counters (slot recycling events, for observability)
    n_compact_lm: jax.Array  # [] int32
    n_compact_kf: jax.Array  # [] int32
    # trajectory ring buffers [T, ...] (reference: mlRelativeFramePoses +
    # mlpReferences relative chain, Tracking.cc:562-579 — Rcr/tcr vs the
    # reference keyframe AS OF the frame, so later keyframe corrections
    # propagate into the saved trajectory)
    traj_R: jax.Array  # [T,3,3]
    traj_t: jax.Array  # [T,3]
    traj_Rcr: jax.Array  # [T,3,3]
    traj_tcr: jax.Array  # [T,3]
    traj_ref: jax.Array  # [T] int32 reference keyframe id
    traj_valid: jax.Array  # [T] bool
    traj_stats: jax.Array  # [T,8] int32 per-frame statistics


def _empty_prev(N: int) -> steps.FrameObs:
    f32, i32 = jnp.float32, jnp.int32
    return steps.FrameObs(
        FeatureSet(jnp.zeros((N, 2), f32), jnp.full((N,), -1.0, f32),
                   jnp.zeros((N,), i32), jnp.zeros((N,), f32),
                   jnp.zeros((N, 8), jnp.uint32), jnp.zeros((N,), bool)),
        jnp.full((N,), -1.0, f32), jnp.full((N,), -1, i32))


def empty_auto_state(cfg: TrackerConfig, traj_capacity: int,
                     bow_cap: int) -> AutoState:
    N = cfg.n_features
    T = traj_capacity
    f32, i32 = jnp.float32, jnp.int32
    prev = _empty_prev(N)
    return AutoState(
        loop=auto_loop.empty_loop_carry(cfg.map_cfg.k_max, bow_cap),
        map=empty_map(cfg.map_cfg),
        prev=prev,
        last_R=jnp.eye(3, dtype=f32), last_t=jnp.zeros(3, f32),
        vel_R=jnp.eye(3, dtype=f32), vel_t=jnp.zeros(3, f32),
        have_vel=jnp.asarray(False),
        ref_kf=jnp.int32(0), last_kf_frame=jnp.int32(-1),
        frame_idx=jnp.int32(0),
        initialized=jnp.asarray(False), lost=jnp.int32(-1),
        init_frame_id=jnp.int32(-1),
        maint_kf=jnp.int32(-1), maint_phase=jnp.int32(0),
        maint_neighbors=jnp.full((10,), -1, i32),
        maint_lambda=jnp.float32(1e-4),
        n_compact_lm=jnp.int32(0), n_compact_kf=jnp.int32(0),
        traj_R=jnp.tile(jnp.eye(3, dtype=f32), (T, 1, 1)),
        traj_t=jnp.zeros((T, 3), f32),
        traj_Rcr=jnp.tile(jnp.eye(3, dtype=f32), (T, 1, 1)),
        traj_tcr=jnp.zeros((T, 3), f32),
        traj_ref=jnp.full((T,), -1, i32),
        traj_valid=jnp.zeros((T,), bool),
        traj_stats=jnp.zeros((T, 8), i32),
    )


def build_auto_step(extractor: OrbExtractor, cfg: TrackerConfig,
                    traj_capacity: int, voc=None,
                    loop_closing: bool = True,
                    localization_only: bool = False):
    """One jitted program: AutoState x (img, raw depth) -> AutoState.

    ``voc``: a numpy-backed Vocabulary (embedded as trace constants) for
    the on-device loop closing; None or loop_closing=False disables the
    loop-closing branch (tracking + mapping only).
    ``localization_only``: track against the frozen map, never insert
    keyframes (reference: System::ActivateLocalizationMode ->
    mbOnlyTracking, Tracking.cc:222-235)."""
    width, height = cfg.width, cfg.height
    k_max = cfg.map_cfg.k_max
    fps = float(cfg.fps)
    min_init = int(cfg.min_init_features)
    T = traj_capacity
    cam = cfg.cam
    depth_factor = jnp.float32(cfg.depth_factor)
    th_depth = jnp.float32(cfg.depth_threshold)
    desc_th = jnp.int32(cfg.desc_th)
    desc_th_local = jnp.int32(cfg.desc_th_local)
    has_voc = voc is not None  # BoW bookkeeping + relocalization
    do_loops = loop_closing and has_voc

    def write_traj(s: AutoState, R, t, Rcr, tcr, ref, valid, stats8):
        i = jnp.mod(s.frame_idx, T)
        return s._replace(
            traj_R=s.traj_R.at[i].set(R),
            traj_t=s.traj_t.at[i].set(t),
            traj_Rcr=s.traj_Rcr.at[i].set(Rcr),
            traj_tcr=s.traj_tcr.at[i].set(tcr),
            traj_ref=s.traj_ref.at[i].set(ref),
            traj_valid=s.traj_valid.at[i].set(valid),
            traj_stats=s.traj_stats.at[i].set(stats8),
        )

    def do_initialize(s: AutoState, feats: FeatureSet, d) -> AutoState:
        """StereoInitialization (reference: Tracking.cc:584-636) under a
        validity gate computed on device: >500 valid features required."""
        n_valid = jnp.sum(feats.valid.astype(jnp.int32))
        ok = n_valid > min_init

        def init(s):
            obs = steps.FrameObs(feats, d, jnp.full(d.shape[0], -1, jnp.int32))
            R = jnp.eye(3, dtype=jnp.float32)
            t = jnp.zeros(3, jnp.float32)
            m = steps.insert_keyframe(s.map, cam, obs, R, t, s.frame_idx)
            m = steps.create_depth_landmarks(m, cam, jnp.int32(0),
                                             jnp.float32(1e9))
            loop = s.loop
            if has_voc:
                loop = auto_loop.add_keyframe_bow(
                    loop, voc, jnp.int32(0), m.kf_desc[0], m.kf_feat_valid[0])
            s = s._replace(
                map=m, loop=loop,
                prev=steps.FrameObs(feats, d, m.kf_lm[0]),
                last_R=R, last_t=t,
                have_vel=jnp.asarray(False),
                ref_kf=jnp.int32(0), last_kf_frame=s.frame_idx,
                initialized=jnp.asarray(True))
            stats8 = jnp.zeros(8, jnp.int32).at[6].set(1)  # flag: init frame
            return write_traj(s, R, t, R, t, jnp.int32(0),
                              jnp.asarray(True), stats8)

        return jax.lax.cond(ok, init, lambda s: s, s)

    # ---- amortized keyframe-maintenance phases (reference: the
    # LocalMapping thread's per-keyframe pipeline, LocalMapping.cc:47-128,
    # split into bounded chunks run one-per-frame after insertion) ----
    from ..mapstate.map import covisibility_weights
    from ..ops import prims as _prims

    def ph_fuse_in(m, loop, nbrs, lam, kf):
        """Covisibility window + inward fusion (SearchInNeighbors pass 1,
        reference LocalMapping.cc:589-633)."""
        w = covisibility_weights(m, kf)
        kk = min(10, k_max)
        top_w, top_i = _prims.sort_top_k(w, kk)
        nbrs = jnp.full((10,), -1, jnp.int32).at[:kk].set(
            jnp.where(top_w > 0, top_i.astype(jnp.int32), -1))
        m = steps.fuse_neighbors(m, cam, kf, nbrs[:5], width, height,
                                 into=True)
        return m, loop, nbrs, lam

    def ph_triangulate(m, loop, nbrs, lam, kf):
        """New-point triangulation against covisible neighbors (reference:
        CreateNewMapPoints LocalMapping.cc:290-577) — the monocular map's
        only landmark source."""
        m = steps.triangulate_with_neighbors(m, cam, kf, nbrs[:5])
        return m, loop, nbrs, lam

    def ph_fuse_out(m, loop, nbrs, lam, kf):
        m = steps.fuse_neighbors(m, cam, kf, nbrs[:5], width, height,
                                 into=False)
        return m, loop, nbrs, lam

    def ph_merge(m, loop, nbrs, lam, kf):
        m = steps.merge_duplicate_landmarks(m, kf)
        return m, loop, nbrs, lam

    def ph_refresh_cull(m, loop, nbrs, lam, kf):
        m = steps.refresh_landmarks_for_kf(m, kf)
        m = steps.cull_landmarks(m, kf)
        return m, loop, nbrs, lam

    def ph_ba1(m, loop, nbrs, lam, kf):
        """Local BA chunk 1 (3 robust iterations, reference: the 5-iter
        first stage of Optimizer.cc:689)."""
        def run(args):
            m, lam = args
            return steps.local_bundle_adjustment(
                m, cam, kf, iters_a=3, erase_outliers=False,
                with_lambda=True, init_lambda=jnp.float32(1e-4))
        m, lam = jax.lax.cond(jnp.any(nbrs >= 0), run,
                              lambda a: a, (m, lam))
        return m, loop, nbrs, lam

    def ph_ba2(m, loop, nbrs, lam, kf):
        """Local BA chunk 2 (resumed damping) + outlier erasure + keyframe
        culling (reference: Optimizer.cc:739-807 + KeyFrameCulling
        LocalMapping.cc:775-841)."""
        def run(args):
            m, lam = args
            return steps.local_bundle_adjustment(
                m, cam, kf, iters_a=2, erase_outliers=True,
                with_lambda=True, init_lambda=lam)
        m, lam = jax.lax.cond(jnp.any(nbrs >= 0), run,
                              lambda a: a, (m, lam))
        m = steps.cull_keyframes(m, kf, nbrs)
        return m, loop, nbrs, lam

    def ph_loop(m, loop, nbrs, lam, kf):
        """Loop closing for the maintained keyframe (reference:
        LocalMapping feeds LoopClosing, LocalMapping.cc:102); the BoW row
        was stored at insertion."""
        m, loop = auto_loop.close_loop_step(
            loop, m, cam, kf, voc, fix_scale=cfg.sensor != "mono",
            width=width, height=height, add_bow=False)
        return m, loop, nbrs, lam

    if cfg.sensor == "mono":
        # loop detection FIRST: monocular insertion may interrupt the
        # cycle (c1b relaxation below), and a tail-position loop phase
        # would be skipped for most keyframes — breaking the
        # 3-consecutive-keyframe consistency chains, which assume every
        # keyframe is processed (the reference's LoopClosing thread
        # dequeues EVERY keyframe immediately, in parallel with local
        # BA — detection-before-BA is its ordering too,
        # LoopClosing.cc:57-78)
        maint_phases = [ph_fuse_in, ph_triangulate, ph_fuse_out, ph_merge,
                        ph_refresh_cull, ph_ba1, ph_ba2]
        if do_loops:
            maint_phases = [ph_loop] + maint_phases
    else:
        maint_phases = [ph_fuse_in, ph_fuse_out, ph_merge,
                        ph_refresh_cull, ph_ba1, ph_ba2]
        if do_loops:
            maint_phases = maint_phases + [ph_loop]
    n_phases = len(maint_phases)

    def do_track(s: AutoState, feats: FeatureSet, d) -> AutoState:
        res = steps.track_frame_core(
            cam, s.map, s.prev, s.last_R, s.last_t, s.vel_R, s.vel_t,
            s.have_vel, s.ref_kf, feats, d, th_depth, desc_th,
            desc_th_local,
            jnp.where(s.map.n_kf > 2, jnp.int32(2), jnp.int32(1)),
            width, height)
        mm_in, used_mm, track1_in, local_in, ref_matches, close_pack = (
            res.stats[0], res.stats[1], res.stats[2], res.stats[3],
            res.stats[4], res.stats[5])
        now_lost = (track1_in < 10) | (local_in < 30)

        # NeedNewKeyFrame (reference: Tracking.cc:1140-1244) on device
        tracked_close = close_pack // 10000
        non_tracked_close = jnp.mod(close_pack, 10000)
        frames_since = s.frame_idx - s.last_kf_frame
        if cfg.sensor == "mono":
            # mono: no close-point rule, thRefRatio = 0.9 (Tracking.cc:1205)
            need_close = jnp.asarray(False)
            th_ref = jnp.float32(0.9)
        else:
            need_close = (tracked_close < 100) & (non_tracked_close > 70)
            th_ref = jnp.where(s.map.n_kf < 2, 0.4, 0.75)
        c1a = frames_since >= fps
        # c1b: mapping idle (reference: Tracking.cc:1173 consults
        # LocalMapping::AcceptKeyFrames) — with amortized maintenance the
        # faithful signal is "no keyframe currently under maintenance"
        c1b = s.maint_kf < 0
        if cfg.sensor == "mono":
            # Rotation-heavy monocular exploration cannot wait out the
            # amortized maintenance cycle: at ~1.4 deg/frame the tracked
            # set decays ~8 inliers/frame and a keyframe every ~8 frames
            # (one cycle) is too slow to replenish the map — measured
            # repeated mid-sweep tracking loss. The reference's mapping
            # thread is idle again within milliseconds and mono inserts
            # near-every-frame during fast motion (thRefRatio=0.9,
            # Tracking.cc:1205), interrupting a running local BA if
            # needed (InterruptBA, :1216-1232). Equivalent here: a
            # mid-cycle insertion (which restarts the cycle for the new
            # keyframe) is allowed once tracking has decayed below 70%
            # of the reference keyframe.
            c1b = c1b | (local_in < ref_matches * 0.7)
        c1c = (local_in < ref_matches * 0.25) | need_close
        c2 = (((local_in < ref_matches * th_ref) | need_close)
              & (local_in > 15))
        # capacity: live keyframes below k_max (dead slots are reclaimed by
        # the pre-insert compaction — the on-device map lifecycle)
        live_kf = jnp.sum(res.map.kf_valid.astype(jnp.int32))
        need_kf = ((c1a | c1b | c1c) & c2
                   & (live_kf < k_max) & ~now_lost)
        if localization_only:
            need_kf = jnp.asarray(False)
        L = res.map.lm_pw.shape[0]
        N = d.shape[0]

        def insert(args):
            """Keyframe insertion ONLY (reference: CreateNewKeyFrame
            Tracking.cc:1251-1336 runs on the tracking thread: pose copy +
            close-point landmark creation). Fusion / triangulation /
            culling / local BA / loop closing are amortized as one
            maintenance phase per following frame. Slot recycling runs
            here when capacity is tight (the reference's map is unbounded,
            Map.cc:32-44; the SoA equivalent is cull-mask + compaction)."""
            m, loop, lm = args

            def compact_lm(args):
                from ..mapstate.map import (compact_landmarks,
                                            landmark_compaction_order)
                m, lm = args
                old_valid = m.lm_valid
                order = landmark_compaction_order(old_valid)
                inv = jnp.zeros(L, jnp.int32).at[order].set(
                    jnp.arange(L, dtype=jnp.int32))
                ok = (lm >= 0) & old_valid[jnp.clip(lm, 0)]
                return (compact_landmarks(m),
                        jnp.where(ok, inv[jnp.clip(lm, 0)], -1))

            need_c_lm = m.n_lm + N > L
            m, lm = jax.lax.cond(need_c_lm, compact_lm, lambda a: a, (m, lm))

            def compact_kf(args):
                from ..mapstate.map import compact_keyframes
                m, loop, _ = args
                valid = m.kf_valid
                order = jnp.argsort(~valid, stable=True).astype(jnp.int32)
                live = valid.astype(jnp.int32)
                rank = jnp.cumsum(live) - live
                m = compact_keyframes(m)
                if has_voc:
                    loop = auto_loop.permute_loop_carry(
                        loop, order, rank, valid)
                # old->new slot map for every external holder of keyframe
                # slot ids (trajectory ref rows, ref_kf, maint_kf);
                # culled slots go to -1
                remap = jnp.where(valid, rank, jnp.int32(-1))
                return m, loop, remap

            need_c_kf = m.n_kf >= k_max
            kf_identity = jnp.arange(k_max, dtype=jnp.int32)
            m, loop, kf_remap = jax.lax.cond(
                need_c_kf, compact_kf, lambda a: a,
                (m, loop, kf_identity))
            kf = m.n_kf
            can = kf < k_max  # still full after compaction: refuse

            def do_ins(args):
                m, loop = args
                obs = steps.FrameObs(res.feats, res.depth, lm)
                m = steps.insert_keyframe(m, cam, obs, res.R, res.t,
                                          s.frame_idx)
                if cfg.sensor != "mono":
                    # close-point depth landmarks in the insert frame
                    # (reference: Tracking.cc:1271-1324 — ALSO on the
                    # tracking thread); mono landmarks come from
                    # triangulation
                    m = steps.create_depth_landmarks(m, cam, kf, th_depth)
                else:
                    # monocular landmark supply must not wait for the
                    # amortized maintenance cycle: the view advances
                    # ~2 px/frame PER DEGREE of sweep rate, and a
                    # triangulation that lands 2+ frames after insertion
                    # starves tracking mid-rotation (measured: inliers
                    # decay ~8/frame and the tracker dies ~30 frames into
                    # a 1.4 deg/frame sweep). The reference triangulates
                    # every keyframe synchronously in LocalMapping
                    # (CreateNewMapPoints, LocalMapping.cc:290-577);
                    # here the two temporal predecessors run at insert
                    # time and the full covisibility-neighbor pass still
                    # runs in the maintenance phase.
                    nb = jnp.stack([kf - 1, kf - 2])
                    nb = jnp.where((nb >= 0)
                                   & m.kf_valid[jnp.clip(nb, 0)], nb, -1)
                    m = steps.triangulate_with_neighbors(m, cam, kf, nb)
                if has_voc:
                    loop = auto_loop.add_keyframe_bow(
                        loop, voc, kf, m.kf_desc[kf], m.kf_feat_valid[kf])
                return m, loop

            m, loop = jax.lax.cond(can, do_ins, lambda a: a, (m, loop))
            new_kf = jnp.where(can, kf, jnp.int32(-1))
            lm_after = jnp.where(can, m.kf_lm[jnp.clip(kf, 0, k_max - 1)],
                                 lm)
            return (m, loop, new_kf, lm_after,
                    need_c_lm & can, need_c_kf & can, kf_remap)

        def no_insert(args):
            m, loop, lm = args
            return (m, loop, jnp.int32(-1), lm,
                    jnp.asarray(False), jnp.asarray(False),
                    jnp.arange(k_max, dtype=jnp.int32))

        (m2, loop2, new_kf, lm_after, did_c_lm, did_c_kf,
         kf_remap) = jax.lax.cond(
            need_kf, insert, no_insert, (res.map, s.loop, res.lm))
        inserted = new_kf >= 0
        # keyframe compaction renumbers slots: re-point every slot-id the
        # state holds outside the map (ADVICE r3: trajectory ref rows kept
        # pre-compaction ids, so Rcr/tcr + ref_kf recomposition was wrong
        # after a compaction). -1 entries (culled) fall back to slot 0.
        def _remap_slot(x):
            r = kf_remap[jnp.clip(x, 0, k_max - 1)]
            return jnp.where(x >= 0, jnp.maximum(r, 0), x)
        ref_kf_r = _remap_slot(s.ref_kf)
        maint_kf_r = jnp.where(
            s.maint_kf >= 0,
            kf_remap[jnp.clip(s.maint_kf, 0, k_max - 1)], s.maint_kf)
        traj_ref_r = _remap_slot(s.traj_ref)

        # --- one amortized maintenance phase (the LocalMapping thread's
        # per-keyframe work, spread over the frames after insertion) ---
        def run_phase(args):
            m, loop, nbrs, lam, phase, mkf = args
            m, loop, nbrs, lam = jax.lax.switch(
                jnp.clip(phase, 0, n_phases - 1), maint_phases,
                m, loop, nbrs, lam, mkf)
            nxt = phase + 1
            done = nxt >= n_phases
            return (m, loop, nbrs, lam, jnp.where(done, 0, nxt),
                    jnp.where(done, jnp.int32(-1), mkf))

        def keep_phase(args):
            return args

        nbrs_r = jnp.where(
            s.maint_neighbors >= 0,
            kf_remap[jnp.clip(s.maint_neighbors, 0, k_max - 1)],
            s.maint_neighbors)
        do_maint = (~now_lost) & (~inserted) & (maint_kf_r >= 0)
        m3, loop3, nbrs3, lam3, phase3, mkf3 = jax.lax.cond(
            do_maint, run_phase, keep_phase,
            (m2, loop2, nbrs_r, s.maint_lambda, s.maint_phase,
             maint_kf_r))
        # a fresh insert (re)starts maintenance — preempting an unfinished
        # predecessor (reference: mbAbortBA, LocalMapping.cc:134)
        maint_kf_n = jnp.where(inserted, new_kf, mkf3)
        maint_phase_n = jnp.where(inserted, 0, phase3)
        nbrs_n = jnp.where(inserted, jnp.full((10,), -1, jnp.int32), nbrs3)
        lam_n = jnp.where(inserted, jnp.float32(1e-4), lam3)

        ref_kf = jnp.where(inserted, new_kf, ref_kf_r)
        last_kf_frame = jnp.where(inserted, s.frame_idx, s.last_kf_frame)
        stats8 = jnp.concatenate([
            res.stats,
            jnp.stack([inserted.astype(jnp.int32),
                       loop3.n_loops.astype(jnp.int32)])])

        def apply_ok(s):
            # res.Rcr/tcr are relative to the PRE-insert reference keyframe
            # (remapped to its post-compaction slot: the relative pose is
            # unchanged, only the slot id moved)
            old_ref = ref_kf_r
            # a closed loop rewrites keyframe poses; loops fire in the
            # loop-closing maintenance phase of keyframe maint_kf, so the
            # current frame's pose is re-expressed through that keyframe's
            # pre/post-correction poses: T_cur' = (T_cur o T_mkf^-1) o
            # T_mkf' (reference: Tracking resumes from the corrected map
            # after CorrectLoop releases the mutex, Tracking.cc:301).
            # Velocity is reset — it related two pre-correction poses.
            loop_fired = loop3.n_loops > s.loop.n_loops
            anchor = jnp.clip(maint_kf_r, 0)
            relR, relt = se3.compose(
                res.R, res.t,
                *se3.inverse(m2.kf_R[anchor], m2.kf_t[anchor]))
            Rc, tc = se3.compose(relR, relt,
                                 m3.kf_R[anchor], m3.kf_t[anchor])
            R_new = jnp.where(loop_fired, Rc, res.R)
            t_new = jnp.where(loop_fired, tc, res.t)
            s = s._replace(
                map=m3, loop=loop3, traj_ref=traj_ref_r,
                prev=steps.FrameObs(res.feats, res.depth, lm_after),
                last_R=R_new, last_t=t_new,
                vel_R=res.vel_R, vel_t=res.vel_t,
                have_vel=jnp.asarray(~loop_fired),
                ref_kf=ref_kf, last_kf_frame=last_kf_frame,
                maint_kf=maint_kf_n, maint_phase=maint_phase_n,
                maint_neighbors=nbrs_n, maint_lambda=lam_n,
                n_compact_lm=s.n_compact_lm + did_c_lm.astype(jnp.int32),
                n_compact_kf=s.n_compact_kf + did_c_kf.astype(jnp.int32))
            return write_traj(s, R_new, t_new, res.Rcr, res.tcr, old_ref,
                              jnp.asarray(True), stats8)

        def apply_lost(s):
            # freeze: keep the map/pose; mark lost with this frame index
            # (reference drops frames until relocalization, Tracking.cc:528)
            s = s._replace(lost=s.frame_idx, have_vel=jnp.asarray(False))
            return write_traj(s, s.last_R, s.last_t, s.last_R, s.last_t,
                              s.ref_kf, jnp.asarray(False), stats8)

        return jax.lax.cond(now_lost, apply_lost, apply_ok, s)

    def do_initialize_mono(s: AutoState, feats, d) -> AutoState:
        """Monocular two-view bootstrap on device (reference:
        MonocularInitialization Tracking.cc:638-726 +
        CreateInitialMapMonocular :733-843): store a reference frame with
        >100 keypoints; on the next rich frame run windowed matching, the
        batched H/F RANSAC initializer, build the 2-keyframe map,
        full-BA it (20 iters) and fix the gauge to median scene depth 1."""
        from ..matching import search as ms
        from ..solvers import initializer as init_solver
        n_valid = jnp.sum(feats.valid.astype(jnp.int32))
        rich = n_valid > 100  # reference :644
        have_ref = s.init_frame_id >= 0
        obs = steps.FrameObs(feats, d, jnp.full(d.shape[0], -1, jnp.int32))

        def store_ref(s):
            # keep (or refresh) the reference bundle in `prev`
            return s._replace(prev=obs, init_frame_id=s.frame_idx)

        def clear_ref(s):
            return s._replace(init_frame_id=jnp.int32(-1))

        def try_init(s):
            ref = s.prev
            idx, dist, matched = ms.search_for_initialization(
                ref.feats, feats, ref.feats.xy)
            n_match = jnp.sum(matched.astype(jnp.int32))
            key, sub = jax.random.split(s.loop.key)
            s = s._replace(loop=s.loop._replace(key=key))
            p2 = feats.xy[jnp.clip(idx, 0)]
            res = init_solver.initialize(
                sub, (cam.fx, cam.fy, cam.cx, cam.cy),
                ref.feats.xy, p2, matched)
            enough = n_match >= cfg.min_init_matches  # reference :687
            ok1 = enough & res.success
            if _INIT_DEBUG:
                jax.debug.print(
                    "[initdbg] frame={f} ref={r} n_valid={nv} n_match={nm}"
                    " success={su} n_good={ng}", f=s.frame_idx,
                    r=s.init_frame_id, nv=n_valid, nm=n_match,
                    su=res.success,
                    ng=jnp.sum((res.good & matched).astype(jnp.int32)))

            def build(s):
                R0, t0 = jnp.eye(3), jnp.zeros(3)
                m = steps.insert_keyframe(s.map, cam, ref, R0, t0,
                                          s.init_frame_id)
                m = steps.insert_keyframe(m, cam, obs, res.R, res.t,
                                          s.frame_idx)
                m = steps.insert_landmarks_two_view(
                    m, cam, jnp.int32(0), jnp.int32(1), idx, res.X,
                    res.good & matched)
                m = steps.refresh_landmarks(m)
                m = steps.local_bundle_adjustment(
                    m, cam, jnp.int32(1), iters_a=20)  # reference :787
                med = steps.scene_median_depth(m, jnp.int32(0))
                n_tracked = jnp.sum((m.kf_lm[1] >= 0).astype(jnp.int32))
                ok2 = (jnp.isfinite(med) & (med > 0)
                       & (n_tracked >= cfg.min_init_matches))

                def accept(s):
                    mm = steps.scale_map(m, 1.0 / med)
                    loop = s.loop
                    if has_voc:
                        loop = auto_loop.add_keyframe_bow(
                            loop, voc, jnp.int32(0), mm.kf_desc[0],
                            mm.kf_feat_valid[0])
                        loop = auto_loop.add_keyframe_bow(
                            loop, voc, jnp.int32(1), mm.kf_desc[1],
                            mm.kf_feat_valid[1])
                    s = s._replace(
                        map=mm, loop=loop,
                        prev=obs._replace(lm=mm.kf_lm[1]),
                        last_R=mm.kf_R[1], last_t=mm.kf_t[1],
                        have_vel=jnp.asarray(False),
                        ref_kf=jnp.int32(1), last_kf_frame=s.frame_idx,
                        initialized=jnp.asarray(True),
                        init_frame_id=jnp.int32(-1))
                    stats8 = jnp.zeros(8, jnp.int32).at[6].set(1)
                    return write_traj(s, mm.kf_R[1], mm.kf_t[1],
                                      jnp.eye(3), jnp.zeros(3),
                                      jnp.int32(1), jnp.asarray(True),
                                      stats8)

                def reject(s):
                    # failed bootstrap: wipe + restart (reference :793-799)
                    return s._replace(map=empty_map(cfg.map_cfg),
                                      init_frame_id=jnp.int32(-1))

                return jax.lax.cond(ok2, accept, reject, s)

            def no_build(s):
                # too few matches -> drop the reference frame (ref :687);
                # solver failure with enough matches -> keep it and retry
                return jax.lax.cond(enough, lambda s: s, clear_ref, s)

            return jax.lax.cond(ok1, build, no_build, s)

        def when_rich(s):
            return jax.lax.cond(have_ref, try_init, store_ref, s)

        return jax.lax.cond(rich, when_rich, clear_ref, s)

    def do_relocalize(s: AutoState, feats, d) -> AutoState:
        """On-device Relocalization (reference: Tracking.cc:1582-1778):
        BoW candidate keyframe -> descriptor matching -> EPnP RANSAC ->
        pose-only optimization -> local-map projection refill; accept at
        >=50 inliers (reference :1752). One candidate is attempted per
        lost frame, ROUND-ROBIN over the top-5 scoring keyframes across
        consecutive frames (the reference iterates 5 candidates inside one
        frame, Tracking.cc:1645-1713; spreading the same candidate set
        over frames keeps the per-frame program single-candidate while
        recovering recall in kidnap scenarios with similar views)."""
        from ..ops import prims as _prims
        from ..place import vocabulary as V
        from ..solvers import pnp
        m = s.map
        K = m.kf_R.shape[0]
        words = V.transform(voc, feats.desc, feats.valid)
        q_idx, q_w = V.bow_sparse(voc, words, feats.valid,
                                  s.loop.bow_idx.shape[1])
        scr = V.score_l1_sparse(q_idx, q_w, s.loop.bow_idx, s.loop.bow_w,
                                int(voc.n_words))
        ids = jnp.arange(K, dtype=jnp.int32)
        live = m.kf_valid & (ids < m.n_kf)
        scr = jnp.where(live, scr, -1.0)
        top_s, top_i = _prims.sort_top_k(scr, 5)
        n_cand = jnp.sum((top_s > 0).astype(jnp.int32))
        pick = jnp.mod(s.frame_idx - jnp.maximum(s.lost, 0),
                       jnp.clip(n_cand, 1, None))
        cand = top_i[pick].astype(jnp.int32)
        has_cand = top_s[pick] > 0
        kf_lm = m.kf_lm[cand]
        kf_has = ((kf_lm >= 0) & m.kf_feat_valid[cand]
                  & m.lm_valid[jnp.clip(kf_lm, 0)])
        from ..matching import search as ms
        idx, dist, matched = ms.search_brute(
            m.kf_desc[cand], feats.desc, kf_has, feats.valid, ratio=0.75,
            angle_q=m.kf_angle[cand], angle_t=feats.angle)
        n_m = jnp.sum(matched.astype(jnp.int32))
        N = feats.xy.shape[0]
        frame_lm = jnp.full(N, -1, jnp.int32)
        safe = jnp.where(matched, idx, 0)
        frame_lm = frame_lm.at[safe].set(jnp.where(matched, kf_lm, -1))
        has = (frame_lm >= 0) & feats.valid
        Xw = m.lm_pw[jnp.clip(frame_lm, 0)]
        key, sub = jax.random.split(s.loop.key)
        res = pnp.solve_ransac(
            sub, (cam.fx, cam.fy, cam.cx, cam.cy), Xw, feats.xy,
            ms.sigma2_at(feats.octave), has, max_iters=300)
        tr = steps._pose_optimize_from_matches(
            cam, m, feats, frame_lm, res.R, res.t)
        # escalating projection refill (reference th=10, :1716-1752)
        local_mask = steps.local_landmark_mask(m, cand)
        res2, m2 = steps.track_local_map(
            cam, m, feats, tr.lm, tr.R, tr.t, local_mask,
            jnp.float32(10.0), width, height, desc_th)

        # escalation round 2 (reference Tracking.cc:1727-1747): when the
        # refill lands in (30, 50) inliers (strict, nGood>30&&nGood<50),
        # search again in a NARROWER window (th=3) with a stricter
        # descriptor gate (ORBdist=64) and re-optimize — host parity
        # (tracking.py _relocalize round 2)
        def escalate(_):
            return steps.track_local_map(
                cam, m2, feats, res2.lm, res2.R, res2.t, local_mask,
                jnp.float32(3.0), width, height, jnp.int32(64))

        res2, m2 = jax.lax.cond(
            (res2.n_inliers > 30) & (res2.n_inliers < 50),
            escalate, lambda _: (res2, m2), None)
        ok = (has_cand & (n_m >= 15) & (res.n_inliers >= 10)
              & (tr.n_inliers >= 10) & (res2.n_inliers >= 50))
        s = s._replace(loop=s.loop._replace(key=key))

        def resume(s):
            stats8 = (jnp.zeros(8, jnp.int32)
                      .at[2].set(tr.n_inliers).at[3].set(res2.n_inliers)
                      .at[6].set(2)  # 2 = relocalized this frame
                      .at[7].set(s.loop.n_loops))
            s = s._replace(
                map=m2,
                prev=steps.FrameObs(feats, d, res2.lm),
                last_R=res2.R, last_t=res2.t,
                have_vel=jnp.asarray(False),
                ref_kf=cand, lost=jnp.int32(-1))
            Rcr, tcr = se3.compose(
                res2.R, res2.t, *se3.inverse(m2.kf_R[cand], m2.kf_t[cand]))
            return write_traj(s, res2.R, res2.t, Rcr, tcr, cand,
                              jnp.asarray(True), stats8)

        def stay_lost(s):
            return write_traj(s, s.last_R, s.last_t, s.last_R, s.last_t,
                              s.ref_kf, jnp.asarray(False),
                              jnp.zeros(8, jnp.int32))

        return jax.lax.cond(ok, resume, stay_lost, s)

    def do_reset(s: AutoState) -> AutoState:
        """Full tracker reset when lost with an immature map (reference:
        Tracking.cc:542-551 — lost with <=5 keyframes resets the whole
        system; the map was never good). Trajectory rings are kept —
        their rows are already marked invalid — and re-initialization
        starts on the next frame."""
        k_max_, bow_cap_ = s.loop.bow_idx.shape
        s = s._replace(
            map=empty_map(cfg.map_cfg),
            loop=auto_loop.empty_loop_carry(
                k_max_, bow_cap_)._replace(key=s.loop.key),
            prev=_empty_prev(cfg.n_features),
            last_R=jnp.eye(3, dtype=jnp.float32),
            last_t=jnp.zeros(3, jnp.float32),
            have_vel=jnp.asarray(False),
            ref_kf=jnp.int32(0), last_kf_frame=jnp.int32(-1),
            initialized=jnp.asarray(False), lost=jnp.int32(-1),
            init_frame_id=jnp.int32(-1),
            maint_kf=jnp.int32(-1), maint_phase=jnp.int32(0),
            maint_neighbors=jnp.full((10,), -1, jnp.int32),
            maint_lambda=jnp.float32(1e-4))
        return write_traj(s, s.last_R, s.last_t, s.last_R, s.last_t,
                          jnp.int32(0), jnp.asarray(False),
                          jnp.zeros(8, jnp.int32).at[6].set(3))  # 3 = reset

    def run_frame(s: AutoState, feats, d) -> AutoState:
        init_fn = (do_initialize_mono if cfg.sensor == "mono"
                   else do_initialize)

        def when_alive(s):
            return jax.lax.cond(
                s.initialized,
                lambda s: do_track(s, feats, d),
                lambda s: init_fn(s, feats, d), s)

        if has_voc:
            def try_reloc(s):
                return do_relocalize(s, feats, d)
        else:
            def try_reloc(s):
                # frames keep streaming; poses invalid
                return write_traj(s, s.last_R, s.last_t, s.last_R, s.last_t,
                                  s.ref_kf, jnp.asarray(False),
                                  jnp.zeros(8, jnp.int32))

        def when_lost(s):
            # lost-early reset (reference: Tracking.cc:542-551)
            if localization_only:
                return try_reloc(s)
            return jax.lax.cond(s.map.n_kf <= 5, do_reset, try_reloc, s)

        s = jax.lax.cond(s.lost >= 0, when_lost, when_alive, s)
        return s._replace(frame_idx=s.frame_idx + 1)

    @partial(jax.jit, donate_argnums=(0,))
    def auto_step(s: AutoState, img, depth_raw) -> AutoState:
        feats, d = steps.extract_rgbd_features(
            extractor, cam, img, depth_raw, depth_factor, width, height)
        return run_frame(s, feats, d)

    @partial(jax.jit, donate_argnums=(0,))
    def auto_step_stereo(s: AutoState, img_l, img_r) -> AutoState:
        """Stereo variant: joint L/R extraction + row-band depth
        association (reference: Frame stereo ctor Frame.cc:61-117 +
        ComputeStereoMatches Frame.cc:501-675) feeding the same on-device
        state machine."""
        feats_l, sd = extractor._extract_stereo(
            img_l.astype(jnp.float32), img_r.astype(jnp.float32),
            cam.bf, cam.fx)
        feats = FeatureSet(feats_l.xy, sd.u_right, feats_l.octave,
                           feats_l.angle, feats_l.desc, feats_l.valid)
        return run_frame(s, feats, sd.depth)

    @partial(jax.jit, donate_argnums=(0,))
    def auto_step_rgbd_batch(s: AutoState, imgs, depths) -> AutoState:
        """B frames per dispatch via lax.scan: amortizes the per-dispatch
        launch and transfer cost at the price of B frames of pipeline
        latency (whether a GPU needs this is not measured yet). The scan
        body is the full per-frame program — keyframe/loop conds stay
        real branches."""
        def body(s, fr):
            img, depth = fr
            feats, d = steps.extract_rgbd_features(
                extractor, cam, img, depth, depth_factor, width, height)
            return run_frame(s, feats, d), None

        s, _ = jax.lax.scan(body, s, (imgs, depths))
        return s

    @partial(jax.jit, donate_argnums=(0,))
    def auto_step_mono(s: AutoState, img) -> AutoState:
        """Monocular variant: no depth channel; the map's only landmark
        sources are the two-view bootstrap and keyframe triangulation
        (reference: GrabImageMonocular Tracking.cc:239)."""
        feats_raw = extractor._extract(img.astype(jnp.float32))
        N = feats_raw.xy.shape[0]
        feats = FeatureSet(feats_raw.xy, jnp.full((N,), -1.0, jnp.float32),
                           feats_raw.octave, feats_raw.angle,
                           feats_raw.desc, feats_raw.valid)
        return run_frame(s, feats, jnp.full((N,), -1.0, jnp.float32))

    auto_step.stereo = auto_step_stereo
    auto_step.mono = auto_step_mono
    auto_step.rgbd_batch = auto_step_rgbd_batch
    return auto_step


@dataclass
class AutoTrackerConfig:
    """Extra knobs of the autonomous mode."""
    traj_capacity: int = 4096  # trajectory ring size (frames)
    loop_closing: bool = True  # on-device loop closing (auto_loop)
    # track-only against the frozen map, never insert keyframes
    # (reference: System::ActivateLocalizationMode, Tracking.cc:222-235);
    # combine with checkpoint.load_auto_state for map-based localization
    localization_only: bool = False
    # frames per device dispatch (RGB-D): >1 scans several frames inside
    # one program, amortizing per-dispatch launch and transfer cost for B
    # frames of added pipeline latency. 1 = dispatch per frame (lowest
    # latency).
    batch_frames: int = 1


# Per-process cache of built (extractor, vocabulary, jitted step) keyed by
# the full configuration. A jax.jit program is stateless — all tracker
# state is in the AutoState argument — so trackers with identical configs
# share ONE traced program. Without this, every AutoTracker construction
# re-traced the ~45 MB auto_step graph (~10 s of host time) before its
# first frame — which is pure overhead in any fresh-tracker timing (and
# the dominant term in a from-scratch map-building measurement).
_STEP_CACHE: dict = {}


def _cached_step(cfg: TrackerConfig, auto_cfg: "AutoTrackerConfig"):
    key = (repr(cfg), auto_cfg.traj_capacity, auto_cfg.loop_closing,
           auto_cfg.localization_only)
    hit = _STEP_CACHE.get(key)
    if hit is not None:
        return hit
    extractor = OrbExtractor(n_features=cfg.n_features)
    voc = None
    if auto_cfg.loop_closing:
        from ..place.vocabulary import load_default_vocabulary
        voc = load_default_vocabulary(as_numpy=True)
    step = build_auto_step(
        extractor, cfg, auto_cfg.traj_capacity, voc=voc,
        loop_closing=auto_cfg.loop_closing,
        localization_only=auto_cfg.localization_only)
    _STEP_CACHE[key] = (extractor, voc, step)
    return _STEP_CACHE[key]


class AutoTracker:
    """RGB-D tracker whose per-frame state machine runs on device.

    Usage:
        tr = AutoTracker(cfg)
        for img, depth in frames:        # numpy uint8 [H,W], uint16 [H,W]
            tr.process_rgbd(img, depth)  # one async dispatch, NO readback
        result = tr.finalize()           # single readback at the end

    process_rgbd returns nothing: the dispatch is asynchronous and the
    host never waits for the device (module docstring). Use the
    host-driven Tracker when per-frame poses must be consumed online
    (e.g. the AR demo).
    """

    def __init__(self, cfg: TrackerConfig,
                 auto_cfg: AutoTrackerConfig | None = None):
        if cfg.map_cfg.n_feat != cfg.n_features:
            raise ValueError("map_cfg.n_feat must equal n_features")
        self.cfg = cfg
        self.auto_cfg = auto_cfg or AutoTrackerConfig()
        # extractor + numpy-backed vocabulary (embedded as trace-time
        # constants) + the jitted step, all shared across same-config
        # trackers via the per-process cache
        self.extractor, voc, self._step = _cached_step(cfg, self.auto_cfg)
        self.voc = voc
        # sparse BoW row capacity: lossless at n_features distinct words
        self.state = empty_auto_state(
            cfg, self.auto_cfg.traj_capacity, cfg.n_features)
        self.frame_count = 0
        self.timestamps: list[float] = []
        self._batch_buf: list = []

    def process_rgbd(self, img, depth, timestamp: float | None = None):
        """Track one frame: one device dispatch, zero synchronization.
        With auto_cfg.batch_frames > 1, frames are buffered host-side and
        dispatched batch_frames at a time through one scanned program."""
        self.timestamps.append(
            self.frame_count / self.cfg.fps if timestamp is None
            else timestamp)
        self.frame_count += 1
        B = self.auto_cfg.batch_frames
        if B <= 1:
            self.state = self._step(self.state, img, depth)
            return
        self._batch_buf.append((np.asarray(img), np.asarray(depth)))
        if len(self._batch_buf) >= B:
            imgs = np.stack([f[0] for f in self._batch_buf])
            depths = np.stack([f[1] for f in self._batch_buf])
            self._batch_buf = []
            self.state = self._step.rgbd_batch(self.state, imgs, depths)

    def drain(self):
        """Dispatch any buffered partial batch (single-frame steps)."""
        for img, depth in self._batch_buf:
            self.state = self._step(self.state, img, depth)
        self._batch_buf = []

    def process_stereo(self, img_left, img_right,
                       timestamp: float | None = None):
        """Track one rectified stereo pair (reference: System::TrackStereo
        System.cc:169): one device dispatch, zero synchronization."""
        self.state = self._step.stereo(self.state, img_left, img_right)
        self.timestamps.append(
            self.frame_count / self.cfg.fps if timestamp is None
            else timestamp)
        self.frame_count += 1

    def process_mono(self, img, timestamp: float | None = None):
        """Track one monocular frame (reference: System::TrackMonocular
        System.cc:224): one device dispatch, zero synchronization. Scale
        is the monocular gauge (median initial scene depth = 1)."""
        self.state = self._step.mono(self.state, img)
        self.timestamps.append(
            self.frame_count / self.cfg.fps if timestamp is None
            else timestamp)
        self.frame_count += 1

    def sync(self):
        """Dispatch any buffered frames and wait for the device to drain
        (no data readback)."""
        self.drain()
        jax.block_until_ready(self.state.frame_idx)

    def finalize(self) -> dict:
        """ONE device->host readback of the whole run: trajectory ring
        buffers, flags, and per-frame statistics, unrolled to frame order.
        """
        self.drain()
        s = self.state
        T = self.auto_cfg.traj_capacity
        n = self.frame_count
        host = jax.device_get(
            (s.traj_R, s.traj_t, s.traj_Rcr, s.traj_tcr, s.traj_ref,
             s.traj_valid, s.traj_stats, s.lost, s.initialized, s.map.n_kf,
             s.loop.n_loops, s.map.n_obs_drop, s.n_compact_kf,
             s.n_compact_lm))
        (R, t, Rcr, tcr, ref, valid, stats, lost, initialized, n_kf,
         n_loops, n_obs_drop, n_compact_kf, n_compact_lm) = host
        if n <= T:
            order = np.arange(n)
        else:  # ring wrapped: oldest surviving frame first
            order = np.arange(n - T, n) % T
        return {
            "R": R[order % T], "t": t[order % T],
            "Rcr": Rcr[order % T], "tcr": tcr[order % T],
            "ref_kf": ref[order % T], "valid": valid[order % T],
            "stats": stats[order % T],
            "timestamps": np.asarray(self.timestamps[-len(order):]),
            "lost_at": int(lost), "initialized": bool(initialized),
            "n_keyframes": int(n_kf), "n_frames": n,
            "n_loops_closed": int(n_loops),
            # observation-slot saturation (reference MapPoint.cc:98-109 is
            # unbounded; this counts what fixed D slots dropped)
            "n_obs_dropped": int(n_obs_drop),
            # on-device lifecycle events (slot-recycling compactions)
            "n_compact_kf": int(n_compact_kf),
            "n_compact_lm": int(n_compact_lm),
        }

    def trajectory_kitti(self) -> list[str]:
        """KITTI-format lines (row-major camera->world 3x4 per frame),
        like the reference's SaveTrajectoryKITTI (System.cc:436-486)."""
        out = self.finalize()
        lines = []
        for i in range(len(out["timestamps"])):
            if not out["valid"][i]:
                continue
            R = out["R"][i]
            t = out["t"][i]
            Rwc = R.T
            twc = -R.T @ t
            P = np.hstack([Rwc, twc[:, None]]).reshape(-1)
            lines.append(" ".join(f"{v:.9e}" for v in P))
        return lines

    def trajectory_tum(self) -> list[str]:
        """TUM-format lines (timestamp tx ty tz qx qy qz qw), camera->world
        like the reference's SaveTrajectoryTUM (System.cc:336-394)."""
        from ..geometry import se3 as geo_se3
        out = self.finalize()
        lines = []
        for i in range(len(out["timestamps"])):
            if not out["valid"][i]:
                continue
            R = out["R"][i]
            t = out["t"][i]
            Rwc = R.T
            twc = -R.T @ t
            qw, qx, qy, qz = np.asarray(
                geo_se3.matrix_to_quat(jnp.asarray(Rwc)))
            ts = out["timestamps"][i]
            lines.append(f"{ts:.6f} {twc[0]:.7f} {twc[1]:.7f} {twc[2]:.7f} "
                         f"{qx:.7f} {qy:.7f} {qz:.7f} {qw:.7f}")
        return lines
