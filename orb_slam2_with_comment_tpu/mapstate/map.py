"""Versioned SoA map state — the fixed-shape Map/KeyFrame/MapPoint model.

Replaces the reference's pointer-graph map (reference: src/Map.cc,
src/KeyFrame.cc, src/MapPoint.cc) with fixed-capacity structure-of-arrays
device state (SURVEY.md §7 design stance 1):

  - keyframes: poses + full feature bundles, [K_max] slots with valid masks;
  - landmarks: positions, representative descriptors, normals/scale bands,
    found/visible statistics, [L_max] slots;
  - observations: landmark-major [L_max, D_max] (keyframe idx, feature idx)
    pairs — the same table drives Schur BA directly (optim.ba.BAProblem);
  - keyframe->landmark back-references [K_max, N_feat] for matching;
  - liveness is a mask update (replaces SetBadFlag pointer surgery),
    covisibility is recomputed from the observation table on demand
    (replaces KeyFrame::UpdateConnections cached adjacency).

The whole map is a pytree: tracking reads a version, mapping emits the next
one (SURVEY §2.5 P5 — no locks), and checkpointing is serialization of one
pytree (the reference's missing SaveMap/LoadMap, System.h:115-117, for free).
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np


class MapConfig(NamedTuple):
    k_max: int = 64  # keyframe capacity
    n_feat: int = 1000  # feature slots per keyframe
    l_max: int = 20000  # landmark capacity
    d_max: int = 12  # observation slots per landmark


class MapState(NamedTuple):
    # --- keyframes ---
    kf_R: jax.Array  # [K, 3, 3] world->camera
    kf_t: jax.Array  # [K, 3]
    kf_valid: jax.Array  # [K] bool
    kf_frame_id: jax.Array  # [K] int32 source frame id
    # keyframe feature bundles (copied from the frame at insertion,
    # reference: KeyFrame ctor KeyFrame.cc:31-57)
    kf_xy: jax.Array  # [K, N, 2] undistorted
    kf_ur: jax.Array  # [K, N] right-u or -1
    kf_depth: jax.Array  # [K, N] depth or -1
    kf_octave: jax.Array  # [K, N] int32
    kf_angle: jax.Array  # [K, N]
    kf_desc: jax.Array  # [K, N, 8] uint32
    kf_feat_valid: jax.Array  # [K, N] bool
    kf_lm: jax.Array  # [K, N] int32 landmark idx or -1
    # --- landmarks ---
    lm_pw: jax.Array  # [L, 3]
    lm_valid: jax.Array  # [L] bool
    lm_desc: jax.Array  # [L, 8] uint32 representative descriptor
    lm_normal: jax.Array  # [L, 3] mean viewing direction (camera->point)
    lm_dmin: jax.Array  # [L]
    lm_dmax: jax.Array  # [L]
    lm_visible: jax.Array  # [L] int32 (IncreaseVisible)
    lm_found: jax.Array  # [L] int32 (IncreaseFound)
    lm_first_kf: jax.Array  # [L] int32 creating keyframe
    lm_ref_kf: jax.Array  # [L] int32 reference keyframe
    # --- observations (landmark-major) ---
    lm_obs_kf: jax.Array  # [L, D] int32, -1 = empty slot
    lm_obs_feat: jax.Array  # [L, D] int32
    # --- counters ---
    n_kf: jax.Array  # [] int32 next free keyframe slot
    n_lm: jax.Array  # [] int32 next free landmark slot
    # observations silently dropped because a landmark's D slots were full
    # (the reference's observation map is unbounded, MapPoint.cc:98-109;
    # this counter measures what the fixed-D SoA design loses)
    n_obs_drop: jax.Array  # [] int32

    @property
    def config(self) -> MapConfig:
        return MapConfig(
            self.kf_R.shape[0], self.kf_xy.shape[1],
            self.lm_pw.shape[0], self.lm_obs_kf.shape[1],
        )


def empty_map(cfg: MapConfig) -> MapState:
    K, N, L, D = cfg.k_max, cfg.n_feat, cfg.l_max, cfg.d_max
    f32, i32 = jnp.float32, jnp.int32
    return MapState(
        kf_R=jnp.tile(jnp.eye(3, dtype=f32), (K, 1, 1)),
        kf_t=jnp.zeros((K, 3), f32),
        kf_valid=jnp.zeros(K, bool),
        kf_frame_id=jnp.full(K, -1, i32),
        kf_xy=jnp.zeros((K, N, 2), f32),
        kf_ur=jnp.full((K, N), -1.0, f32),
        kf_depth=jnp.full((K, N), -1.0, f32),
        kf_octave=jnp.zeros((K, N), i32),
        kf_angle=jnp.zeros((K, N), f32),
        kf_desc=jnp.zeros((K, N, 8), jnp.uint32),
        kf_feat_valid=jnp.zeros((K, N), bool),
        kf_lm=jnp.full((K, N), -1, i32),
        lm_pw=jnp.zeros((L, 3), f32),
        lm_valid=jnp.zeros(L, bool),
        lm_desc=jnp.zeros((L, 8), jnp.uint32),
        lm_normal=jnp.zeros((L, 3), f32),
        lm_dmin=jnp.full(L, 0.1, f32),
        lm_dmax=jnp.full(L, 100.0, f32),
        lm_visible=jnp.ones(L, i32),
        lm_found=jnp.ones(L, i32),
        lm_first_kf=jnp.full(L, -1, i32),
        lm_ref_kf=jnp.zeros(L, i32),
        lm_obs_kf=jnp.full((L, D), -1, i32),
        lm_obs_feat=jnp.zeros((L, D), i32),
        n_kf=jnp.int32(0),
        n_lm=jnp.int32(0),
        n_obs_drop=jnp.int32(0),
    )


def covisibility_weights(m: MapState, kf_idx) -> jax.Array:
    """Covisibility row of one keyframe: for every other keyframe, the count
    of shared landmarks. Exactly the reference's UpdateConnections
    iteration (KeyFrame.cc:295-393): walk the keyframe's OWN feature ->
    landmark list and accumulate those landmarks' observation rows — cost
    O(N*D) per row, independent of BOTH the landmark capacity L and the
    keyframe capacity K (the previous formulation scanned the whole [L, D]
    observation table per call; ADVICE r2 #4 / VERDICT r3 #7).

    Each (keyframe, landmark) pair counts once: a feature contributes only
    if it is the REGISTERED observation of its landmark (the slot in
    lm_obs_feat that points back at it) — duplicates from stale forward
    references and slot-dropped observations are excluded.

    Returns [K] int32 weights (self entry zeroed).
    """
    K = m.kf_R.shape[0]
    N = m.kf_lm.shape[1]
    lms = m.kf_lm[kf_idx]  # [N]
    safe = jnp.clip(lms, 0)
    ok = (lms >= 0) & m.kf_feat_valid[kf_idx] & m.lm_valid[safe]
    rows = m.lm_obs_kf[safe]  # [N, D]
    feat = m.lm_obs_feat[safe]  # [N, D]
    primary = jnp.any(
        (rows == kf_idx) & (feat == jnp.arange(N, dtype=jnp.int32)[:, None]),
        axis=1)
    contrib = ((ok & primary)[:, None] & (rows >= 0)).astype(jnp.int32)
    w = jnp.zeros(K, jnp.int32).at[jnp.clip(rows, 0)].add(contrib)
    w = jnp.where(jnp.arange(K) == kf_idx, 0, w)
    return w * m.kf_valid.astype(jnp.int32)


def observation_matrix(m: MapState) -> jax.Array:
    """[L, K] float32 incidence: landmark l observed by keyframe k,
    built by scatter (NOT by the [L, D, K] broadcast-compare, which
    explodes at dataset-scale capacities). Prefer covisibility_weights /
    covisibility_matrix; this is for small-map utilities only."""
    L, D = m.lm_obs_kf.shape
    K = m.kf_R.shape[0]
    rows = jnp.broadcast_to(jnp.arange(L, dtype=jnp.int32)[:, None], (L, D))
    vals = ((m.lm_obs_kf >= 0) & m.lm_valid[:, None]).astype(jnp.float32)
    return jnp.zeros((L, K), jnp.float32).at[
        rows, jnp.clip(m.lm_obs_kf, 0)].max(vals)


@jax.jit
def covisibility_matrix(m: MapState) -> jax.Array:
    """[K, K] covisibility weights (shared valid landmarks), built by the
    reference's own iteration shape (KeyFrame::UpdateConnections,
    KeyFrame.cc:295-393): every keyframe's feature -> landmark list
    gathers its landmarks' observation rows and scatter-counts observers.
    Cost O(K*N*D), INDEPENDENT of landmark capacity L (the previous
    chunked O^T-O formulation was O(L*K) work + an [L] scatter per call —
    dominant in per-keyframe loop detection at dataset scale, ADVICE r2
    #4 / VERDICT r3 #7). Per-pair dedup as in covisibility_weights: only
    a landmark's registered (back-referenced) feature contributes."""
    K = m.kf_R.shape[0]
    N = m.kf_lm.shape[1]
    lms = m.kf_lm  # [K, N]
    safe = jnp.clip(lms, 0)
    ok = (lms >= 0) & m.kf_feat_valid & m.lm_valid[safe]  # [K, N]
    rows = m.lm_obs_kf[safe]  # [K, N, D]
    feat = m.lm_obs_feat[safe]  # [K, N, D]
    kf_ids = jnp.arange(K, dtype=jnp.int32)
    primary = jnp.any(
        (rows == kf_ids[:, None, None])
        & (feat == jnp.arange(N, dtype=jnp.int32)[None, :, None]), axis=2)
    contrib = ((ok & primary)[:, :, None] & (rows >= 0)).astype(jnp.int32)
    src = jnp.broadcast_to(kf_ids[:, None, None], (K, N, rows.shape[2]))
    W = jnp.zeros((K, K), jnp.int32).at[src, jnp.clip(rows, 0)].add(contrib)
    W = W * (1 - jnp.eye(K, dtype=jnp.int32))
    kv = m.kf_valid.astype(jnp.int32)
    return W * kv[:, None] * kv[None, :]


def landmark_obs_count(m: MapState) -> jax.Array:
    """[L] number of observations per landmark."""
    return jnp.sum((m.lm_obs_kf >= 0).astype(jnp.int32), axis=1)


def add_observation(m: MapState, lm_idx, kf_idx, feat_idx, mask):
    """Vectorized AddObservation (reference: MapPoint.cc:98-109): append
    (kf, feat) to each landmark's first free slot; also sets the KF
    back-reference. All args [B]; mask disables slots. Full slots drop.
    """
    D = m.lm_obs_kf.shape[1]
    rows = m.lm_obs_kf[lm_idx]  # [B, D]
    n_used = jnp.sum((rows >= 0).astype(jnp.int32), axis=1)
    # Slots are append-only (free slots form a suffix), so intra-batch
    # duplicates of the same landmark get consecutive slots via their rank
    # within the batch (dense O(B^2) count in place of
    # sort+searchsorted+scatter; ops.prims).
    from ..ops.prims import rank_in_group
    rank = rank_in_group(lm_idx, mask)
    slot = n_used + rank
    ok = mask & (slot < D)
    slot = jnp.clip(slot, 0, D - 1)
    safe_lm = jnp.where(ok, lm_idx, 0)
    obs_kf = m.lm_obs_kf.at[safe_lm, slot].set(
        jnp.where(ok, kf_idx, m.lm_obs_kf[safe_lm, slot]))
    obs_feat = m.lm_obs_feat.at[safe_lm, slot].set(
        jnp.where(ok, feat_idx, m.lm_obs_feat[safe_lm, slot]))
    safe_kf = jnp.where(mask, kf_idx, 0)
    safe_ft = jnp.where(mask, feat_idx, 0)
    kf_lm = m.kf_lm.at[safe_kf, safe_ft].set(
        jnp.where(mask, lm_idx, m.kf_lm[safe_kf, safe_ft]))
    n_drop = m.n_obs_drop + jnp.sum((mask & ~ok).astype(jnp.int32))
    return m._replace(lm_obs_kf=obs_kf, lm_obs_feat=obs_feat, kf_lm=kf_lm,
                      n_obs_drop=n_drop)


def rebuild_observations(m: MapState) -> MapState:
    """Rebuild the landmark-major observation table from the keyframe
    back-references (kf_lm) — the canonical invariant-restoration pass used
    after landmark merges. Per landmark, up to D observations are kept in
    (keyframe, feature) order; entries pointing at invalid landmarks are
    cleared first. One observation per (landmark, keyframe) is kept.
    """
    K, N = m.kf_lm.shape
    L, D = m.lm_obs_kf.shape
    kf_lm = jnp.where(
        (m.kf_lm >= 0) & m.lm_valid[jnp.clip(m.kf_lm, 0)]
        & m.kf_feat_valid & m.kf_valid[:, None],
        m.kf_lm, -1)
    flat = jnp.where(kf_lm >= 0, kf_lm, L).reshape(-1)  # overflow id L
    kf_ids = (jnp.arange(K * N, dtype=jnp.int32) // N)
    feat_ids = (jnp.arange(K * N, dtype=jnp.int32) % N)
    # group by landmark; jnp.argsort is stable and the flattened order is
    # already (kf, feat)-lexicographic, so slot 0 becomes the earliest
    # observing keyframe (the reference-keyframe convention) without a
    # composite key (which could overflow int32 at large capacities)
    order = jnp.argsort(flat)
    slm = flat[order]
    skf = kf_ids[order]
    sft = feat_ids[order]
    from ..ops.prims import run_first_sorted
    first = run_first_sorted(slm)  # searchsorted(slm, slm) on sorted input
    rank = jnp.arange(K * N, dtype=jnp.int32) - first
    # drop duplicate (lm, kf) pairs: keep the first feature per keyframe
    same_kf_as_prev = (slm == jnp.roll(slm, 1)) & (skf == jnp.roll(skf, 1))
    same_kf_as_prev = same_kf_as_prev.at[0].set(False)
    ok = (slm < L) & (rank < D) & ~same_kf_as_prev
    tgt_lm = jnp.where(ok, slm, L - 1)
    tgt_slot = jnp.clip(rank, 0, D - 1)
    obs_kf = jnp.full((L, D), -1, jnp.int32).at[tgt_lm, tgt_slot].set(
        jnp.where(ok, skf, -1), mode="drop")
    obs_feat = jnp.zeros((L, D), jnp.int32).at[tgt_lm, tgt_slot].set(
        jnp.where(ok, sft, 0), mode="drop")
    # note: masked writes above may leave stale -1/-0 patterns where ok is
    # False but target collides; re-assert validity of slot contents
    n_drop = m.n_obs_drop + jnp.sum(
        ((slm < L) & ~same_kf_as_prev & (rank >= D)).astype(jnp.int32))
    return m._replace(kf_lm=kf_lm, lm_obs_kf=obs_kf, lm_obs_feat=obs_feat,
                      n_obs_drop=n_drop)


def merge_landmarks(m: MapState, keep: jax.Array, kill: jax.Array,
                    mask: jax.Array) -> MapState:
    """Merge landmarks: each kill[i] is replaced by keep[i] (reference:
    MapPoint::Replace, MapPoint.cc:177-217 + ORBmatcher::Fuse 1111-1114).
    Batched: builds a remap table, redirects keyframe back-references,
    invalidates the killed landmarks, merges found/visible statistics, and
    rebuilds the observation table.
    """
    L = m.lm_pw.shape[0]
    remap = jnp.arange(L, dtype=jnp.int32)
    safe_kill = jnp.where(mask, kill, L - 1)
    remap = remap.at[safe_kill].set(jnp.where(mask, keep, remap[safe_kill]))
    # one level of path compression (a->b, b->c chains within one batch)
    remap = remap[remap]
    kf_lm = jnp.where(m.kf_lm >= 0, remap[jnp.clip(m.kf_lm, 0)], -1)
    lm_valid = m.lm_valid.at[safe_kill].set(
        jnp.where(mask, False, m.lm_valid[safe_kill]))
    safe_keep = jnp.where(mask, keep, 0)
    found = m.lm_found.at[safe_keep].add(
        jnp.where(mask, m.lm_found[jnp.clip(kill, 0)], 0))
    visible = m.lm_visible.at[safe_keep].add(
        jnp.where(mask, m.lm_visible[jnp.clip(kill, 0)], 0))
    m = m._replace(kf_lm=kf_lm, lm_valid=lm_valid,
                   lm_found=found, lm_visible=visible)
    return rebuild_observations(m)


def landmark_compaction_order(lm_valid: jax.Array) -> jax.Array:
    """new->old permutation used by compact_landmarks (live rows first,
    stable). Exposed so a host epilogue can remap landmark-id arrays it
    holds outside the map (e.g. the last frame's feature->landmark list)."""
    return jnp.argsort(~lm_valid, stable=True).astype(jnp.int32)


def compact_keyframes(m: MapState) -> MapState:
    """Pack live keyframes to the front of the slot arrays and reset n_kf —
    the slot-recycling half of the keyframe lifecycle.

    The reference's map grows unbounded (Map.cc:32-44) and culled keyframes
    are deleted outright (KeyFrame::SetBadFlag); with fixed-capacity SoA
    state, culling is a kf_valid mask clear (cull_keyframes) and this pass
    reclaims the dead slots. The permutation is a stable sort on liveness,
    so live keyframes keep their relative (temporal) order — slot index
    differences remain a valid keyframe-age measure for landmark culling.

    Remaps: every observation-table keyframe index, landmark first/ref
    keyframe anchors (dead anchors collapse onto their live-rank, which
    preserves ordering), and the keyframe back-reference table rows.

    The HOST must mirror this permutation for everything it keys by slot:
    trajectory reference-keyframe ids, the BoW database rows, and archived
    poses of the evicted keyframes (pipeline.tracking owns that epilogue;
    the permutation is recomputable from kf_valid alone).
    """
    K = m.kf_R.shape[0]
    order = jnp.argsort(~m.kf_valid, stable=True).astype(jnp.int32)  # new->old
    # old->new for any old index: number of live slots strictly before it,
    # which equals the exact new slot for live rows and a consistent
    # order-preserving anchor for dead rows.
    live = m.kf_valid.astype(jnp.int32)
    rank = jnp.cumsum(live) - live  # exclusive prefix count of live rows
    n_live = jnp.sum(live)
    take = lambda a: a[order]
    remap_anchor = lambda a: jnp.clip(rank[jnp.clip(a, 0, K - 1)], 0,
                                      jnp.maximum(n_live - 1, 0))
    obs_alive = (m.lm_obs_kf >= 0) & m.kf_valid[jnp.clip(m.lm_obs_kf, 0)]
    new_obs_kf = jnp.where(obs_alive, rank[jnp.clip(m.lm_obs_kf, 0)], -1)
    # repack each observation row so valid entries form an in-order prefix
    # again (observations held by evicted keyframes leave holes, and
    # add_observation appends at the first free suffix slot)
    hole_order = jnp.argsort(new_obs_kf < 0, axis=1, stable=True)
    return m._replace(
        kf_R=take(m.kf_R), kf_t=take(m.kf_t), kf_valid=take(m.kf_valid),
        kf_frame_id=take(m.kf_frame_id), kf_xy=take(m.kf_xy),
        kf_ur=take(m.kf_ur), kf_depth=take(m.kf_depth),
        kf_octave=take(m.kf_octave), kf_angle=take(m.kf_angle),
        kf_desc=take(m.kf_desc), kf_feat_valid=take(m.kf_feat_valid),
        kf_lm=take(m.kf_lm),
        lm_obs_kf=jnp.take_along_axis(new_obs_kf, hole_order, axis=1),
        lm_obs_feat=jnp.take_along_axis(m.lm_obs_feat, hole_order, axis=1),
        lm_first_kf=remap_anchor(m.lm_first_kf),
        lm_ref_kf=remap_anchor(m.lm_ref_kf),
        n_kf=n_live,
    )


def grow_map(m: MapState, k_max: int | None = None,
             l_max: int | None = None) -> MapState:
    """Re-pad the map to larger keyframe / landmark capacity (host-side,
    between frames). The fixed-shape answer to the reference's unbounded
    pointer-graph map (Map.cc:32-44): geometric capacity doubling — each
    growth recompiles the jitted pipeline once for the new shapes, so a
    sequence of any length pays O(log K) recompiles total.

    Row invariants are preserved: new keyframe rows are invalid, new
    landmark rows are invalid with empty observation slots."""
    cfg = m.config
    K0, L0 = cfg.k_max, cfg.l_max
    K = int(k_max or K0)
    L = int(l_max or L0)
    if K < K0 or L < L0:
        raise ValueError("grow_map cannot shrink capacities")
    if K == K0 and L == L0:
        return m
    fresh = empty_map(MapConfig(K, cfg.n_feat, L, cfg.d_max))
    out = {}
    for name in MapState._fields:
        a = getattr(m, name)
        fa = getattr(fresh, name)
        if name in ("n_kf", "n_lm", "n_obs_drop"):
            out[name] = a
        else:
            out[name] = jax.lax.dynamic_update_slice(fa, a, (0,) * a.ndim)
    return MapState(**out)


def compact_landmarks(m: MapState) -> MapState:
    """Pack live landmarks to the front of the slot arrays and reset n_lm.

    Landmark slots are append-only (creation takes slot n_lm++; culling
    and merging only clear lm_valid), so a long sequence eventually
    exhausts l_max even when the live set is small. This pass permutes
    live rows to a contiguous prefix — a stable argsort on the liveness
    key keeps relative order, so the reference-observation convention
    (slot order inside each row) is untouched — remaps the keyframe
    back-references through the inverse permutation, and rewinds n_lm to
    the live count. The reference never needs this (pointer graph +
    delete), SURVEY §7.1 "culling = mask update + periodic compaction".

    Fully shape-stable: call under `lax.cond(n_lm > 0.85 * L, ...)` from
    keyframe maintenance.
    """
    L = m.lm_pw.shape[0]
    # stable sort: live rows first, preserving order
    order = landmark_compaction_order(m.lm_valid)  # new->old
    inv = jnp.zeros(L, jnp.int32).at[order].set(
        jnp.arange(L, dtype=jnp.int32))  # old->new
    take = lambda a: a[order]
    m = m._replace(
        lm_pw=take(m.lm_pw), lm_valid=take(m.lm_valid),
        lm_desc=take(m.lm_desc), lm_normal=take(m.lm_normal),
        lm_dmin=take(m.lm_dmin), lm_dmax=take(m.lm_dmax),
        lm_visible=take(m.lm_visible), lm_found=take(m.lm_found),
        lm_first_kf=take(m.lm_first_kf), lm_ref_kf=take(m.lm_ref_kf),
        lm_obs_kf=take(m.lm_obs_kf), lm_obs_feat=take(m.lm_obs_feat),
        kf_lm=jnp.where(m.kf_lm >= 0, inv[jnp.clip(m.kf_lm, 0)], -1),
        n_lm=jnp.sum(m.lm_valid.astype(jnp.int32)),
    )
    return m
