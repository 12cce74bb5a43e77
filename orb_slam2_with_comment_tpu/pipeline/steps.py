"""Jitted device steps for the tracking / mapping pipeline.

Each function is a pure MapState -> MapState (or measurement) transform with
static shapes, jitted once per capacity configuration. The host state
machine (pipeline.tracking) sequences them — the JAX replacement for
the reference's three pthreads + mutexes (SURVEY.md §2.5).

Reference call sites are noted per function.
"""
from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..geometry import se3
from ..mapstate.map import MapState, add_observation, landmark_obs_count
from ..ops import prims
from ..matching import search as msearch
from ..matching.search import (FeatureSet, LandmarkSet, inv_sigma2_at,
                               scale_at)
from ..optim import ba, pose_opt
from ..optim.residuals import CamParams

N_LEVELS = 8
SCALE = 1.2
SCALE_FACTORS = msearch.SCALE_FACTORS
INV_SIGMA2 = msearch.INV_SIGMA2


class FrameObs(NamedTuple):
    """Per-frame observation bundle used by tracking steps."""
    feats: FeatureSet  # undistorted coords
    depth: jax.Array  # [N] depth (RGB-D/stereo) or -1
    lm: jax.Array  # [N] int32 matched landmark or -1


def landmark_set(m: MapState) -> LandmarkSet:
    return LandmarkSet(m.lm_pw, m.lm_normal, m.lm_dmin, m.lm_dmax,
                       m.lm_desc, m.lm_valid)


@jax.jit
def make_feature_uvr(u: jax.Array, depth: jax.Array, bf) -> jax.Array:
    """mvuRight from depth (reference: Frame::ComputeStereoFromRGBD,
    Frame.cc:678-699): ur = u - bf/d for d>0 else -1."""
    return jnp.where(depth > 0, u - bf / jnp.clip(depth, 1e-6, None), -1.0)


# ---------------------------------------------------------------------------
# keyframe insertion
# ---------------------------------------------------------------------------

@partial(jax.jit, donate_argnums=0)
def insert_keyframe(
    m: MapState,
    cam: CamParams,
    obs: FrameObs,
    R, t,
    frame_id,
) -> MapState:
    """Insert the current frame as a keyframe: copy the feature bundle and
    turn existing frame<->landmark matches into observations (reference:
    CreateNewKeyFrame Tracking.cc:1251-1264 + KeyFrame ctor).

    New-landmark creation from depth is a SEPARATE step
    (create_depth_landmarks) so the pipeline can first associate unmatched
    features with existing landmarks via fusion — otherwise every keyframe
    spawns hundreds of duplicates of already-mapped points whose fresher
    descriptors out-compete the originals and detach tracking from the map.
    """
    k = m.n_kf
    f = obs.feats
    N = f.xy.shape[0]
    m = m._replace(
        kf_R=m.kf_R.at[k].set(R),
        kf_t=m.kf_t.at[k].set(t),
        kf_valid=m.kf_valid.at[k].set(True),
        kf_frame_id=m.kf_frame_id.at[k].set(frame_id),
        kf_xy=m.kf_xy.at[k].set(f.xy),
        kf_ur=m.kf_ur.at[k].set(f.ur),
        kf_depth=m.kf_depth.at[k].set(obs.depth),
        kf_octave=m.kf_octave.at[k].set(f.octave),
        kf_angle=m.kf_angle.at[k].set(f.angle),
        kf_desc=m.kf_desc.at[k].set(f.desc),
        kf_feat_valid=m.kf_feat_valid.at[k].set(f.valid),
        n_kf=m.n_kf + 1,
    )
    feat_ids = jnp.arange(N, dtype=jnp.int32)
    has_lm = (obs.lm >= 0) & f.valid
    m = add_observation(m, jnp.clip(obs.lm, 0), jnp.full(N, k, jnp.int32),
                        feat_ids, has_lm)
    return m


@partial(jax.jit, donate_argnums=0)
def create_depth_landmarks(m: MapState, cam: CamParams, kf, th_depth) -> MapState:
    """Create landmarks for keyframe ``kf`` features that still have no
    landmark and carry valid depth: all closer than th_depth, else the 100
    closest (reference: Tracking.cc:1271-1324 close-point rule; scale bands
    per MapPoint::UpdateNormalAndDepth)."""
    N = m.kf_xy.shape[1]
    R = m.kf_R[kf]
    t = m.kf_t[kf]
    depth = m.kf_depth[kf]
    octv = m.kf_octave[kf]
    no_lm = m.kf_lm[kf] < 0
    depth_ok = (depth > 0) & m.kf_feat_valid[kf] & no_lm
    is_close = depth_ok & (depth < th_depth)
    rank = jnp.argsort(jnp.argsort(jnp.where(depth_ok, depth, 1e9)))
    create = jnp.where(jnp.sum(is_close) >= 100, is_close, depth_ok & (rank < 100))
    slot_off = prims.cumsum_tri(create.astype(jnp.int32)) - 1
    L = m.lm_pw.shape[0]
    slots = m.n_lm + slot_off
    create &= slots < L
    safe_slots = jnp.where(create, slots, L - 1)
    xy = m.kf_xy[kf]
    z = depth
    x = (xy[:, 0] - cam.cx) / cam.fx * z
    y = (xy[:, 1] - cam.cy) / cam.fy * z
    Xc = jnp.stack([x, y, z], axis=-1)
    Ow = -R.T @ t
    pw = Xc @ R + Ow
    dist = jnp.linalg.norm(pw - Ow, axis=-1)
    normal = (pw - Ow) / jnp.clip(dist, 1e-9, None)[:, None]
    dmax = dist * scale_at(octv)
    dmin = dmax / float(SCALE_FACTORS[N_LEVELS - 1])
    sel = create
    m = m._replace(
        lm_pw=m.lm_pw.at[safe_slots].set(jnp.where(sel[:, None], pw, m.lm_pw[safe_slots])),
        lm_valid=m.lm_valid.at[safe_slots].set(jnp.where(sel, True, m.lm_valid[safe_slots])),
        lm_desc=m.lm_desc.at[safe_slots].set(
            jnp.where(sel[:, None], m.kf_desc[kf], m.lm_desc[safe_slots])),
        lm_normal=m.lm_normal.at[safe_slots].set(
            jnp.where(sel[:, None], normal, m.lm_normal[safe_slots])),
        lm_dmin=m.lm_dmin.at[safe_slots].set(jnp.where(sel, dmin, m.lm_dmin[safe_slots])),
        lm_dmax=m.lm_dmax.at[safe_slots].set(jnp.where(sel, dmax, m.lm_dmax[safe_slots])),
        lm_first_kf=m.lm_first_kf.at[safe_slots].set(
            jnp.where(sel, kf, m.lm_first_kf[safe_slots])),
        lm_ref_kf=m.lm_ref_kf.at[safe_slots].set(
            jnp.where(sel, kf, m.lm_ref_kf[safe_slots])),
        lm_visible=m.lm_visible.at[safe_slots].set(jnp.where(sel, 1, m.lm_visible[safe_slots])),
        lm_found=m.lm_found.at[safe_slots].set(jnp.where(sel, 1, m.lm_found[safe_slots])),
        n_lm=m.n_lm + jnp.sum(create.astype(jnp.int32)),
    )
    feat_ids = jnp.arange(N, dtype=jnp.int32)
    m = add_observation(m, safe_slots, jnp.full(N, kf, jnp.int32), feat_ids, sel)
    return m


def _insert_landmark_rows(m: MapState, pw, desc, normal, dmin, dmax,
                          ref_kf, create):
    """Append landmark rows (masked) into the first free slots; returns
    (map, slots, still_ok) where slots[i] is the slot for row i."""
    L = m.lm_pw.shape[0]
    slot_off = prims.cumsum_tri(create.astype(jnp.int32)) - 1
    slots = m.n_lm + slot_off
    create &= slots < L
    safe = jnp.where(create, slots, L - 1)
    sel = create
    m = m._replace(
        lm_pw=m.lm_pw.at[safe].set(jnp.where(sel[:, None], pw, m.lm_pw[safe])),
        lm_valid=m.lm_valid.at[safe].set(jnp.where(sel, True, m.lm_valid[safe])),
        lm_desc=m.lm_desc.at[safe].set(jnp.where(sel[:, None], desc, m.lm_desc[safe])),
        lm_normal=m.lm_normal.at[safe].set(
            jnp.where(sel[:, None], normal, m.lm_normal[safe])),
        lm_dmin=m.lm_dmin.at[safe].set(jnp.where(sel, dmin, m.lm_dmin[safe])),
        lm_dmax=m.lm_dmax.at[safe].set(jnp.where(sel, dmax, m.lm_dmax[safe])),
        lm_first_kf=m.lm_first_kf.at[safe].set(
            jnp.where(sel, ref_kf, m.lm_first_kf[safe])),
        lm_ref_kf=m.lm_ref_kf.at[safe].set(
            jnp.where(sel, ref_kf, m.lm_ref_kf[safe])),
        lm_visible=m.lm_visible.at[safe].set(jnp.where(sel, 1, m.lm_visible[safe])),
        lm_found=m.lm_found.at[safe].set(jnp.where(sel, 1, m.lm_found[safe])),
        n_lm=m.n_lm + jnp.sum(create.astype(jnp.int32)),
    )
    return m, safe, create


@partial(jax.jit, donate_argnums=0)
def insert_landmarks_two_view(m: MapState, cam: CamParams, kf1, kf2,
                              idx2, pw, mask) -> MapState:
    """Insert triangulated landmarks anchored at kf1 features: row i is
    feature i of kf1 matched to feature idx2[i] of kf2 with world point
    pw[i] (reference: CreateInitialMapMonocular Tracking.cc:752-782 and
    the MapPoint creation tail of LocalMapping::CreateNewMapPoints)."""
    N = idx2.shape[0]
    mask = mask & (m.kf_lm[kf1] < 0)
    mask &= m.kf_lm[kf2, jnp.clip(idx2, 0)] < 0
    R2, t2 = m.kf_R[kf2], m.kf_t[kf2]
    Ow2 = -R2.T @ t2
    dist = jnp.linalg.norm(pw - Ow2, axis=-1)
    octv2 = m.kf_octave[kf2, jnp.clip(idx2, 0)]
    dmax = dist * scale_at(octv2)
    dmin = dmax / float(SCALE_FACTORS[N_LEVELS - 1])
    normal = (pw - Ow2) / jnp.clip(dist, 1e-9, None)[:, None]
    m, slots, ok = _insert_landmark_rows(
        m, pw, m.kf_desc[kf1], normal, dmin, dmax, kf2, mask)
    feat1 = jnp.arange(N, dtype=jnp.int32)
    m = add_observation(m, slots, jnp.full(N, kf1, jnp.int32), feat1, ok)
    m = add_observation(m, slots, jnp.full(N, kf2, jnp.int32),
                        jnp.clip(idx2, 0), ok)
    return m


def _kf_featureset(m: MapState, kf) -> FeatureSet:
    return FeatureSet(m.kf_xy[kf], m.kf_ur[kf], m.kf_octave[kf],
                      m.kf_angle[kf], m.kf_desc[kf], m.kf_feat_valid[kf])


@partial(jax.jit, donate_argnums=0)
def triangulate_landmarks(m: MapState, cam: CamParams, kf1, kf2) -> MapState:
    """CreateNewMapPoints for one keyframe pair (reference:
    LocalMapping.cc:290-577): epipolar-gated matching of landmark-free
    features, batched DLT triangulation, parallax / cheirality /
    reprojection-chi2 / scale-consistency gates, insertion with
    observations in both keyframes.

    The reference's scale-consistency guard lost its ``continue`` in this
    fork (SURVEY.md §0.1.3); upstream semantics (reject the match) are
    restored here.
    """
    from ..geometry import triangulate as tri
    from ..matching import search as ms
    R1, t1 = m.kf_R[kf1], m.kf_t[kf1]
    R2, t2 = m.kf_R[kf2], m.kf_t[kf2]
    # F12 (reference: LocalMapping::ComputeF12, :676-714)
    R12 = R1 @ R2.T
    t12 = -R12 @ t2 + t1
    tx = jnp.asarray([[0.0, -t12[2], t12[1]],
                      [t12[2], 0.0, -t12[0]],
                      [-t12[1], t12[0], 0.0]])
    Km = jnp.asarray([[cam.fx, 0, cam.cx], [0, cam.fy, cam.cy], [0, 0, 1.0]])
    Ki = jnp.linalg.inv(Km)
    F12 = Ki.T @ tx @ R12 @ Ki
    # epipole of camera 1 in image 2
    Ow1 = -R1.T @ t1
    c2 = R2 @ Ow1 + t2
    e2 = jnp.asarray([cam.fx * c2[0] / jnp.where(c2[2] == 0, 1e-9, c2[2]) + cam.cx,
                      cam.fy * c2[1] / jnp.where(c2[2] == 0, 1e-9, c2[2]) + cam.cy])
    f1 = _kf_featureset(m, kf1)
    f2 = _kf_featureset(m, kf2)
    free1 = m.kf_lm[kf1] < 0
    free2 = m.kf_lm[kf2] < 0
    idx2, dist, matched = ms.search_for_triangulation(
        cam, f1, f2, free1, free2, F12, e2)
    safe2 = jnp.clip(idx2, 0)
    p1 = f1.xy
    p2 = f2.xy[safe2]
    P1 = Km @ jnp.concatenate([R1, t1[:, None]], 1)
    P2 = Km @ jnp.concatenate([R2, t2[:, None]], 1)
    N = p1.shape[0]
    X = tri.triangulate_dlt(jnp.broadcast_to(P1, (N, 3, 4)),
                            jnp.broadcast_to(P2, (N, 3, 4)), p1, p2)
    Ow2 = -R2.T @ t2
    cos_par = tri.rays_parallax_cos(Ow1[None], Ow2[None], X)
    finite = jnp.all(jnp.isfinite(X), axis=-1)
    # parallax gate (reference :429-440: mono path requires ray parallax)
    par_ok = (cos_par > 0) & (cos_par < 0.9998)
    Xc1 = X @ R1.T + t1
    Xc2 = X @ R2.T + t2
    chei = (Xc1[:, 2] > 0) & (Xc2[:, 2] > 0)
    inv1 = inv_sigma2_at(f1.octave)
    inv2 = inv_sigma2_at(f2.octave[safe2])

    def reproj_chi2(Xc, xy, ur, inv):
        zc = jnp.clip(Xc[:, 2], 1e-9, None)
        u = cam.fx * Xc[:, 0] / zc + cam.cx
        v = cam.fy * Xc[:, 1] / zc + cam.cy
        e_mono = ((u - xy[:, 0]) ** 2 + (v - xy[:, 1]) ** 2) * inv
        ur_hat = u - cam.bf / zc
        e_st = e_mono + ((ur_hat - ur) ** 2) * inv
        return jnp.where(ur >= 0, e_st, e_mono), jnp.where(ur >= 0, 7.8, 5.991)

    c1, th1 = reproj_chi2(Xc1, p1, f1.ur, inv1)
    c2q, th2 = reproj_chi2(Xc2, p2, f2.ur[safe2], inv2)
    reproj_ok = (c1 < th1) & (c2q < th2)
    # scale consistency (reference :527-559, upstream semantics)
    d1 = jnp.linalg.norm(X - Ow1[None], axis=-1)
    d2 = jnp.linalg.norm(X - Ow2[None], axis=-1)
    ratio_dist = d2 / jnp.clip(d1, 1e-9, None)
    ratio_oct = scale_at(f1.octave) / scale_at(f2.octave[safe2])
    ratio_factor = 1.5 * SCALE
    scale_ok = ((ratio_dist * ratio_factor >= ratio_oct)
                & (ratio_dist <= ratio_oct * ratio_factor))
    ok = (matched & finite & par_ok & chei & reproj_ok & scale_ok
          & (d1 > 0) & (d2 > 0))
    return insert_landmarks_two_view(m, cam, kf1, kf2, idx2, X, ok)


@partial(jax.jit, donate_argnums=0)
def triangulate_with_neighbors(m: MapState, cam: CamParams, kf,
                               neighbors) -> MapState:
    """CreateNewMapPoints over the top covisible neighbors (padded -1),
    with the baseline gate: skip neighbors closer than 1% of their median
    scene depth (mono rule, reference LocalMapping.cc:336-358)."""
    Ow = -m.kf_R[kf].T @ m.kf_t[kf]

    def body(i, mm):
        j = neighbors[i]

        def do(mm):
            Owj = -mm.kf_R[j].T @ mm.kf_t[j]
            baseline = jnp.linalg.norm(Owj - Ow)
            # median scene depth of neighbor j (ComputeSceneMedianDepth q=2)
            lm_j = mm.kf_lm[j]
            has = (lm_j >= 0) & mm.kf_feat_valid[j] & mm.lm_valid[jnp.clip(lm_j, 0)]
            pw = mm.lm_pw[jnp.clip(lm_j, 0)]
            z = pw @ mm.kf_R[j][2] + mm.kf_t[j][2]
            zs = jnp.sort(jnp.where(has, z, jnp.inf))
            nv = jnp.sum(has)
            med = zs[jnp.clip((nv - 1) // 2, 0, z.shape[0] - 1)]
            ok = baseline / jnp.clip(med, 1e-9, None) > 0.01
            return jax.lax.cond(
                ok, lambda x: triangulate_landmarks(x, cam, kf, j),
                lambda x: x, mm)

        return jax.lax.cond(j >= 0, do, lambda x: x, mm)

    return jax.lax.fori_loop(0, neighbors.shape[0], body, m)


@partial(jax.jit, donate_argnums=0)
def scale_map(m: MapState, s) -> MapState:
    """Rescale the whole map (monocular gauge fix, reference:
    CreateInitialMapMonocular Tracking.cc:791-817): landmark positions and
    keyframe translations multiply by s."""
    return m._replace(
        kf_t=m.kf_t * s,
        lm_pw=m.lm_pw * s,
        lm_dmin=m.lm_dmin * s,
        lm_dmax=m.lm_dmax * s,
        kf_depth=jnp.where(m.kf_depth > 0, m.kf_depth * s, m.kf_depth),
    )


@jax.jit
def scene_median_depth(m: MapState, kf) -> jax.Array:
    """KeyFrame::ComputeSceneMedianDepth(2) (reference KeyFrame.cc:647-677)."""
    lm = m.kf_lm[kf]
    has = (lm >= 0) & m.kf_feat_valid[kf] & m.lm_valid[jnp.clip(lm, 0)]
    z = m.lm_pw[jnp.clip(lm, 0)] @ m.kf_R[kf][2] + m.kf_t[kf][2]
    zs = jnp.sort(jnp.where(has, z, jnp.inf))
    nv = jnp.sum(has)
    return zs[jnp.clip((nv - 1) // 2, 0, z.shape[0] - 1)]


@partial(jax.jit, static_argnames=("width", "height"), donate_argnums=0)
def keyframe_step_mono(m: MapState, cam, obs: FrameObs, R, t, frame_id,
                       width: int, height: int) -> MapState:
    """Monocular keyframe maintenance: insertion -> fuse inward ->
    triangulate new landmarks against top covisible neighbors (the mono
    map's ONLY landmark source) -> fuse outward -> refresh -> cull ->
    local BA. Counterpart of keyframe_step without depth landmarks."""
    from ..mapstate.map import covisibility_weights
    k = m.n_kf
    m = insert_keyframe(m, cam, obs, R, t, frame_id)
    w = covisibility_weights(m, k)
    top_w, top_i = prims.sort_top_k(w, 10)
    cull_window = jnp.where(top_w > 0, top_i.astype(jnp.int32), -1)
    neighbors = cull_window[:5]
    m = fuse_neighbors(m, cam, k, neighbors, width, height, into=True)
    m = triangulate_with_neighbors(m, cam, k, neighbors)
    m = fuse_neighbors(m, cam, k, neighbors, width, height, into=False)
    m = merge_duplicate_landmarks(m, k)
    m = refresh_landmarks_for_kf(m, k)
    m = cull_landmarks(m, k)
    has_neighbors = jnp.any(neighbors >= 0)
    m = jax.lax.cond(has_neighbors,
                     lambda mm: local_bundle_adjustment(mm, cam, k),
                     lambda mm: mm, m)
    m = cull_keyframes(m, k, cull_window)
    return m


# ---------------------------------------------------------------------------
# tracking steps
# ---------------------------------------------------------------------------

class TrackResult(NamedTuple):
    R: jax.Array
    t: jax.Array
    lm: jax.Array  # [N] per-feature landmark idx (-1 none), post-opt inliers
    n_matches: jax.Array  # matches fed to the optimizer
    n_inliers: jax.Array  # map-observed inliers after optimization


def _pose_optimize_from_matches(cam, m, feats, frame_lm, R0, t0):
    """Pose-only optimization over current frame<->landmark matches."""
    has = frame_lm >= 0
    Xw = m.lm_pw[jnp.clip(frame_lm, 0)]
    obs_uvr = jnp.concatenate([feats.xy, feats.ur[:, None]], axis=-1)
    inv_s2 = inv_sigma2_at(feats.octave)
    res = pose_opt.optimize_pose(cam, R0, t0, Xw, obs_uvr, inv_s2, has & feats.valid)
    lm_out = jnp.where(res.inliers, frame_lm, -1)
    return TrackResult(res.R, res.t, lm_out,
                       jnp.sum((has & feats.valid).astype(jnp.int32)), res.n_inliers)


def _match_motion_model(cam, m, prev, feats, R_pred, t_pred, th,
                        width, height, desc_th):
    """Motion-model data association only (reference: SearchByProjection
    vs last frame, ORBmatcher.cc:1540+). Returns frame_lm [N]."""
    prev_has = (prev.lm >= 0) & prev.feats.valid
    pw = m.lm_pw[jnp.clip(prev.lm, 0)]
    ok_lm = m.lm_valid[jnp.clip(prev.lm, 0)] & prev_has
    idx, dist, matched = msearch.search_by_projection_frame(
        cam, R_pred, t_pred, pw, prev.feats, ok_lm, feats,
        th, width, height, forward=False, backward=False, desc_th=desc_th)
    N = feats.xy.shape[0]
    frame_lm = jnp.full(N, -1, jnp.int32)
    safe_idx = jnp.where(matched, idx, 0)
    return frame_lm.at[safe_idx].set(
        jnp.where(matched, prev.lm, frame_lm[safe_idx]))


def _match_reference_kf(m, ref_kf, feats):
    """Reference-keyframe data association only (reference: SearchByBoW,
    ratio 0.7 — here a full masked Hamming sweep). Returns frame_lm [N]."""
    kf_desc = m.kf_desc[ref_kf]
    kf_lm = m.kf_lm[ref_kf]
    kf_has = (kf_lm >= 0) & m.kf_feat_valid[ref_kf] & m.lm_valid[jnp.clip(kf_lm, 0)]
    idx, dist, matched = msearch.search_brute(
        kf_desc, feats.desc, kf_has, feats.valid, ratio=0.7,
        angle_q=m.kf_angle[ref_kf], angle_t=feats.angle)
    N = feats.xy.shape[0]
    frame_lm = jnp.full(N, -1, jnp.int32)
    safe_idx = jnp.where(matched, idx, 0)
    return frame_lm.at[safe_idx].set(
        jnp.where(matched, kf_lm, frame_lm[safe_idx]))


@jax.jit
def track_motion_model(
    cam, m: MapState, prev: FrameObs, prev_R, prev_t,
    feats: FeatureSet, R_pred, t_pred, th, width, height,
    desc_th=jnp.int32(100),
) -> TrackResult:
    """TrackWithMotionModel (reference: Tracking.cc:997-1063): project last
    frame's landmarks with the constant-velocity pose prediction, windowed
    match (ORBmatcher.cc:1540+), then pose-only BA."""
    frame_lm = _match_motion_model(cam, m, prev, feats, R_pred, t_pred,
                                   th, width, height, desc_th)
    return _pose_optimize_from_matches(cam, m, feats, frame_lm, R_pred, t_pred)


@jax.jit
def track_reference_keyframe(
    cam, m: MapState, ref_kf, feats: FeatureSet, R0, t0,
) -> TrackResult:
    """TrackReferenceKeyFrame (reference: Tracking.cc:871-917): match the
    frame against the reference keyframe's landmarks (SearchByBoW with
    ratio 0.7 — here a full masked Hamming sweep), then pose-only BA from
    the last frame's pose."""
    frame_lm = _match_reference_kf(m, ref_kf, feats)
    return _pose_optimize_from_matches(cam, m, feats, frame_lm, R0, t0)


@partial(jax.jit, static_argnames=("width", "height", "lm_cap"))
def track_local_map(
    cam, m: MapState, feats: FeatureSet, frame_lm, R, t,
    local_lm_mask, th, width: int, height: int,
    desc_th=jnp.int32(100), lm_cap: int = 4096,
) -> tuple[TrackResult, MapState]:
    """TrackLocalMap (reference: Tracking.cc:1075-1127 + SearchLocalPoints
    1345-1403): project unmatched local landmarks, add matches, re-optimize,
    and update per-landmark visible/found statistics.

    The candidate landmarks are gathered into a fixed ``lm_cap``-row window
    before the [candidates x features] Hamming sweep — the sweep is the hot
    per-frame op, and at dataset-scale capacity (L≈10^5, N=2000 features) an
    ungathered sweep would be a ~10^8-cell matrix per frame. The reference's
    local map is a few thousand points (Tracking.cc:1471-1509), so lm_cap
    bounds nothing in practice; on overflow the lowest-index (oldest)
    candidates win."""
    L = m.lm_pw.shape[0]
    lm_cap = min(lm_cap, L)
    # exclude landmarks already matched in this frame and features already used
    # scatter-ADD of 0/1 counts, not scatter-set of bools: unmatched
    # features all clip to index 0, and a scatter-set with conflicting
    # duplicate values (True from a real match to slot 0, False from
    # clipped -1 entries) is nondeterministic.
    already_lm = jnp.zeros(L, jnp.int32).at[jnp.clip(frame_lm, 0)].add(
        (frame_lm >= 0).astype(jnp.int32)) > 0
    cand = local_lm_mask & m.lm_valid & ~already_lm
    sel, g_ok = prims.gather_mask_indices(cand, lm_cap)
    lmset = msearch.LandmarkSet(
        m.lm_pw[sel], m.lm_normal[sel], m.lm_dmin[sel], m.lm_dmax[sel],
        m.lm_desc[sel], g_ok)
    fr = msearch.frustum_check(cam, R, t, lmset, width, height)
    feat_used = frame_lm >= 0
    idx, dist, matched = msearch.search_local_points(
        cam, R, t, lmset, fr, feats, th=th, already_matched=feat_used,
        desc_th=desc_th)
    safe_idx = jnp.where(matched, idx, 0)
    frame_lm = frame_lm.at[safe_idx].set(
        jnp.where(matched, sel, frame_lm[safe_idx]))
    result = _pose_optimize_from_matches(cam, m, feats, frame_lm, R, t)
    # statistics: visible++ for frustum-visible candidates and for already-
    # matched landmarks; found++ for post-optimization inlier matches
    vis_inc = (jnp.zeros(L, jnp.int32).at[sel].add(fr.visible.astype(jnp.int32))
               + already_lm.astype(jnp.int32))
    found_mask = jnp.zeros(L, jnp.int32).at[jnp.clip(result.lm, 0)].add(
        (result.lm >= 0).astype(jnp.int32)) > 0
    m = m._replace(
        lm_visible=m.lm_visible + vis_inc,
        lm_found=m.lm_found + found_mask.astype(jnp.int32),
    )
    return result, m


@jax.jit
def local_landmark_mask(m: MapState, ref_kf) -> jax.Array:
    """Local-map landmark selection: landmarks observed by keyframes
    covisible with ref_kf (reference: UpdateLocalKeyFrames/Points,
    Tracking.cc:1421-1570)."""
    K = m.kf_R.shape[0]
    from ..mapstate.map import covisibility_weights
    w = covisibility_weights(m, ref_kf)  # [K]
    local_kf = (w > 0) | (jnp.arange(K) == ref_kf)
    obs_in_local = jnp.any(
        local_kf[jnp.clip(m.lm_obs_kf, 0)] & (m.lm_obs_kf >= 0), axis=1)
    return obs_in_local & m.lm_valid


# ---------------------------------------------------------------------------
# local bundle adjustment + culling
# ---------------------------------------------------------------------------

@partial(jax.jit,
         static_argnames=("iters_a", "free_cap", "fixed_cap", "lm_cap",
                          "erase_outliers", "with_lambda"),
         donate_argnums=0)
def local_bundle_adjustment(m: MapState, cam, cur_kf, iters_a: int = 5,
                            free_cap: int = 16, fixed_cap: int = 8,
                            lm_cap: int = 8192,
                            erase_outliers: bool = True,
                            with_lambda: bool = False,
                            init_lambda=1e-4):
    """LocalBundleAdjustment (reference: Optimizer.cc:483-808): free poses =
    current KF + its covisible neighbors, fixed = other KFs observing a
    local landmark; landmarks of free KFs optimized; outlier observations
    (chi2 > 5.991/7.815 at the optimum) erased from the map.

    Gather -> fixed-shape solve -> scatter: the subproblem (top ``free_cap``
    covisible keyframes, top ``fixed_cap`` anchor keyframes by shared
    observations, first ``lm_cap`` local landmarks) is gathered out of the
    capacity-sized SoA map and solved at constant shape, so the per-keyframe
    BA cost is O(local window) regardless of map size — the property that
    lets KITTI-scale maps (K≈1500, L≈10^5) track at the same rate as the
    64-keyframe toy maps. The reference's local window is likewise bounded
    in practice (covisible neighbors only); overflowing landmarks simply sit
    out this round and are re-gathered next keyframe.

    Chunking: with erase_outliers=False the outlier erasure pass is
    skipped (run it only in the LAST chunk of a maintenance-amortized BA,
    mirroring the reference's 5-iter -> outlier pass -> 10-iter order);
    with_lambda=True returns (map, final_lambda) so the next chunk can
    resume the LM damping schedule via init_lambda."""
    from ..mapstate.map import covisibility_weights
    K, N = m.kf_lm.shape
    L, D = m.lm_obs_kf.shape
    free_cap = min(free_cap, K)
    fixed_cap = min(fixed_cap, K)
    lm_cap = min(lm_cap, L)
    P = free_cap + fixed_cap
    w = covisibility_weights(m, cur_kf)
    # keyframe 0 always fixed (gauge; reference Optimizer.cc:559)
    w = w.at[0].set(0)
    top_w, top_i = prims.sort_top_k(w, free_cap - 1)
    free_list = jnp.concatenate(
        [cur_kf[None].astype(jnp.int32), top_i.astype(jnp.int32)])
    free_ok = jnp.concatenate(
        [jnp.ones(1, bool), (top_w > 0) & (top_i != cur_kf)])
    free_mask = jnp.zeros(K, bool).at[
        jnp.where(free_ok, free_list, 0)].max(free_ok)
    obs_valid = m.lm_obs_kf >= 0
    lm_local = jnp.any(free_mask[jnp.clip(m.lm_obs_kf, 0)] & obs_valid,
                       axis=1) & m.lm_valid
    sel, g_ok = prims.gather_mask_indices(lm_local, lm_cap)
    obs_kf_g = m.lm_obs_kf[sel]  # [lm_cap, D]
    obs_feat_g = m.lm_obs_feat[sel]
    # fixed anchors: keyframes with the most observations of the gathered
    # landmarks that are not free (reference: all observers become fixed
    # vertices, Optimizer.cc:519-534; bounded to the strongest fixed_cap)
    contrib = ((obs_kf_g >= 0) & g_ok[:, None]).astype(jnp.int32)
    cnt = jnp.zeros(K, jnp.int32).at[jnp.clip(obs_kf_g, 0)].add(contrib)
    cnt = jnp.where(free_mask | ~m.kf_valid, 0, cnt)
    fix_w, fix_i = prims.sort_top_k(cnt, fixed_cap)
    sel_pose = jnp.concatenate([free_list, fix_i.astype(jnp.int32)])  # [P]
    pose_ok = jnp.concatenate([free_ok, fix_w > 0])
    pose_fixed = jnp.concatenate(
        [jnp.zeros(free_cap, bool), jnp.ones(fixed_cap, bool)]) | ~pose_ok
    safe_pose = jnp.where(pose_ok, sel_pose, 0)
    g2l = jnp.full(K, -1, jnp.int32).at[safe_pose].max(
        jnp.where(pose_ok, jnp.arange(P, dtype=jnp.int32), -1))
    lp = g2l[jnp.clip(obs_kf_g, 0)]  # [lm_cap, D] local pose or -1
    act = (obs_kf_g >= 0) & (lp >= 0) & g_ok[:, None]
    kf_i = jnp.clip(obs_kf_g, 0)
    uv = m.kf_xy[kf_i, obs_feat_g]  # [lm_cap, D, 2]
    ur = m.kf_ur[kf_i, obs_feat_g]
    uvr = jnp.concatenate([uv, ur[..., None]], axis=-1)
    octv = m.kf_octave[kf_i, obs_feat_g]
    wgt = jnp.where(act, inv_sigma2_at(octv), 0.0)
    prob = ba.BAProblem(
        R=m.kf_R[safe_pose], t=m.kf_t[safe_pose], X=m.lm_pw[sel],
        obs_pose=jnp.clip(lp, 0), obs_uvr=uvr, obs_w=wgt,
        pose_fixed=pose_fixed, point_valid=g_ok,
    )
    res = ba.ba_solve(cam, prob, iters=iters_a, robust=True,
                      init_lambda=init_lambda)
    # scatter optimized poses / landmarks back into the map
    upd = pose_ok & ~pose_fixed
    kf_R = m.kf_R.at[safe_pose].set(
        jnp.where(upd[:, None, None], res.R, m.kf_R[safe_pose]))
    kf_t = m.kf_t.at[safe_pose].set(
        jnp.where(upd[:, None], res.t, m.kf_t[safe_pose]))
    lm_pw = m.lm_pw.at[sel].set(
        jnp.where(g_ok[:, None], res.X, m.lm_pw[sel]))
    m = m._replace(kf_R=kf_R, kf_t=kf_t, lm_pw=lm_pw)
    if erase_outliers:
        # second stage without robust kernel on inliers only (reference: 5
        # iters robust, outlier pass, 10 more): fused pass — erase outliers.
        is_stereo = uvr[..., 2] >= 0
        chi_th = jnp.where(is_stereo, 7.815, 5.991)
        outlier = (res.obs_chi2 > chi_th) & (wgt > 0)
        new_rows = jnp.where(outlier, -1, obs_kf_g)
        lm_obs_kf = m.lm_obs_kf.at[sel].set(new_rows)
        back_ok = m.kf_lm[kf_i, obs_feat_g] == sel[:, None]
        clear = outlier & back_ok
        kf_lm = m.kf_lm.at[kf_i, obs_feat_g].set(
            jnp.where(clear, -1, m.kf_lm[kf_i, obs_feat_g]))
        # Landmarks whose last observation was just erased are dead weight:
        # they stay matchable by descriptor but are no longer anchored by
        # any keyframe, so BA never corrects them and they poison
        # projection matching (the reference's MapPointCulling handles this
        # the next round; with culling running before BA in the fused
        # keyframe step the orphans would otherwise survive forever).
        nobs_after = jnp.sum(new_rows >= 0, axis=1)
        lm_valid = m.lm_valid.at[sel].set(
            m.lm_valid[sel] & jnp.where(g_ok, nobs_after > 0, True))
        m = m._replace(lm_obs_kf=lm_obs_kf, kf_lm=kf_lm, lm_valid=lm_valid)
    if with_lambda:
        return m, res.final_lambda
    return m


@partial(jax.jit, donate_argnums=0)
def cull_landmarks(m: MapState, cur_kf) -> MapState:
    """MapPointCulling (reference: LocalMapping.cc:219-263), applied to
    recent landmarks only (the reference's mlpRecentAddedMapPoints window):
    drop when found/visible < 0.25, or when age >= 2 keyframes with too few
    observers. The reference's obs <= 3 counts stereo observations double
    (MapPoint.cc:105-108), so in keyframe-slot units the threshold is <= 1.
    Landmarks older than 3 keyframes graduate untouched."""
    nobs = landmark_obs_count(m)
    age = cur_kf - m.lm_first_kf
    ratio_bad = (m.lm_found.astype(jnp.float32) /
                 jnp.clip(m.lm_visible.astype(jnp.float32), 1.0, None)) < 0.25
    young_weak = (age >= 2) & (nobs <= 1)
    orphan = nobs == 0
    bad = m.lm_valid & ((age <= 3) & (ratio_bad | young_weak) | orphan)
    return m._replace(lm_valid=m.lm_valid & ~bad)


# ---------------------------------------------------------------------------
# observation fusion (map densification)
# ---------------------------------------------------------------------------

@partial(jax.jit, static_argnames=("width", "height"), donate_argnums=0)
def fuse_pair(m: MapState, cam, src_kf, dst_kf, width: int, height: int) -> MapState:
    """Project the landmarks of keyframe ``src_kf`` into keyframe ``dst_kf``
    and add observations for unassociated matched features.

    One direction of the reference's LocalMapping::SearchInNeighbors
    (reference: LocalMapping.cc:589-674, ORBmatcher::Fuse 977+). Cross-KF
    observations are what make local BA rigid: without them every landmark
    is seen by ~1 keyframe and the map drifts with tracking bias.
    (Landmark merging of duplicates is a separate step.)
    """
    lm_ids = m.kf_lm[src_kf]  # [N]
    safe = jnp.clip(lm_ids, 0)
    has = (lm_ids >= 0) & m.kf_feat_valid[src_kf] & m.lm_valid[safe]
    from ..matching.search import LandmarkSet, fuse_candidates
    lmset = LandmarkSet(
        m.lm_pw[safe], m.lm_normal[safe], m.lm_dmin[safe], m.lm_dmax[safe],
        m.lm_desc[safe], has)
    feats_b = FeatureSet(
        m.kf_xy[dst_kf], m.kf_ur[dst_kf], m.kf_octave[dst_kf],
        m.kf_angle[dst_kf], m.kf_desc[dst_kf], m.kf_feat_valid[dst_kf])
    idx, dist, matched = fuse_candidates(
        cam, m.kf_R[dst_kf], m.kf_t[dst_kf], lmset, feats_b, width, height)
    feat_free = m.kf_lm[dst_kf, idx] < 0
    already = jnp.any(m.lm_obs_kf[safe] == dst_kf, axis=1)
    ok = matched & feat_free & ~already & has
    N = lm_ids.shape[0]
    m = add_observation(m, safe, jnp.full(N, dst_kf, jnp.int32), idx, ok)
    # Merge duplicates: the matched dst feature already belongs to ANOTHER
    # landmark — the same physical point mapped twice. Keep the landmark
    # with more observations (reference: ORBmatcher::Fuse 1111-1114,
    # MapPoint::Replace). This is what re-anchors fresh keyframes' points
    # to the old map instead of letting tracking follow recent duplicates.
    from ..mapstate.map import landmark_obs_count, merge_landmarks
    other = m.kf_lm[dst_kf, idx]
    dup = matched & has & (other >= 0) & (other != lm_ids)
    nobs = landmark_obs_count(m)
    n_self = nobs[safe]
    n_other = nobs[jnp.clip(other, 0)]
    keep = jnp.where(n_self >= n_other, lm_ids, other)
    kill = jnp.where(n_self >= n_other, other, lm_ids)
    return merge_landmarks(m, jnp.clip(keep, 0), jnp.clip(kill, 0), dup)


@partial(jax.jit, static_argnames=("width", "height", "lm_cap"),
         donate_argnums=0)
def loop_search_and_fuse(m: MapState, cam, loop_lm_mask, group_kfs,
                         width: int, height: int,
                         lm_cap: int = 4096) -> MapState:
    """SearchAndFuse (reference: LoopClosing.cc:725-754): project the loop
    keyframes' landmarks into every corrected keyframe of the current
    covisibility group (radius th=4, reference :741), adding observations
    on free features and — unlike the regular Fuse — ALWAYS replacing a
    conflicting landmark with the loop landmark (reference stages
    vpReplacePoints and calls Replace(pLoopMP), :746-752): the loop side
    carries the longer history, and these merges are what weld the two
    sides of the loop into one covisibility component.

    ``loop_lm_mask`` [L]: landmarks of the loop keyframe's covisibility
    group; ``group_kfs`` [G]: corrected keyframe slots, -1 padded.
    """
    L = m.lm_pw.shape[0]
    lm_cap = min(lm_cap, L)
    sel, g_ok = prims.gather_mask_indices(loop_lm_mask & m.lm_valid, lm_cap)
    from ..matching.search import LandmarkSet, fuse_candidates
    from ..mapstate.map import merge_landmarks

    def body(i, mm):
        j = group_kfs[i]

        def do(mm):
            ok_lm = g_ok & mm.lm_valid[sel]
            lmset = LandmarkSet(
                mm.lm_pw[sel], mm.lm_normal[sel], mm.lm_dmin[sel],
                mm.lm_dmax[sel], mm.lm_desc[sel], ok_lm)
            feats_b = FeatureSet(
                mm.kf_xy[j], mm.kf_ur[j], mm.kf_octave[j],
                mm.kf_angle[j], mm.kf_desc[j], mm.kf_feat_valid[j])
            idx, dist, matched = fuse_candidates(
                cam, mm.kf_R[j], mm.kf_t[j], lmset, feats_b,
                width, height, th=4.0)
            feat_free = mm.kf_lm[j, idx] < 0
            already = jnp.any(mm.lm_obs_kf[sel] == j, axis=1)
            ok = matched & feat_free & ~already & ok_lm
            C = sel.shape[0]
            mm = add_observation(mm, sel, jnp.full(C, j, jnp.int32), idx, ok)
            other = mm.kf_lm[j, idx]
            dup = (matched & ok_lm & (other >= 0) & (other != sel)
                   & mm.lm_valid[sel])
            # loop landmark wins unconditionally (reference :746-752)
            return merge_landmarks(mm, sel, jnp.clip(other, 0), dup)

        return jax.lax.cond(j >= 0, do, lambda x: x, mm)

    return jax.lax.fori_loop(0, group_kfs.shape[0], body, m)


def repack_obs_rows(m: MapState) -> MapState:
    """Repack each landmark's observation row so the valid entries form a
    prefix in their original order (the append-only invariant
    add_observation relies on), after in-place clears punched holes.
    One stable [L, D] sort along the tiny slot axis — O(map observations),
    unlike a full rebuild_observations (which sorts the [K*N] back-ref
    table and scales with keyframe capacity)."""
    holes = m.lm_obs_kf < 0
    order = jnp.argsort(holes, axis=1, stable=True)
    return m._replace(
        lm_obs_kf=jnp.take_along_axis(m.lm_obs_kf, order, axis=1),
        lm_obs_feat=jnp.take_along_axis(m.lm_obs_feat, order, axis=1))


@partial(jax.jit, donate_argnums=0)
def cull_keyframes(m: MapState, cur_kf, candidates) -> MapState:
    """KeyFrameCulling (reference: LocalMapping.cc:775-841): a keyframe is
    redundant when >= 90% of its landmarks are observed by >= 3 OTHER
    keyframes at the same or finer scale (octave <= own + 1). Culled
    keyframes lose their observations and covisibility; their pose rows
    stay until the next compaction pass recycles the slots (the host
    archives evicted poses for trajectory export at that point).

    ``candidates`` [C]: keyframe slots to evaluate (-1 padded) — the
    reference likewise culls only the LOCAL keyframes covisible with the
    current one (LocalMapping.cc:779), which bounds the work to a fixed
    window instead of an all-keyframes [K, N, D] sweep.

    Keyframe 0 (gauge) and the current keyframe are never culled.
    """
    K, N = m.kf_lm.shape
    C = candidates.shape[0]
    cand = jnp.clip(candidates, 0)                    # [C]
    lm = jnp.clip(m.kf_lm[cand], 0)                   # [C, N]
    has = ((m.kf_lm[cand] >= 0) & m.kf_feat_valid[cand]
           & m.lm_valid[lm] & m.kf_valid[cand][:, None])
    obs_kf = m.lm_obs_kf[lm]                          # [C, N, D]
    obs_feat = m.lm_obs_feat[lm]
    obs_oct = m.kf_octave[jnp.clip(obs_kf, 0), obs_feat]  # [C, N, D]
    own_oct = m.kf_octave[cand][:, :, None]
    counted = ((obs_kf >= 0) & (obs_kf != cand[:, None, None])
               & m.kf_valid[jnp.clip(obs_kf, 0)]
               & (obs_oct <= own_oct + 1))
    n_other = jnp.sum(counted, axis=2)                # [C, N]
    redundant = has & (n_other >= 3)
    n_has = jnp.sum(has, axis=1)
    n_red = jnp.sum(redundant, axis=1)
    cull = (m.kf_valid[cand] & (n_has > 0)
            & (n_red.astype(jnp.float32) > 0.9 * n_has.astype(jnp.float32)))
    cull = cull & (candidates >= 0) & (cand != 0) & (cand != cur_kf)
    kf_valid = m.kf_valid.at[cand].set(m.kf_valid[cand] & ~cull)
    # clear observations held by culled keyframes, then repack the rows
    obs_dead = (m.lm_obs_kf >= 0) & ~kf_valid[jnp.clip(m.lm_obs_kf, 0)]
    m = m._replace(kf_valid=kf_valid,
                   lm_obs_kf=jnp.where(obs_dead, -1, m.lm_obs_kf))
    return repack_obs_rows(m)


@partial(jax.jit, static_argnames=("block",), donate_argnums=0)
def merge_duplicate_landmarks(m: MapState, cur_kf, block: int = 1024) -> MapState:
    """Sweep freshly created landmarks for duplicates of older ones and
    merge them (reference analogue: MapPoint::Replace via ORBmatcher::Fuse;
    this global position+descriptor sweep is the SoA-native generalization
    that catches duplicates Fuse's window search misses under drift).

    Landmark slots are append-only, so this keyframe's creations form a
    suffix: a fixed ``block`` ending at n_lm bounds the candidate set with
    static shapes. A recent landmark merges into the closest OLDER landmark
    within a scale-aware radius whose descriptor agrees (Hamming <= 50).
    """
    from ..ops.hamming import distance_matrix
    L = m.lm_pw.shape[0]
    R = min(block, L)
    start = jnp.clip(m.n_lm - R, 0, L - R)
    slot = start + jnp.arange(R, dtype=jnp.int32)
    pw_r = jax.lax.dynamic_slice(m.lm_pw, (start, 0), (R, 3))
    desc_r = jax.lax.dynamic_slice(m.lm_desc, (start, 0), (R, 8))
    first_r = jax.lax.dynamic_slice(m.lm_first_kf, (start,), (R,))
    valid_r = jax.lax.dynamic_slice(m.lm_valid, (start,), (R,))
    recent = valid_r & (first_r == cur_kf) & (slot < m.n_lm)
    # Sweep all L candidate targets in fixed-size chunks (running masked
    # argmin) so the peak intermediate is [R, chunk] rather than [R, L] —
    # at dataset-scale L≈10^5 an unchunked [R, L] float slab is ~0.5 GB.
    CH = 16384
    best_d2 = jnp.full((R,), jnp.inf, jnp.float32)
    best_tgt = jnp.zeros((R,), jnp.int32)
    for start_c in range(0, L, CH):
        n_c = min(CH, L - start_c)
        pw_c = jax.lax.slice_in_dim(m.lm_pw, start_c, start_c + n_c)
        desc_c = jax.lax.slice_in_dim(m.lm_desc, start_c, start_c + n_c)
        dmax_c = jax.lax.slice_in_dim(m.lm_dmax, start_c, start_c + n_c)
        valid_c = jax.lax.slice_in_dim(m.lm_valid, start_c, start_c + n_c)
        ids_c = start_c + jnp.arange(n_c, dtype=jnp.int32)
        d2 = ((pw_r[:, 0:1] - pw_c[None, :, 0]) ** 2
              + (pw_r[:, 1:2] - pw_c[None, :, 1]) ** 2
              + (pw_r[:, 2:3] - pw_c[None, :, 2]) ** 2)
        ham = distance_matrix(desc_r, desc_c)
        tol = jnp.clip(0.015 * dmax_c, 0.005, 0.05)[None, :]
        # merge into any strictly-lower slot (covers both older keyframes'
        # landmarks and same-keyframe octave duplicates; strict ordering
        # prevents cycles, merge_landmarks compresses chains)
        lower = valid_c[None, :] & (ids_c[None, :] < slot[:, None])
        ok = (lower & (d2 < tol * tol) & (ham <= 50) & recent[:, None])
        d2m = jnp.where(ok, d2, jnp.inf)
        arg_c = jnp.argmin(d2m, axis=1)
        min_c = jnp.take_along_axis(d2m, arg_c[:, None], axis=1)[:, 0]
        better = min_c < best_d2
        best_tgt = jnp.where(better, ids_c[arg_c], best_tgt)
        best_d2 = jnp.where(better, min_c, best_d2)
    has = jnp.isfinite(best_d2)
    from ..mapstate.map import merge_landmarks
    return merge_landmarks(m, best_tgt, slot, has & recent)


@partial(jax.jit, donate_argnums=0)
def refresh_landmarks(m: MapState) -> MapState:
    """Recompute representative descriptors and normals/scale bands from the
    observation table (reference: MapPoint::ComputeDistinctiveDescriptors
    MapPoint.cc:247-316 — min median Hamming — and UpdateNormalAndDepth
    339-390)."""
    from ..ops.hamming import hamming_pair
    L, D = m.lm_obs_kf.shape
    valid_obs = m.lm_obs_kf >= 0
    kf_idx = jnp.clip(m.lm_obs_kf, 0)
    descs = m.kf_desc[kf_idx, m.lm_obs_feat]  # [L, D, 8]
    dmat = hamming_pair(descs[:, :, None, :], descs[:, None, :, :])  # [L, D, D]
    big = 10_000
    pair_ok = valid_obs[:, :, None] & valid_obs[:, None, :]
    dmat = jnp.where(pair_ok, dmat, big)
    # median distance of each candidate to the others: sort row, take the
    # element at (count-1)//2 among valid entries (invalid sorted to the end)
    srt = jnp.sort(dmat, axis=2)
    cnt = jnp.sum(valid_obs, axis=1)  # [L]
    mid = jnp.clip((cnt - 1) // 2, 0, D - 1)
    med = jnp.take_along_axis(srt, mid[:, None, None].repeat(D, 1), axis=2)[..., 0]
    med = jnp.where(valid_obs, med, big)
    best = jnp.argmin(med, axis=1)  # [L]
    new_desc = jnp.take_along_axis(descs, best[:, None, None].repeat(8, 2), axis=1)[:, 0]
    has_obs = cnt > 0
    lm_desc = jnp.where(has_obs[:, None], new_desc, m.lm_desc)
    # normals: mean of unit directions camera-center -> point
    Ow = -jnp.einsum("kij,ki->kj", m.kf_R, m.kf_t)  # [K, 3] centers
    dirs = m.lm_pw[:, None, :] - Ow[kf_idx]  # [L, D, 3]
    norms = jnp.linalg.norm(dirs, axis=-1).clip(1e-9)
    dirs = dirs / norms[..., None]
    dirs = jnp.where(valid_obs[..., None], dirs, 0.0)
    nsum = jnp.sum(dirs, axis=1)
    normal = nsum / jnp.linalg.norm(nsum, axis=-1, keepdims=True).clip(1e-9)
    lm_normal = jnp.where(has_obs[:, None], normal, m.lm_normal)
    # scale band from the reference observation (slot 0)
    ref_kf = kf_idx[:, 0]
    ref_feat = m.lm_obs_feat[:, 0]
    dist_ref = jnp.linalg.norm(m.lm_pw - Ow[ref_kf], axis=-1)
    octv = m.kf_octave[ref_kf, ref_feat]
    dmax = dist_ref * scale_at(octv)
    dmin = dmax / float(SCALE_FACTORS[N_LEVELS - 1])
    lm_dmax = jnp.where(has_obs, dmax, m.lm_dmax)
    lm_dmin = jnp.where(has_obs, dmin, m.lm_dmin)
    return m._replace(lm_desc=lm_desc, lm_normal=lm_normal,
                      lm_dmax=lm_dmax, lm_dmin=lm_dmin)


@partial(jax.jit, donate_argnums=0)
def refresh_landmarks_for_kf(m: MapState, kf) -> MapState:
    """refresh_landmarks restricted to the landmarks observed by keyframe
    ``kf`` — the set a keyframe-maintenance step actually touches (insert /
    fuse / triangulate / merge all leave their marks in the kf's back-ref
    row). The reference likewise recomputes descriptors and normals only
    for affected points (LocalMapping.cc:166-170, ORBmatcher::Fuse
    callers); the global pass stays available for init and loop paths.
    Cost is O(n_feat · D²) instead of O(L · D²)."""
    from ..ops.hamming import hamming_pair
    L, D = m.lm_obs_kf.shape
    ids = m.kf_lm[kf]  # [N]
    sel = jnp.clip(ids, 0)
    g_ok = (ids >= 0) & m.kf_feat_valid[kf] & m.lm_valid[sel]
    obs_kf = m.lm_obs_kf[sel]  # [N, D]
    obs_feat = m.lm_obs_feat[sel]
    valid_obs = (obs_kf >= 0) & g_ok[:, None]
    kf_idx = jnp.clip(obs_kf, 0)
    descs = m.kf_desc[kf_idx, obs_feat]  # [N, D, 8]
    dmat = hamming_pair(descs[:, :, None, :], descs[:, None, :, :])
    big = 10_000
    pair_ok = valid_obs[:, :, None] & valid_obs[:, None, :]
    dmat = jnp.where(pair_ok, dmat, big)
    srt = jnp.sort(dmat, axis=2)
    cnt = jnp.sum(valid_obs, axis=1)
    mid = jnp.clip((cnt - 1) // 2, 0, D - 1)
    med = jnp.take_along_axis(srt, mid[:, None, None].repeat(D, 1), axis=2)[..., 0]
    med = jnp.where(valid_obs, med, big)
    best = jnp.argmin(med, axis=1)
    new_desc = jnp.take_along_axis(descs, best[:, None, None].repeat(8, 2), axis=1)[:, 0]
    Ow = -jnp.einsum("kij,ki->kj", m.kf_R, m.kf_t)
    pw = m.lm_pw[sel]
    dirs = pw[:, None, :] - Ow[kf_idx]
    norms = jnp.linalg.norm(dirs, axis=-1).clip(1e-9)
    dirs = jnp.where(valid_obs[..., None], dirs / norms[..., None], 0.0)
    nsum = jnp.sum(dirs, axis=1)
    normal = nsum / jnp.linalg.norm(nsum, axis=-1, keepdims=True).clip(1e-9)
    ref_kf = kf_idx[:, 0]
    ref_feat = obs_feat[:, 0]
    dist_ref = jnp.linalg.norm(pw - Ow[ref_kf], axis=-1)
    octv = m.kf_octave[ref_kf, ref_feat]
    dmax = dist_ref * scale_at(octv)
    dmin = dmax / float(SCALE_FACTORS[N_LEVELS - 1])
    upd = g_ok & (cnt > 0)
    return m._replace(
        lm_desc=m.lm_desc.at[sel].set(
            jnp.where(upd[:, None], new_desc, m.lm_desc[sel])),
        lm_normal=m.lm_normal.at[sel].set(
            jnp.where(upd[:, None], normal, m.lm_normal[sel])),
        lm_dmax=m.lm_dmax.at[sel].set(jnp.where(upd, dmax, m.lm_dmax[sel])),
        lm_dmin=m.lm_dmin.at[sel].set(jnp.where(upd, dmin, m.lm_dmin[sel])),
    )


# ---------------------------------------------------------------------------
# fused per-frame tracking megastep (one device call per tracked frame)
# ---------------------------------------------------------------------------

class FrameStepResult(NamedTuple):
    map: MapState
    R: jax.Array
    t: jax.Array
    lm: jax.Array  # [N] per-feature landmark assignment after local-map opt
    feats: FeatureSet
    depth: jax.Array
    stats: jax.Array  # int32 [6]: [mm_inliers, used_mm, track1_inliers,
    #                               local_inliers, ref_matches,
    #                               tracked_close*10000 + non_tracked_close]
    # derived poses computed in-step so the host epilogue does zero device
    # dispatches: velocity T_cur * T_prev^-1 (motion model for the next
    # frame) and T_cur * T_ref^-1 (relative-pose trajectory log,
    # reference: mlRelativeFramePoses Tracking.cc:562-579)
    vel_R: jax.Array
    vel_t: jax.Array
    Rcr: jax.Array
    tcr: jax.Array


def extract_rgbd_features(extractor, cam, img, depth_map, depth_factor,
                          width: int, height: int, undist_cam=None):
    """Shared frame prep: ORB extraction + depth sampling with the
    occlusion-boundary gate + mvuRight synthesis. Returns (feats, d).

    ``undist_cam``: optional models.camera.PinholeCamera carrying radtan
    distortion — keypoints are undistorted AFTER depth sampling (the depth
    image is aligned with the raw image) and BEFORE mvuRight synthesis
    (reference: Frame::UndistortKeyPoints Frame.cc:434-469, RGB-D mvuRight
    from undistorted keypoints Frame.cc:687-698).

    Raw depth (e.g. uint16 millimeters) -> float32 meters on device
    (reference: DepthMapFactor convertTo, Tracking.cc:144-148) — uploading
    raw integers keeps the per-frame host->device transfer small. The
    depth-edge gate rejects corners whose 3x3 depth neighborhood is
    inconsistent (>4% spread or invalid): occlusion-boundary corners flip
    between foreground and background depth with sub-pixel motion and
    poison landmarks.
    """
    depth_map = depth_map.astype(jnp.float32) * depth_factor
    feats_raw = extractor._extract(img)
    xy = feats_raw.xy
    # dense 3x3 min/max maps via 8 shifted elementwise ops, then ONE
    # one-hot-matmul point sampling (in place of 9 gathers)
    yi = jnp.clip(jnp.round(xy[:, 1]).astype(jnp.int32), 0, height - 1)
    xi = jnp.clip(jnp.round(xy[:, 0]).astype(jnp.int32), 0, width - 1)
    dmin_map = depth_map
    dmax_map = depth_map
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dy == 0 and dx == 0:
                continue
            sh = jnp.roll(depth_map, (dy, dx), axis=(0, 1))
            dmin_map = jnp.minimum(dmin_map, sh)
            dmax_map = jnp.maximum(dmax_map, sh)
    from ..ops.patches import sample_maps
    sampled = sample_maps(
        jnp.stack([depth_map, dmin_map, dmax_map]),
        jnp.stack([yi, xi], axis=-1))
    d, dmin, dmax = sampled[:, 0], sampled[:, 1], sampled[:, 2]
    edge = (dmin <= 0) | ((dmax - dmin) > 0.04 * jnp.clip(d, 1e-6, None))
    d = jnp.where((d > 0) & ~edge, d, -1.0)
    if undist_cam is not None:
        xy = undist_cam.undistort_points(xy)
    ur = jnp.where(d > 0, xy[:, 0] - cam.bf / jnp.clip(d, 1e-6, None), -1.0)
    feats = FeatureSet(xy, ur, feats_raw.octave, feats_raw.angle,
                       feats_raw.desc, feats_raw.valid)
    return feats, d


def track_frame_core(cam, m: MapState, prev: FrameObs, last_R, last_t,
                     vel_R, vel_t, have_vel, ref_kf, feats: FeatureSet, d,
                     th_depth, desc_th, desc_th_local, min_obs,
                     width: int, height: int,
                     th_local=None) -> FrameStepResult:
    """The fused steady-state tracking body over prepared features:
    motion model (with widened retry) -> reference-KF fallback ->
    local-map tracking -> keyframe-decision statistics. ``have_vel``
    may be a python bool (static: dead branch pruned at trace time) or a
    traced bool (both paths computed, result selected — keeps control
    flow out of the program)."""
    static_vel = isinstance(have_vel, bool)
    if (not static_vel) or have_vel:
        # The three pose solves (motion model at 7 px + widened 14 px
        # retry + reference-keyframe fallback) share no data dependency:
        # batch them into ONE vmapped 40-iteration LM instead of three
        # sequential ones (the serial LM chain is the step's latency
        # floor; the per-iteration work is tiny either way).
        R_pred, t_pred = se3.compose(vel_R, vel_t, last_R, last_t)
        lm_mm1 = _match_motion_model(
            cam, m, prev, feats, R_pred, t_pred, jnp.float32(7.0),
            jnp.float32(width), jnp.float32(height), desc_th)
        lm_mm2 = _match_motion_model(
            cam, m, prev, feats, R_pred, t_pred, jnp.float32(14.0),
            jnp.float32(width), jnp.float32(height), desc_th)
        lm_ref = _match_reference_kf(m, ref_kf, feats)
        frame_lms = jnp.stack([lm_mm1, lm_mm2, lm_ref])
        R0s = jnp.stack([R_pred, R_pred, last_R])
        t0s = jnp.stack([t_pred, t_pred, last_t])
        batched = jax.vmap(
            _pose_optimize_from_matches,
            in_axes=(None, None, None, 0, 0, 0))(
                cam, m, feats, frame_lms, R0s, t0s)
        mm1, mm2, ref = (jax.tree.map(lambda a, i=i: a[i], batched)
                         for i in range(3))
        mm_ok1 = mm1.n_inliers >= 10
        mm = jax.tree.map(
            lambda a, b: jnp.where(mm_ok1, a, b), mm1, mm2)
        # reference gates: motion model needs >=20 raw matches AND >=10
        # post-opt inliers (Tracking.cc:1027,1062)
        mm_ok = (mm.n_matches >= 20) & (mm.n_inliers >= 10)
        if not static_vel:
            mm_ok = mm_ok & have_vel
    else:
        mm = None
        ref = track_reference_keyframe(cam, m, ref_kf, feats, last_R, last_t)
    if (not static_vel) or have_vel:
        # The reference tries the motion model first and falls back to the
        # reference keyframe only on failure (Tracking.cc:341-352). Both
        # are computed here anyway (masked dense work costs the same), so
        # select the STRONGER accepted result — a marginal motion-model
        # pose (e.g. 12 inliers under fast motion) must not shadow a
        # 100-inlier reference-KF solve; the weak pose corrupts the
        # keyframe it seeds and collapses the next frame's local tracking.
        ref_ok = (ref.n_matches >= 15) & (ref.n_inliers >= 10)
        use_mm = mm_ok & (~ref_ok | (mm.n_inliers >= ref.n_inliers))
        res = jax.tree.map(lambda a, b: jnp.where(use_mm, a, b), mm, ref)
        used_mm = use_mm.astype(jnp.int32)
        mm_inliers = mm.n_inliers
    else:
        res = ref
        used_mm = jnp.int32(0)
        mm_inliers = jnp.int32(0)
    local_mask = local_landmark_mask(m, ref_kf)
    # local-map search radius: th=3 RGB-D default; the host passes 5.0
    # within 2 frames of a relocalization (reference: Tracking.cc:1393-1399)
    if th_local is None:
        th_local = jnp.float32(3.0)
    res2, m = track_local_map(cam, m, feats, res.lm, res.R, res.t,
                              local_mask, th_local, width, height,
                              desc_th_local)
    # keyframe-decision statistics (reference: Tracking.cc:1140-1244)
    from ..ops.patches import take_rows
    ref_lm = m.kf_lm[ref_kf]
    has_ref = (ref_lm >= 0) & m.kf_feat_valid[ref_kf]
    lm_table = jnp.stack(
        [jnp.sum((m.lm_obs_kf >= 0), axis=1).astype(jnp.float32),
         m.lm_valid.astype(jnp.float32)], axis=1)  # [L, 2]
    picked = take_rows(lm_table, jnp.clip(ref_lm, 0))
    nobs = picked[:, 0].astype(jnp.int32)
    ref_matches = jnp.sum(
        (has_ref & (nobs >= min_obs)
         & (picked[:, 1] > 0)).astype(jnp.int32))
    close = (d > 0) & (d < th_depth)
    tracked_close = jnp.sum((close & (res2.lm >= 0)).astype(jnp.int32))
    non_tracked_close = jnp.sum((close & (res2.lm < 0)).astype(jnp.int32))
    stats = jnp.stack([
        mm_inliers, used_mm,
        res.n_inliers, res2.n_inliers, ref_matches,
        tracked_close * 10000 + non_tracked_close,
    ]).astype(jnp.int32)
    new_vel = se3.compose(res2.R, res2.t, *se3.inverse(last_R, last_t))
    rel = se3.compose(res2.R, res2.t,
                      *se3.inverse(m.kf_R[ref_kf], m.kf_t[ref_kf]))
    return FrameStepResult(m, res2.R, res2.t, res2.lm, feats, d, stats,
                           new_vel[0], new_vel[1], rel[0], rel[1])


def build_track_frame_step(extractor, width: int, height: int,
                           undist_cam=None):
    """Build the fused per-frame step (extraction -> depth gating ->
    tracking core) as ONE jitted program returning one small stats vector
    (SURVEY.md §2.5 P1: vectorized pipeline stages instead of threads)."""

    @partial(jax.jit, donate_argnums=(1,),
             static_argnames=("have_vel",))
    def step(cam, m: MapState, prev: FrameObs, last_R, last_t,
             vel_R, vel_t, have_vel: bool, ref_kf, img, depth_map,
             depth_factor, th_depth, desc_th, desc_th_local,
             min_obs, th_local) -> FrameStepResult:
        feats, d = extract_rgbd_features(
            extractor, cam, img, depth_map, depth_factor, width, height,
            undist_cam)
        return track_frame_core(
            cam, m, prev, last_R, last_t, vel_R, vel_t, have_vel, ref_kf,
            feats, d, th_depth, desc_th, desc_th_local, min_obs,
            width, height, th_local)

    return step


@partial(jax.jit, static_argnames=("width", "height", "into"), donate_argnums=0)
def fuse_neighbors(m: MapState, cam, kf, neighbors, width: int, height: int,
                   into: bool) -> MapState:
    """Batched SearchInNeighbors direction pass over up to len(neighbors)
    covisible keyframes in ONE device call (neighbors padded with -1).
    into=True: project each neighbor's landmarks into ``kf``;
    into=False: project ``kf``'s landmarks into each neighbor.

    Observations are added per neighbor, but the duplicate MERGES are
    accumulated across the whole pass and resolved by ONE merge_landmarks
    call at the end: each merge rebuilds the [K*N] observation table (a
    full sort), and per-neighbor merging made the keyframe step pay G
    rebuilds (the map-building hot spot). Merge direction comes from the
    observation counts at pass start — a consistent total order (count,
    then lower slot), so the batched merge graph is acyclic."""
    from ..matching.search import LandmarkSet, fuse_candidates
    from ..mapstate.map import landmark_obs_count, merge_landmarks
    G = neighbors.shape[0]
    N = m.kf_lm.shape[1]
    nobs0 = landmark_obs_count(m)  # direction-deciding snapshot

    def body(i, carry):
        mm, keeps, kills, oks = carry
        j = neighbors[i]
        src_kf, dst_kf = (j, kf) if into else (kf, j)

        def do(args):
            mm, keeps, kills, oks = args
            lm_ids = mm.kf_lm[src_kf]  # [N]
            safe = jnp.clip(lm_ids, 0)
            has = (lm_ids >= 0) & mm.kf_feat_valid[src_kf] & mm.lm_valid[safe]
            lmset = LandmarkSet(
                mm.lm_pw[safe], mm.lm_normal[safe], mm.lm_dmin[safe],
                mm.lm_dmax[safe], mm.lm_desc[safe], has)
            feats_b = FeatureSet(
                mm.kf_xy[dst_kf], mm.kf_ur[dst_kf], mm.kf_octave[dst_kf],
                mm.kf_angle[dst_kf], mm.kf_desc[dst_kf],
                mm.kf_feat_valid[dst_kf])
            idx, dist, matched = fuse_candidates(
                cam, mm.kf_R[dst_kf], mm.kf_t[dst_kf], lmset, feats_b,
                width, height)
            feat_free = mm.kf_lm[dst_kf, idx] < 0
            already = jnp.any(mm.lm_obs_kf[safe] == dst_kf, axis=1)
            ok = matched & feat_free & ~already & has
            mm = add_observation(mm, safe, jnp.full(N, dst_kf, jnp.int32),
                                 idx, ok)
            # duplicate: the matched dst feature already belongs to ANOTHER
            # landmark (reference: ORBmatcher::Fuse 1111-1114). Record the
            # pair; keep-direction by (nobs0, lower slot) total order.
            other = mm.kf_lm[dst_kf, idx]
            dup = matched & has & (other >= 0) & (other != lm_ids)
            so = jnp.clip(other, 0)
            self_wins = (nobs0[safe] > nobs0[so]) | (
                (nobs0[safe] == nobs0[so]) & (safe < so))
            keep = jnp.where(self_wins, lm_ids, other)
            kill = jnp.where(self_wins, other, lm_ids)
            keeps = keeps.at[i].set(jnp.clip(keep, 0))
            kills = kills.at[i].set(jnp.clip(kill, 0))
            oks = oks.at[i].set(dup)
            return mm, keeps, kills, oks

        return jax.lax.cond(j >= 0, do, lambda a: a,
                            (mm, keeps, kills, oks))

    init = (m, jnp.zeros((G, N), jnp.int32), jnp.zeros((G, N), jnp.int32),
            jnp.zeros((G, N), bool))
    m, keeps, kills, oks = jax.lax.fori_loop(0, G, body, init)
    return merge_landmarks(m, keeps.reshape(-1), kills.reshape(-1),
                           oks.reshape(-1))


@partial(jax.jit, static_argnames=("width", "height"), donate_argnums=0)
def keyframe_step(m: MapState, cam, obs: FrameObs, R, t, frame_id,
                  th_depth, width: int, height: int) -> MapState:
    """The ENTIRE keyframe maintenance chunk as one device call:
    insertion -> neighbor selection (top-5 covisible, on device) ->
    fuse neighbors into the new KF -> create depth landmarks for still-
    unmatched features -> fuse outward -> refresh landmark descriptors/
    normals -> cull recent landmarks -> local bundle adjustment.
    Replaces ~8 host-dispatched calls."""
    from ..mapstate.map import covisibility_weights
    k = m.n_kf
    m = insert_keyframe(m, cam, obs, R, t, frame_id)
    w = covisibility_weights(m, k)
    top_w, top_i = prims.sort_top_k(w, 10)
    cull_window = jnp.where(top_w > 0, top_i.astype(jnp.int32), -1)
    neighbors = cull_window[:5]
    m = fuse_neighbors(m, cam, k, neighbors, width, height, into=True)
    m = create_depth_landmarks(m, cam, k, th_depth)
    m = fuse_neighbors(m, cam, k, neighbors, width, height, into=False)
    m = merge_duplicate_landmarks(m, k)
    m = refresh_landmarks_for_kf(m, k)
    m = cull_landmarks(m, k)
    has_neighbors = jnp.any(neighbors >= 0)

    def run_ba(mm):
        return local_bundle_adjustment(mm, cam, k)

    m = jax.lax.cond(has_neighbors, run_ba, lambda mm: mm, m)
    # keyframe hygiene over the local covisibility window; landmark-slot
    # compaction is host-managed between frames (pipeline.tracking) so the
    # in-flight pipelined frames never see a surprise landmark permutation
    m = cull_keyframes(m, k, cull_window)
    return m
