"""The data-association search modes of the framework.

JAX rebuild of the 7 Search* + 2 Fuse entry points of the
reference's ORBmatcher (reference: include/ORBmatcher.h:48-83), recast as
pure array functions over SoA feature/landmark bundles. Candidate gating
(search windows, predicted scale levels, epipolar bands, chi2 gates) is a
[queries x features] boolean mask; matching is one masked Hamming sweep.
Thresholds and gates follow SURVEY.md §2.6 "Matching" line by line.

Scale conventions: scale_factors[l] = 1.2^l, sigma2[l] = 1.2^(2l).
Poses are world->camera (R, t). All functions are jit-safe.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp

from ..geometry import se3
from . import core

N_LEVELS = 8
SCALE = 1.2
# HOST (numpy) tables, embedded as compile-time HLO constants at use sites
# via jnp.asarray(...) inside traced code. Static integer indexing (e.g.
# SCALE_FACTORS[N_LEVELS - 1]) stays host-side numpy.
SCALE_FACTORS = np.asarray([SCALE ** i for i in range(N_LEVELS)], np.float32)
SIGMA2 = SCALE_FACTORS * SCALE_FACTORS
INV_SIGMA2 = (1.0 / SIGMA2).astype(np.float32)
LOG_SCALE = math.log(SCALE)


def scale_at(octave):
    """SCALE_FACTORS[octave] for traced ``octave`` (constant-table gather)."""
    return jnp.asarray(SCALE_FACTORS)[octave]


def sigma2_at(octave):
    """SIGMA2[octave] for traced ``octave`` (constant-table gather)."""
    return jnp.asarray(SIGMA2)[octave]


def inv_sigma2_at(octave):
    """INV_SIGMA2[octave] for traced ``octave`` (constant-table gather)."""
    return jnp.asarray(INV_SIGMA2)[octave]


class FeatureSet(NamedTuple):
    """Per-image SoA features (see frontend.FrameFeatures; xy undistorted)."""
    xy: jax.Array  # [N, 2] float32
    ur: jax.Array  # [N] float32 right-image u (<0 for mono observations)
    octave: jax.Array  # [N] int32
    angle: jax.Array  # [N] float32
    desc: jax.Array  # [N, 8] uint32
    valid: jax.Array  # [N] bool


class LandmarkSet(NamedTuple):
    """Candidate landmarks for projection searches."""
    pw: jax.Array  # [M, 3] world positions
    normal: jax.Array  # [M, 3] mean viewing direction
    dmin: jax.Array  # [M] scale-invariance min distance
    dmax: jax.Array  # [M] max distance
    desc: jax.Array  # [M, 8] representative descriptor
    valid: jax.Array  # [M] bool


def predict_scale(dist: jax.Array, dmax: jax.Array) -> jax.Array:
    """MapPoint::PredictScale (reference: MapPoint.cc:404-436)."""
    ratio = jnp.clip(dmax / jnp.clip(dist, 1e-6, None), 1.0, None)
    lvl = jnp.ceil(jnp.log(ratio) / LOG_SCALE).astype(jnp.int32)
    return jnp.clip(lvl, 0, N_LEVELS - 1)


class Frustum(NamedTuple):
    visible: jax.Array  # [M] bool
    uv: jax.Array  # [M, 2] projected pixel coords
    ur: jax.Array  # [M] predicted right-image u
    view_cos: jax.Array  # [M]
    level: jax.Array  # [M] predicted octave
    dist: jax.Array  # [M] camera-center distance


def frustum_check(cam, R, t, lm: LandmarkSet, width: int, height: int,
                  view_cos_limit: float = 0.5) -> Frustum:
    """Frame::isInFrustum (reference: Frame.cc:274-342): positive depth,
    in-bounds projection, distance inside [0.8 dmin, 1.2 dmax], viewing angle
    cos >= 0.5, predicted pyramid level."""
    Xc = se3.transform(R, t, lm.pw)
    z = Xc[..., 2]
    iz = 1.0 / jnp.where(jnp.abs(z) < 1e-9, 1e-9, z)
    u = cam.fx * Xc[..., 0] * iz + cam.cx
    v = cam.fy * Xc[..., 1] * iz + cam.cy
    ur = u - cam.bf * iz
    Ow = -jnp.einsum("ij,i->j", R, t)  # camera center (R^T t with sign)
    PO = lm.pw - Ow
    dist = jnp.linalg.norm(PO, axis=-1)
    view_cos = jnp.sum(PO * lm.normal, axis=-1) / jnp.clip(dist, 1e-9, None)
    level = predict_scale(dist, lm.dmax)
    visible = (
        lm.valid
        & (z > 0)
        & (u >= 0) & (u < width) & (v >= 0) & (v < height)
        & (dist >= 0.8 * lm.dmin) & (dist <= 1.2 * lm.dmax)
        & (view_cos >= view_cos_limit)
    )
    return Frustum(visible, jnp.stack([u, v], -1), ur, view_cos, level, dist)


def search_local_points(
    cam, R, t, lm: LandmarkSet, fr: Frustum, feats: FeatureSet,
    th: float = 1.0, ratio: float = 0.8, already_matched=None,
    desc_th: int = core.TH_HIGH,
):
    """SearchByProjection vs the local map (reference: ORBmatcher.cc:59-155).

    radius = (2.5 if viewCos>0.998 else 4.0) * th * scaleFactor[predicted];
    feature octave in [pred-1, pred]; stereo rows also gate |ur - ur_pred|;
    best <= TH_HIGH; ratio applied only when best and runner-up share a level
    — matching the reference's bestLevel==bestLevel2 condition.

    Returns (feat_idx [M], dist [M], matched [M]).
    """
    r = jnp.where(fr.view_cos > 0.998, 2.5, 4.0)
    radius = r * th * scale_at(fr.level)
    du = feats.xy[None, :, 0] - fr.uv[:, None, 0]
    dv = feats.xy[None, :, 1] - fr.uv[:, None, 1]
    in_win = (jnp.abs(du) < radius[:, None]) & (jnp.abs(dv) < radius[:, None])
    lvl_ok = (feats.octave[None, :] >= fr.level[:, None] - 1) & (
        feats.octave[None, :] <= fr.level[:, None]
    )
    stereo_ok = jnp.where(
        feats.ur[None, :] >= 0,
        jnp.abs(feats.ur[None, :] - fr.ur[:, None]) < radius[:, None],
        True,
    )
    mask = in_win & lvl_ok & stereo_ok & fr.visible[:, None] & feats.valid[None, :]
    if already_matched is not None:
        mask &= ~already_matched[None, :]
    # Ratio gate conditional on levels: compute best two and their levels.
    dist = core.distance_matrix(lm.desc, feats.desc)
    best, idx, second = core.masked_best_two(dist, mask)
    # second-best index from a masked re-argmin (top_k lowers ~40x slower)
    d2 = jnp.where(mask, dist, core.BIG)
    cols = jnp.arange(d2.shape[1], dtype=jnp.int32)
    idx2 = jnp.argmin(
        jnp.where(cols[None, :] == idx[:, None], core.BIG, d2), axis=1)
    lvl_b = feats.octave[idx]
    lvl_s = feats.octave[idx2]
    matched = best <= desc_th
    same_level = lvl_b == lvl_s
    matched &= jnp.where(same_level, core.ratio_ok(best, second, ratio), True)
    matched &= core.dedupe_matches(idx, best, matched, feats.desc.shape[0])
    return idx, best, matched


def search_by_projection_frame(
    cam, R, t, prev_pw: jax.Array, prev_feats: FeatureSet, prev_has_point: jax.Array,
    feats: FeatureSet, th: float, width: int, height: int, forward: bool, backward: bool,
    desc_th: int = core.TH_HIGH,
):
    """SearchByProjection vs the last frame, motion model (reference:
    ORBmatcher.cc:1540+): project last frame's landmarks, window radius
    th * scaleFactor[last octave], forward/backward octave logic from the
    z-translation, TH_HIGH, rotation-histogram check, no ratio test.

    prev_pw: [Q, 3] landmark positions of last-frame features.
    Returns (feat_idx [Q], dist [Q], matched [Q]).
    """
    Xc = se3.transform(R, t, prev_pw)
    z = Xc[..., 2]
    iz = 1.0 / jnp.where(jnp.abs(z) < 1e-9, 1e-9, z)
    u = cam.fx * Xc[..., 0] * iz + cam.cx
    v = cam.fy * Xc[..., 1] * iz + cam.cy
    ur_pred = u - cam.bf * iz
    in_img = (z > 0) & (u >= 0) & (u < width) & (v >= 0) & (v < height)
    radius = th * scale_at(prev_feats.octave)
    du = feats.xy[None, :, 0] - u[:, None]
    dv = feats.xy[None, :, 1] - v[:, None]
    in_win = (jnp.abs(du) < radius[:, None]) & (jnp.abs(dv) < radius[:, None])
    oq = prev_feats.octave[:, None]
    ot = feats.octave[None, :]
    if forward:
        lvl_ok = ot >= oq
    elif backward:
        lvl_ok = ot <= oq
    else:
        lvl_ok = (ot >= oq - 1) & (ot <= oq + 1)
    stereo_ok = jnp.where(
        feats.ur[None, :] >= 0,
        jnp.abs(feats.ur[None, :] - ur_pred[:, None]) < radius[:, None],
        True,
    )
    mask = (
        in_win & lvl_ok & stereo_ok
        & (in_img & prev_has_point & prev_feats.valid)[:, None]
        & feats.valid[None, :]
    )
    idx, best, matched = core.windowed_match(
        prev_feats.desc, feats.desc, mask, desc_th,
        ratio=None, angle_q=prev_feats.angle, angle_t=feats.angle)
    return idx, best, matched


def search_brute(
    desc_q, desc_t, valid_q, valid_t, ratio: float, max_dist: int = core.TH_LOW,
    angle_q=None, angle_t=None,
):
    """BoW-bucketed matching, accelerator style (reference:
    ORBmatcher.cc:211-344 SearchByBoW). The inverted-file bucketing was a
    CPU pruning trick; here the full masked Hamming sweep is one fused op,
    a strict superset of the bucketed candidate set."""
    mask = valid_q[:, None] & valid_t[None, :]
    return core.windowed_match(
        desc_q, desc_t, mask, max_dist, ratio=ratio,
        angle_q=angle_q, angle_t=angle_t)


def search_for_initialization(
    feats1: FeatureSet, feats2: FeatureSet, prev_xy: jax.Array,
    window: float = 100.0, ratio: float = 0.9,
):
    """Monocular initialization matching (reference: ORBmatcher.cc:493+):
    level-0 features only, window around the previously matched position,
    TH_LOW, ratio 0.9, rotation consistency, duplicate resolution."""
    du = feats2.xy[None, :, 0] - prev_xy[:, None, 0]
    dv = feats2.xy[None, :, 1] - prev_xy[:, None, 1]
    in_win = (jnp.abs(du) < window) & (jnp.abs(dv) < window)
    lvl = (feats1.octave[:, None] == 0) & (feats2.octave[None, :] == 0)
    mask = in_win & lvl & feats1.valid[:, None] & feats2.valid[None, :]
    return core.windowed_match(
        feats1.desc, feats2.desc, mask, core.TH_LOW, ratio=ratio,
        angle_q=feats1.angle, angle_t=feats2.angle)


def search_for_triangulation(
    cam, feats1: FeatureSet, feats2: FeatureSet,
    free1: jax.Array, free2: jax.Array,
    F12: jax.Array, e2_xy: jax.Array,
    ratio: float = 0.6,
):
    """Epipolar-constrained matching for new-point triangulation (reference:
    ORBmatcher.cc:783-975): features without landmarks only, TH_LOW + ratio,
    epipolar distance gate d^2 < 3.84 sigma2[octave2]
    (CheckDistEpipolarLine, :173-196), epipole-proximity reject
    (:892-897; skipped for stereo-stereo pairs), no rotation check
    (the call site constructs ORBmatcher(0.6, false)).

    F12: fundamental matrix st. x2^T F12^T ... (we use l2 = F12^T x1).
    e2_xy: [2] epipole of camera 1 in image 2.
    """
    ones1 = jnp.ones_like(feats1.xy[:, :1])
    x1h = jnp.concatenate([feats1.xy, ones1], axis=-1)  # [N1, 3]
    l2 = x1h @ F12  # [N1, 3] epipolar lines in image 2 (a, b, c)
    a, b, c = l2[:, 0:1], l2[:, 1:2], l2[:, 2:3]
    num = a * feats2.xy[None, :, 0] + b * feats2.xy[None, :, 1] + c
    den = a * a + b * b
    dsq = (num * num) / jnp.clip(den, 1e-12, None)
    epi_ok = dsq < 3.84 * sigma2_at(feats2.octave)[None, :]
    # Epipole proximity: kp2 must not sit on the epipole (unless both stereo).
    dex = feats2.xy[:, 0] - e2_xy[0]
    dey = feats2.xy[:, 1] - e2_xy[1]
    far = (dex * dex + dey * dey) >= 100.0 * scale_at(feats2.octave)
    both_stereo = (feats1.ur[:, None] >= 0) & (feats2.ur[None, :] >= 0)
    epi_far_ok = jnp.where(both_stereo, True, far[None, :])
    mask = (
        epi_ok & epi_far_ok
        & (free1 & feats1.valid)[:, None]
        & (free2 & feats2.valid)[None, :]
    )
    return core.windowed_match(
        feats1.desc, feats2.desc, mask, core.TH_LOW, ratio=ratio)


def search_by_sim3(
    cam, R12, t12, s12, R1w, t1w, R2w, t2w,
    lm1: LandmarkSet, lm2: LandmarkSet,
    feats1: FeatureSet, feats2: FeatureSet,
    lm1_feat: jax.Array, lm2_feat: jax.Array,
    th: float = 7.5,
):
    """Mutual Sim3 cross-projection matching (reference: ORBmatcher.cc:1285+
    SearchBySim3): project KF2 landmarks into KF1 via S12 and vice versa,
    radius th * scaleFactor[predicted], TH_HIGH, no ratio test, and keep
    only mutually consistent pairs.

    lm1_feat/lm2_feat: [M] feature index of each landmark in its keyframe.
    Returns (idx_2for1 [M1], matched [M1]) giving, per landmark of KF1, the
    matched landmark index of KF2.
    """
    def project_side(Rrel, trel, srel, Rw, tw, lm_src: LandmarkSet, feats_dst, th_):
        Xc_src = se3.transform(Rw, tw, lm_src.pw)  # into source camera frame
        Xc_dst = srel[..., None] * jnp.einsum("ij,mj->mi", Rrel, Xc_src) + trel
        z = Xc_dst[:, 2]
        iz = 1.0 / jnp.where(jnp.abs(z) < 1e-9, 1e-9, z)
        u = cam.fx * Xc_dst[:, 0] * iz + cam.cx
        v = cam.fy * Xc_dst[:, 1] * iz + cam.cy
        dist = jnp.linalg.norm(Xc_dst, axis=-1)
        lvl = predict_scale(dist, lm_src.dmax)
        ok = (z > 0) & (dist >= lm_src.dmin) & (dist <= lm_src.dmax) & lm_src.valid
        radius = th_ * scale_at(lvl)
        du = feats_dst.xy[None, :, 0] - u[:, None]
        dv = feats_dst.xy[None, :, 1] - v[:, None]
        in_win = (jnp.abs(du) < radius[:, None]) & (jnp.abs(dv) < radius[:, None])
        lvl_ok = (feats_dst.octave[None, :] >= lvl[:, None] - 1) & (
            feats_dst.octave[None, :] <= lvl[:, None] + 1)
        mask = in_win & lvl_ok & ok[:, None] & feats_dst.valid[None, :]
        d = core.distance_matrix(lm_src.desc, feats_dst.desc)
        best, idx, _ = core.masked_best_two(d, mask)
        return idx, best <= core.TH_HIGH

    # KF2 landmarks seen in image 1  /  KF1 landmarks seen in image 2
    R21, t21, s21 = (
        jnp.swapaxes(R12, -1, -2),
        -jnp.einsum("ji,j->i", R12, t12) / s12,
        1.0 / s12,
    )
    idx_f1_of_lm2, ok21 = project_side(R12, t12, s12, R2w, t2w, lm2, feats1, th)
    idx_f2_of_lm1, ok12 = project_side(R21, t21, s21, R1w, t1w, lm1, feats2, th)
    if lm1_feat is None and lm2_feat is None:
        # identity layout (landmark row i IS feature i, the per-feature
        # keyframe bundles of the loop closers): no feature->landmark
        # scatter needed.
        lm2_of_lm1 = jnp.where(ok12, idx_f2_of_lm1, -1)
        lm1_of_lm2 = jnp.where(ok21, idx_f1_of_lm2, -1)
    else:
        # feature index -> landmark index maps
        n1 = feats1.desc.shape[0]
        n2 = feats2.desc.shape[0]
        feat2lm1 = jnp.full(n1, -1, jnp.int32).at[lm1_feat].set(
            jnp.arange(lm1_feat.shape[0], dtype=jnp.int32))
        feat2lm2 = jnp.full(n2, -1, jnp.int32).at[lm2_feat].set(
            jnp.arange(lm2_feat.shape[0], dtype=jnp.int32))
        # lm1 -> feature in 2 -> lm2 ; check lm2 -> feature in 1 -> lm1
        lm2_of_lm1 = jnp.where(ok12, feat2lm2[idx_f2_of_lm1], -1)
        lm1_of_lm2 = jnp.where(ok21, feat2lm1[idx_f1_of_lm2], -1)
    n_lm1 = (lm1.pw.shape[0] if lm1_feat is None else lm1_feat.shape[0])
    m1 = jnp.arange(n_lm1, dtype=jnp.int32)
    mutual = (lm2_of_lm1 >= 0) & (
        jnp.take(lm1_of_lm2, jnp.clip(lm2_of_lm1, 0, lm1_of_lm2.shape[0] - 1)) == m1
    )
    return lm2_of_lm1, mutual


def search_by_scw_projection(
    cam, Rcw, tcw, scw, lm: LandmarkSet, feats: FeatureSet,
    already_matched, width: int, height: int, th: float = 10.0,
):
    """Sim3 world->camera projection search (reference: ORBmatcher.cc:359-478
    SearchByProjection(KF, Scw, vpPoints, vpMatched, th) — the loop-group
    landmark projection of ComputeSim3, LoopClosing.cc:459-471).

    The Sim3 (s R | t) is decomposed like the reference (:367-370):
    Rcw stays, tcw/scw is the SE3 translation, Ow = -Rcw^T tcw/scw.
    Gates: z > 0, in-image, world distance within [dmin, dmax], viewing
    cos >= 0.5, feature level in [pred-1, pred], window radius
    th * scaleFactor[pred], best Hamming <= TH_LOW, no ratio test; target
    features carrying a match already are excluded (vpMatched[idx] check).

    Returns (feat_idx [M], matched [M]) — per landmark, the matched feature
    of the keyframe. Distinct-feature counting is the caller's job (two
    landmarks can pick the same feature in the batched sweep; the
    reference's sequential first-writer-wins makes them distinct).
    """
    t_se3 = tcw / jnp.clip(scw, 1e-12, None)
    Xc = se3.transform(Rcw, t_se3, lm.pw)
    z = Xc[:, 2]
    iz = 1.0 / jnp.where(jnp.abs(z) < 1e-9, 1e-9, z)
    u = cam.fx * Xc[:, 0] * iz + cam.cx
    v = cam.fy * Xc[:, 1] * iz + cam.cy
    Ow = -jnp.einsum("ij,i->j", Rcw, t_se3)
    PO = lm.pw - Ow
    dist = jnp.linalg.norm(PO, axis=-1)
    view_cos = jnp.sum(PO * lm.normal, axis=-1) / jnp.clip(dist, 1e-9, None)
    lvl = predict_scale(dist, lm.dmax)
    ok = (lm.valid & (z > 0)
          & (u >= 0) & (u < width) & (v >= 0) & (v < height)
          & (dist >= lm.dmin) & (dist <= lm.dmax)
          & (view_cos >= 0.5))
    radius = th * scale_at(lvl)
    du = feats.xy[None, :, 0] - u[:, None]
    dv = feats.xy[None, :, 1] - v[:, None]
    in_win = (jnp.abs(du) < radius[:, None]) & (jnp.abs(dv) < radius[:, None])
    lvl_ok = ((feats.octave[None, :] >= lvl[:, None] - 1)
              & (feats.octave[None, :] <= lvl[:, None]))
    mask = (in_win & lvl_ok & ok[:, None] & feats.valid[None, :]
            & ~already_matched[None, :])
    d = core.distance_matrix(lm.desc, feats.desc)
    best, idx, _ = core.masked_best_two(d, mask)
    return idx, best <= core.TH_LOW


def fuse_candidates(
    cam, R, t, lm: LandmarkSet, feats: FeatureSet,
    width: int, height: int, th: float = 3.0,
):
    """Fuse projection matching (reference: ORBmatcher.cc:977+): project
    landmarks into a keyframe, gate by frustum + chi2 reprojection
    (5.99 mono / 7.8 stereo with level sigma), level in [pred-1, pred],
    radius th * scaleFactor[pred], best <= TH_LOW.

    Returns (feat_idx [M], dist [M], matched [M]) — the caller decides
    replace-vs-add using observation counts (reference :1111-1114).
    """
    fr = frustum_check(cam, R, t, lm, width, height)
    radius = th * scale_at(fr.level)
    du = feats.xy[None, :, 0] - fr.uv[:, None, 0]
    dv = feats.xy[None, :, 1] - fr.uv[:, None, 1]
    in_win = (jnp.abs(du) < radius[:, None]) & (jnp.abs(dv) < radius[:, None])
    lvl_ok = (feats.octave[None, :] >= fr.level[:, None] - 1) & (
        feats.octave[None, :] <= fr.level[:, None])
    # chi2 gate on the actual reprojection error
    err2 = du * du + dv * dv
    dur = fr.ur[:, None] - feats.ur[None, :]
    e2_stereo = err2 + dur * dur
    inv_s2 = inv_sigma2_at(feats.octave)[None, :]
    chi_ok = jnp.where(
        feats.ur[None, :] >= 0,
        e2_stereo * inv_s2 <= 7.8,
        err2 * inv_s2 <= 5.99,
    )
    mask = in_win & lvl_ok & chi_ok & fr.visible[:, None] & feats.valid[None, :]
    d = core.distance_matrix(lm.desc, feats.desc)
    best, idx, _ = core.masked_best_two(d, mask)
    matched = best <= core.TH_LOW
    matched &= core.dedupe_matches(idx, best, matched, feats.desc.shape[0])
    return idx, best, matched
