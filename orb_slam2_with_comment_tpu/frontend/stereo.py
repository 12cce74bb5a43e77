"""Stereo feature depth: rectified row-band descriptor match + SAD refine.

JAX rebuild of Frame::ComputeStereoMatches (reference:
src/Frame.cc:501-675). The reference loops left keypoints over a per-row
candidate table; here the whole association is one masked dense Hamming
matrix (row-band, octave-band and disparity-range masks), followed by a
vectorized subpixel correlation sweep (11x11 SAD over +-5 shifts with
parabola refinement, reference Frame.cc:586-643) and the median-distance
outlier sweep (reference Frame.cc:661-674).

All shapes are static: N_left x N_right distance matrix, per-level blocks
of keypoints (the extractor lays keypoints out level-contiguously with
static budgets), fixed 11x21 right-image strips.
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..ops import hamming, image

W = 5            # SAD half-window (reference: const int w = 5, Frame.cc:593)
L = 5            # shift search range (reference: const int L = 5, Frame.cc:600)
TH_ORB = 75.0    # (TH_HIGH + TH_LOW)/2 (reference: Frame.cc:540)


class StereoDepth(NamedTuple):
    u_right: jax.Array  # [N] float32 refined right u, -1 if no match
    depth: jax.Array    # [N] float32 depth from disparity, -1 if no match


def _sad_refine_block(pyr_l: jax.Array, pyr_r: jax.Array, inv_scale: float,
                      xy_l: jax.Array, u_r0: jax.Array):
    """Subpixel correlation for one pyramid level's keypoint block.

    Patch reads are one-hot matmuls (ops.patches.extract_patches): the
    GEMM formulation batches every keypoint's window into one contraction
    in place of one gather per level per side.

    Returns (refined right-u in level pixels, best SAD, ok): shift not at
    the search edge, |delta| <= 1 (reference Frame.cc:611-636).
    """
    from ..ops import patches as patch_ops
    h, w = pyr_l.shape
    xl = xy_l[:, 0] * inv_scale
    yl = xy_l[:, 1] * inv_scale
    ur0 = jnp.round(u_r0 * inv_scale)
    yi = jnp.round(yl).astype(jnp.int32)
    xi = jnp.round(xl).astype(jnp.int32)
    uri = ur0.astype(jnp.int32)
    # match the original dynamic_slice corner clipping: the window corner
    # was clamped into the image, shifting the effective center
    yc = jnp.clip(yi - W, 0, h - (2 * W + 1)) + W
    xc = jnp.clip(xi - W, 0, w - (2 * W + 1)) + W
    # left 11x11 patch around (yc, xc)
    p_l = patch_ops.extract_patches(
        pyr_l[None], jnp.stack([yc, xc], axis=-1), W)[:, 0]  # [N, 11, 11]
    p_l = p_l - p_l[:, W:W + 1, W:W + 1]
    # right 11x(2W+2L+1) strip: extract a square of radius W+L at the
    # (possibly corner-clamped) strip center and slice the middle rows
    x0 = uri - W - L
    inb = (x0 >= 0) & (x0 + 2 * W + 2 * L + 1 <= w)
    x0c = jnp.clip(x0, 0, w - (2 * W + 2 * L + 1))
    strip_c = jnp.stack([yc, x0c + W + L], axis=-1)
    sq = patch_ops.extract_patches(pyr_r[None], strip_c, W + L)[:, 0]
    strip = sq[:, L:L + 2 * W + 1, :]  # [N, 11, 2W+2L+1]
    sads = []
    for o in range(2 * L + 1):
        win = jax.lax.slice_in_dim(strip, o, o + 2 * W + 1, axis=2)
        win = win - win[:, W:W + 1, W:W + 1]
        sads.append(jnp.sum(jnp.abs(p_l - win), axis=(1, 2)))
    sad = jnp.stack(sads, axis=-1)                     # [N, 2L+1]
    best = jnp.argmin(sad, axis=-1)
    edge = (best == 0) | (best == 2 * L)
    b = jnp.clip(best, 1, 2 * L - 1)
    take = lambda i: jnp.take_along_axis(sad, i[:, None], axis=1)[:, 0]
    d1, d2, d3 = take(b - 1), take(b), take(b + 1)
    denom = d1 + d3 - 2.0 * d2
    delta = jnp.where(denom > 0,
                      (d1 - d3) / (2.0 * jnp.clip(denom, 1e-9, None)), 2.0)
    ok = inb & ~edge & (jnp.abs(delta) <= 1.0)
    inc = (b.astype(jnp.float32) - L) + delta
    best_sad = take(best)
    return ur0 + inc, best_sad, ok


def match_stereo(feats_l, feats_r, pyr_l, pyr_r, budgets,
                 bf: jax.Array, fx: float) -> StereoDepth:
    """Row-band Hamming association + subpixel refine + outlier sweep.

    feats_l/feats_r: FrameFeatures (level-contiguous layout per ``budgets``).
    pyr_l/pyr_r: blurred pyramid levels (lists of 2D arrays).
    Returns per-left-feature refined right coordinate and depth.
    """
    scales = image.level_scales(len(pyr_l))
    dist = hamming.distance_matrix(feats_l.desc, feats_r.desc).astype(jnp.float32)
    ul = feats_l.xy[:, 0][:, None]
    vl = feats_l.xy[:, 1][:, None]
    ur = feats_r.xy[None, :, 0]
    vr = feats_r.xy[None, :, 1]
    oct_l = feats_l.octave[:, None]
    oct_r = feats_r.octave[None, :]
    # row band: r = 2 * scaleFactor[right octave] (reference Frame.cc:519)
    sc = jnp.asarray(scales, jnp.float32)
    r_band = 2.0 * sc[feats_r.octave][None, :]
    min_d = 0.0
    max_d = fx  # bf / b = fx (reference Frame.cc:530-533)
    mask = (
        feats_l.valid[:, None] & feats_r.valid[None, :]
        & (jnp.abs(vr - vl) <= r_band)
        & (oct_r >= oct_l - 1) & (oct_r <= oct_l + 1)
        & (ur >= ul - max_d) & (ur <= ul - min_d)
    )
    big = jnp.float32(1e9)
    dm = jnp.where(mask, dist, big)
    best_j = jnp.argmin(dm, axis=1)
    best_d = jnp.take_along_axis(dm, best_j[:, None], axis=1)[:, 0]
    matched = best_d < TH_ORB
    u_r0 = feats_r.xy[best_j, 0]

    # per-level subpixel refinement over static keypoint blocks
    n = feats_l.xy.shape[0]
    u_right = jnp.full(n, -1.0, jnp.float32)
    sad_best = jnp.full(n, jnp.inf, jnp.float32)
    ok_all = jnp.zeros(n, bool)
    off = 0
    for lvl, budget in enumerate(budgets):
        if budget <= 0:
            continue
        sl = slice(off, off + budget)
        ur_lvl, sad, ok = _sad_refine_block(
            pyr_l[lvl], pyr_r[lvl], 1.0 / scales[lvl],
            feats_l.xy[sl], u_r0[sl])
        u_right = u_right.at[sl].set(ur_lvl * scales[lvl])
        sad_best = sad_best.at[sl].set(sad)
        ok_all = ok_all.at[sl].set(ok)
        off += budget

    good = matched & ok_all
    disparity = feats_l.xy[:, 0] - u_right
    # disparity <= 0 is clamped to a tiny positive value (reference :650-653)
    tiny = disparity <= 0
    disparity = jnp.where(tiny, 0.01, disparity)
    u_right = jnp.where(tiny, feats_l.xy[:, 0] - 0.01, u_right)
    good &= disparity < max_d

    # median-distance outlier sweep (reference Frame.cc:661-674):
    # thDist = 1.5 * 1.4 * median(SAD best)
    sad_sorted = jnp.sort(jnp.where(good, sad_best, jnp.inf))
    n_good = jnp.sum(good)
    med = sad_sorted[jnp.clip(n_good // 2, 0, n - 1)]
    th = 1.5 * 1.4 * med
    good &= sad_best <= th

    depth = jnp.where(good, bf / disparity, -1.0)
    u_out = jnp.where(good, u_right, -1.0)
    return StereoDepth(u_out, depth)
