"""FAST-16 corner detection as dense vectorized maps.

JAX rebuild of the per-cell FAST extraction in the reference
(reference: ORBextractor.cc:765-853 ComputeKeyPointsOctTree — cv::FAST at
threshold 20 with per-30px-cell fallback to 7, then quadtree balancing at
539-763). Instead of scalar pixel loops:

  - the corner *score map* is computed for the whole image at once from 16
    shifted copies (elementwise); the score is OpenCV's definition — the
    largest threshold t for which a 9-contiguous arc stays all-brighter
    (or all-darker) than center +/- t — so "corner at t" == "score > t" and
    the 20 -> 7 fallback needs only ONE map;
  - 3x3 non-max suppression is a max-pool comparison;
  - the quadtree's spatial balancing is replaced by per-cell top-k + global
    per-level top-k over static shapes (SURVEY.md §7 design stance 3).
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from .image import shifted
from .prims import sort_top_k

# Bresenham circle of radius 3, circularly ordered (dy, dx) == (row, col).
CIRCLE = (
    (-3, 0), (-3, 1), (-2, 2), (-1, 3), (0, 3), (1, 3), (2, 2), (3, 1),
    (3, 0), (3, -1), (2, -2), (1, -3), (0, -3), (-1, -3), (-2, -2), (-3, -1),
)


def _min_window9(d: jax.Array) -> jax.Array:
    """Min over all 16 contiguous windows of length 9 along axis 0 (wrap).

    d: [16, H, W] -> [16, H, W]; out[i] = min(d[i], d[i+1], ..., d[i+8] mod 16).
    log-composed rolls: 9 = 4+4+1.
    """
    m2 = jnp.minimum(d, jnp.roll(d, -1, axis=0))
    m4 = jnp.minimum(m2, jnp.roll(m2, -2, axis=0))
    m8 = jnp.minimum(m4, jnp.roll(m4, -4, axis=0))
    return jnp.minimum(m8, jnp.roll(d, -8, axis=0))


@jax.jit
def fast_score_map(img: jax.Array) -> jax.Array:
    """[H, W] float -> FAST-9/16 corner score map (0 = not a corner at t=0+).

    score = max over arcs of min(brighter diffs) (and the darker dual):
    exactly the maximal threshold at which the segment test still passes.
    """
    ring = jnp.stack([shifted(img, dy, dx, 3) for dy, dx in CIRCLE])  # [16,H,W]
    d = ring - img[None]
    bright = jnp.max(_min_window9(d), axis=0)  # arc all-brighter margin
    dark = jnp.max(_min_window9(-d), axis=0)  # arc all-darker margin
    score = jnp.maximum(bright, dark)
    # Invalidate the 3px frame where the ring would read zero padding.
    h, w = img.shape
    yy = jax.lax.broadcasted_iota(jnp.int32, (h, w), 0)
    xx = jax.lax.broadcasted_iota(jnp.int32, (h, w), 1)
    edge = (yy < 3) | (yy >= h - 3) | (xx < 3) | (xx >= w - 3)
    return jnp.where(edge, 0.0, jnp.maximum(score, 0.0))


@jax.jit
def nms3x3(score: jax.Array) -> jax.Array:
    """Keep strict local maxima over 3x3 neighborhoods; zero elsewhere."""
    neigh = []
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dy == 0 and dx == 0:
                continue
            neigh.append(shifted(score, dy, dx, 1))
    nmax = jnp.max(jnp.stack(neigh), axis=0)
    return jnp.where(score > nmax, score, 0.0)


def _cell_view(score: jax.Array, cell: int):
    """Pad to a multiple of `cell` and reshape to [cy, cx, cell*cell]."""
    h, w = score.shape
    ph = (-h) % cell
    pw = (-w) % cell
    s = jnp.pad(score, ((0, ph), (0, pw)))
    cy, cx = (h + ph) // cell, (w + pw) // cell
    return s.reshape(cy, cell, cx, cell).transpose(0, 2, 1, 3).reshape(cy, cx, cell * cell), cy, cx, ph, pw


@partial(jax.jit, static_argnums=(1, 2, 3, 4, 5))
def select_keypoints(
    score: jax.Array,
    n_max: int,
    cell: int = 32,
    per_cell: int = 4,
    th_high: float = 20.0,
    th_low: float = 7.0,
):
    """NMS + per-cell threshold fallback + per-cell cap + global top-k.

    Mirrors the reference's semantics: detect at iniThFAST=20, fall back to
    minThFAST=7 only in cells with no strong corner (ORBextractor.cc:809-816),
    then spatially balance (quadtree -> per-cell cap here) and keep n_max by
    response.

    Returns (yx [n_max, 2] int32, resp [n_max], valid [n_max] bool).
    """
    h, w = score.shape
    s = nms3x3(score)
    cells, cy, cx, ph, pw = _cell_view(s, cell)
    cell_max = jnp.max(cells, axis=-1, keepdims=True)  # [cy, cx, 1]
    th = jnp.where(cell_max > th_high, th_high, th_low)
    keep = jnp.where(cells > th, cells, 0.0)
    # Per-cell cap: top `per_cell` responses within each cell.
    top_v, top_i = sort_top_k(keep, per_cell)  # [cy, cx, per_cell]
    # Flat image coordinates of the selected entries.
    cyi = jax.lax.broadcasted_iota(jnp.int32, top_i.shape, 0)
    cxi = jax.lax.broadcasted_iota(jnp.int32, top_i.shape, 1)
    yy = cyi * cell + top_i // cell
    xx = cxi * cell + top_i % cell
    flat_v = top_v.reshape(-1)
    flat_y = yy.reshape(-1)
    flat_x = xx.reshape(-1)
    # Global budget with SPATIAL ROUND-ROBIN: every cell's best corner is
    # taken before any cell's second-best (rank-major, response within
    # rank) — the quadtree's spatial-uniformity semantics (reference:
    # DistributeOctTree keeps the max-response point per spatial node,
    # ORBextractor.cc:741-760). Pure response-order selection lets one
    # high-contrast region crowd out the rest of the image, which
    # collapses the depth diversity pose estimation depends on.
    rank = jax.lax.broadcasted_iota(jnp.int32, top_i.shape, 2).reshape(-1)
    sel_key = flat_v - rank.astype(flat_v.dtype) * 1e7
    n_cand = flat_v.shape[0]
    k = min(n_max, n_cand)
    _, gi = sort_top_k(sel_key, k)
    gv = flat_v[gi]
    sel_y = flat_y[gi]
    sel_x = flat_x[gi]
    valid = gv > 0.0
    if k < n_max:
        pad = n_max - k
        gv = jnp.concatenate([gv, jnp.zeros(pad, gv.dtype)])
        sel_y = jnp.concatenate([sel_y, jnp.zeros(pad, jnp.int32)])
        sel_x = jnp.concatenate([sel_x, jnp.zeros(pad, jnp.int32)])
        valid = jnp.concatenate([valid, jnp.zeros(pad, jnp.bool_)])
    yx = jnp.stack([sel_y, sel_x], axis=-1).astype(jnp.int32)
    return yx, gv, valid


@jax.jit
def subpixel_refine(score: jax.Array, yx: jax.Array) -> jax.Array:
    """Sub-pixel corner offsets from a 1D parabola fit per axis on the raw
    score map. Returns [N, 2] (dy, dx) in [-0.5, 0.5].

    The reference keeps integer FAST corners (OpenCV semantics); at
    structure depth 2-5 m one pixel of corner noise is ~1 cm of pose noise
    and pushes residuals into the flat tail of the Huber kernel, making the
    robust pose cost multimodal. Half-pixel refinement keeps residuals in
    the quadratic region — strictly better than reference behavior.
    """
    h, w = score.shape
    y = yx[:, 0]
    x = yx[:, 1]

    def at(dy, dx):
        return score[jnp.clip(y + dy, 0, h - 1), jnp.clip(x + dx, 0, w - 1)]

    c = at(0, 0)
    denom_y = at(-1, 0) - 2 * c + at(1, 0)
    denom_x = at(0, -1) - 2 * c + at(0, 1)
    dy = 0.5 * (at(-1, 0) - at(1, 0)) / jnp.where(jnp.abs(denom_y) < 1e-6, 1e-6, denom_y)
    dx = 0.5 * (at(0, -1) - at(0, 1)) / jnp.where(jnp.abs(denom_x) < 1e-6, 1e-6, denom_x)
    dy = jnp.clip(dy, -0.5, 0.5)
    dx = jnp.clip(dx, -0.5, 0.5)
    return jnp.stack([dy, dx], axis=-1)
