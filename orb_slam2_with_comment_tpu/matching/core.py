"""Matching primitives shared by every search mode.

JAX rebuild of the machinery inside ORBmatcher (reference:
src/ORBmatcher.cc): instead of per-feature candidate loops over a 64x48
cell hash (Frame::GetFeaturesInArea), every mode is a masked dense
[queries x features] Hamming problem — one distance-matrix sweep, a
candidate mask built from vectorized window/level/chi2 gates, then masked
argmin + ratio test + rotation-histogram consistency. Constants follow the
reference exactly (ORBmatcher.cc:37-39, 1854-1895).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from ..ops.hamming import distance_matrix

TH_LOW = 50
TH_HIGH = 100
HISTO_LENGTH = 30
BIG = 10_000


def masked_best_two(dist: jax.Array, mask: jax.Array):
    """Row-wise best/second-best over masked candidates.

    dist [Q, N] int32, mask [Q, N] bool -> (best [Q], idx [Q], second [Q]).
    Invalid rows get BIG distances.
    """
    d = jnp.where(mask, dist, BIG)
    # Two min/argmin reductions instead of lax.top_k(k=2): plain
    # reductions, no sort, for the same result.
    idx = jnp.argmin(d, axis=1).astype(jnp.int32)
    best = jnp.take_along_axis(d, idx[:, None], axis=1)[:, 0]
    cols = jnp.arange(d.shape[1], dtype=jnp.int32)
    second = jnp.min(jnp.where(cols[None, :] == idx[:, None], BIG, d), axis=1)
    return best, idx, second


def ratio_ok(best: jax.Array, second: jax.Array, ratio: float) -> jax.Array:
    """Lowe-style test as used by the reference: best < ratio * second."""
    return best.astype(jnp.float32) < ratio * second.astype(jnp.float32)


def rotation_bins(angle_q: jax.Array, angle_t: jax.Array) -> jax.Array:
    """30-bin histogram index of angle difference (radians in, reference
    uses degrees with factor 1/(360/30); ORBmatcher.cc:130-140)."""
    rot = (angle_q - angle_t) * (180.0 / jnp.pi)
    rot = jnp.where(rot < 0, rot + 360.0, rot)
    b = jnp.round(rot * (HISTO_LENGTH / 360.0)).astype(jnp.int32)
    return jnp.where(b == HISTO_LENGTH, 0, b)


def rotation_consistency(bins: jax.Array, matched: jax.Array) -> jax.Array:
    """Keep only matches whose rotation bin is among the top-3 bins;
    bins 2/3 are dropped when below 0.1x bin 1 (ORBmatcher.cc:1854-1895)."""
    counts = jnp.sum(
        (bins[:, None] == jnp.arange(HISTO_LENGTH)[None, :]) & matched[:, None],
        axis=0,
    )
    from ..ops.prims import sort_top_k
    top_v, top_i = sort_top_k(counts, 3)
    keep1 = bins == top_i[0]
    keep2 = (bins == top_i[1]) & (top_v[1] >= 0.1 * top_v[0])
    keep3 = (bins == top_i[2]) & (top_v[2] >= 0.1 * top_v[0])
    return matched & (keep1 | keep2 | keep3)


def dedupe_matches(idx: jax.Array, dist: jax.Array, matched: jax.Array, n_targets: int):
    """Resolve many-to-one collisions: keep the lowest-distance query per
    target (the reference erases the previous match when a better one
    arrives, e.g. SearchForInitialization ORBmatcher.cc:493+)."""
    d = jnp.where(matched, dist, BIG)
    tgt = jnp.where(matched, idx, n_targets)  # park invalid in overflow slot
    best_per_tgt = jax.ops.segment_min(d, tgt, num_segments=n_targets + 1)
    # A query survives if it is strictly the best for its target; break
    # exact ties by lowest query index.
    is_best = matched & (d == best_per_tgt[tgt])
    q_ids = jnp.arange(idx.shape[0], dtype=jnp.int32)
    first_q = jax.ops.segment_min(
        jnp.where(is_best, q_ids, jnp.int32(2**30)), tgt, num_segments=n_targets + 1
    )
    return is_best & (q_ids == first_q[tgt])


def windowed_match(
    desc_q: jax.Array,
    desc_t: jax.Array,
    cand_mask: jax.Array,
    max_dist: int,
    ratio: float | None = None,
    angle_q: jax.Array | None = None,
    angle_t: jax.Array | None = None,
    dedupe: bool = True,
):
    """Generic one-direction matcher.

    Args:
      desc_q: [Q, 8] query descriptors, desc_t: [N, 8] target descriptors.
      cand_mask: [Q, N] admissible pairs.
      max_dist: Hamming acceptance threshold (TH_LOW / TH_HIGH).
      ratio: optional best<ratio*second gate.
      angle_q/angle_t: enable rotation-histogram consistency when given.
    Returns (idx [Q] int32 target per query, dist [Q], matched [Q] bool).
    """
    dist = distance_matrix(desc_q, desc_t)
    best, idx, second = masked_best_two(dist, cand_mask)
    matched = best <= max_dist
    if ratio is not None:
        matched &= ratio_ok(best, second, ratio)
    if angle_q is not None:
        bins = rotation_bins(angle_q, angle_t[idx])
        matched = rotation_consistency(bins, matched)
    if dedupe:
        matched = dedupe_matches(idx, best, matched, desc_t.shape[0])
    return idx, best, matched
