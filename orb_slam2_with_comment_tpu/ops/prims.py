"""Substitutes for XLA primitives: top-k, cumsum, scatter and ranking
recast as sort, matmul or dense comparison.

They replaced ``lax.top_k``, ``jnp.cumsum``, ``jnp.searchsorted`` and
scatters on the accelerator the engine was first built for, where those
lowered to slow sequential code. Whether each still pays on a GPU against
the plain primitive is not measured yet.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp


def sort_top_k(v: jax.Array, k: int):
    """Descending top-k along the last axis via ONE lax.sort.

    Returns (values [..., k], indices [..., k]) like lax.top_k.
    """
    n = v.shape[-1]
    iota = jnp.broadcast_to(
        jax.lax.iota(jnp.int32, n), v.shape).reshape(v.shape)
    neg, idx = jax.lax.sort((-v, iota), dimension=-1, num_keys=1)
    return -neg[..., :k], idx[..., :k]


def cumsum_tri(x: jax.Array) -> jax.Array:
    """Inclusive 1-D cumsum as a triangular matmul (exact at HIGHEST for
    integer counts below 2^24). Use for n <= ~2048."""
    n = x.shape[0]
    tri = jnp.tril(jnp.ones((n, n), jnp.float32))
    return jnp.matmul(tri, x.astype(jnp.float32),
                      precision=jax.lax.Precision.HIGHEST).astype(x.dtype)


def rank_in_group(key: jax.Array, valid: jax.Array) -> jax.Array:
    """rank[i] = number of j < i with key[j] == key[i] (both valid).

    Dense O(B^2) comparison instead of sort+searchsorted (the reference
    pattern for assigning consecutive slots to same-key batch entries).
    Use for B <= ~2048.
    """
    b = key.shape[0]
    eq = (key[None, :] == key[:, None]) & valid[None, :] & valid[:, None]
    lower = jnp.tril(jnp.ones((b, b), bool), k=-1)
    return jnp.sum(eq & lower, axis=1).astype(jnp.int32)


def run_first_sorted(s: jax.Array) -> jax.Array:
    """For a SORTED 1-D array, the index of the first element of each
    equal-value run (what searchsorted(s, s, 'left') computes, ~50x
    cheaper via a log-depth max-scan)."""
    n = s.shape[0]
    iota = jax.lax.iota(jnp.int32, n)
    changed = jnp.concatenate([jnp.ones(1, bool), s[1:] != s[:-1]])
    starts = jnp.where(changed, iota, 0)
    return jax.lax.associative_scan(jnp.maximum, starts)


def gather_mask_indices(mask: jax.Array, size: int):
    """Pack the indices of set bits of ``mask`` [n] into a fixed-size
    prefix: returns (idx [size] int32, valid [size] bool). Order-stable
    (lower indices first) via ONE lax.sort — the gather half of the
    local-window architecture (bounded subproblems gathered out of
    capacity-sized SoA state, processed at fixed shape, scattered back).
    Overflow beyond ``size`` is silently dropped; size the caps generously.
    """
    order = jnp.argsort(~mask, stable=True).astype(jnp.int32)
    idx = order[:size]
    return idx, mask[idx]


def onehot_set_rows(dst: jax.Array, idx: jax.Array, vals: jax.Array,
                    sel: jax.Array) -> jax.Array:
    """``dst.at[idx].set(vals)`` where ``sel`` masks active rows, as a
    one-hot matmul.

    dst: [L, C] float; idx: [N] int32 (UNIQUE among sel rows); vals:
    [N, C]; sel: [N] bool. Rows not addressed keep their value.
    """
    L = dst.shape[0]
    oh = ((idx[:, None] == jnp.arange(L, dtype=jnp.int32)[None, :])
          & sel[:, None]).astype(jnp.float32)          # [N, L]
    hit = jnp.max(oh, axis=0)                           # [L]
    scattered = jnp.matmul(oh.T, vals.astype(jnp.float32),
                           precision=jax.lax.Precision.HIGHEST)
    out = dst.astype(jnp.float32) * (1.0 - hit[:, None]) + scattered
    return out.astype(dst.dtype)
