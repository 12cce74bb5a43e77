"""Batched 256-bit Hamming distance (XOR + popcount).

JAX rebuild of the reference's DescriptorDistance (reference:
ORBmatcher.cc:1901-1917, the Stanford bit-twiddling popcount) generalized
from a scalar pair to full distance matrices: descriptors are uint32[...,8],
distances come from lax.population_count on the XOR — the building block for
every matcher search mode and for BoW scoring.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp


def hamming_pair(a: jax.Array, b: jax.Array) -> jax.Array:
    """Elementwise Hamming distance; a, b broadcastable [..., 8] uint32."""
    x = jax.lax.population_count(jnp.bitwise_xor(a, b))
    return jnp.sum(x, axis=-1).astype(jnp.int32)


@jax.jit
def _distance_matrix_xla(d1: jax.Array, d2: jax.Array) -> jax.Array:
    return hamming_pair(d1[:, None, :], d2[None, :, :])


def distance_matrix(d1: jax.Array, d2: jax.Array) -> jax.Array:
    """[N1, 8] x [N2, 8] uint32 -> [N1, N2] int32 Hamming distances.

    Broadcast XOR + popcount; XLA fuses it into the consumer's reduction.
    On an H100 it measured faster than the exact ±1 bf16 bit-GEMM at
    every matcher width tried except 1000x1000, where the GEMM won by
    8 us per matrix (PERF.md).
    """
    return _distance_matrix_xla(d1, d2)


def best_two(dist: jax.Array, valid: jax.Array | None = None, big: int = 10_000):
    """Per-row best and second-best over the last axis.

    Args:
      dist: [..., M] int32 distances.
      valid: optional [..., M] bool mask of admissible candidates.
    Returns (best_dist, best_idx, second_dist) with invalid entries = big.
    """
    if valid is not None:
        dist = jnp.where(valid, dist, big)
    neg, idx = jax.lax.top_k(-dist, 2)
    return -neg[..., 0], idx[..., 0], -neg[..., 1]
