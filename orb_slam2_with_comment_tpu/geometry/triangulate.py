"""Two-view triangulation, batched.

DLT-SVD triangulation with the same semantics as the reference's
LocalMapping::CreateNewMapPoints inner solve (reference: LocalMapping.cc:442-457)
and Initializer::Triangulate (reference: Initializer.cc:752-765), vmapped over
candidate pairs instead of looped.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp


def triangulate_dlt(P1: jax.Array, P2: jax.Array, x1: jax.Array, x2: jax.Array) -> jax.Array:
    """Batched DLT triangulation.

    Args:
      P1, P2: projection matrices [..., 3, 4] (K [R|t]) for the two views.
      x1, x2: pixel observations [..., 2].
    Returns: homogeneous-normalized world points [..., 3].
    """
    rows = [
        x1[..., 0, None] * P1[..., 2, :] - P1[..., 0, :],
        x1[..., 1, None] * P1[..., 2, :] - P1[..., 1, :],
        x2[..., 0, None] * P2[..., 2, :] - P2[..., 0, :],
        x2[..., 1, None] * P2[..., 2, :] - P2[..., 1, :],
    ]
    A = jnp.stack(rows, axis=-2)  # [..., 4, 4]
    # Smallest right singular vector of A == smallest eigenvector of A^T A.
    # 4x4 symmetric eigendecomposition is cheap and batches well.
    AtA = jnp.swapaxes(A, -1, -2) @ A
    _, V = jnp.linalg.eigh(AtA)  # ascending eigenvalues
    X = V[..., :, 0]
    w = X[..., 3]
    w = jnp.where(jnp.abs(w) < 1e-12, 1e-12, w)
    return X[..., :3] / w[..., None]


def rays_parallax_cos(C1: jax.Array, C2: jax.Array, X: jax.Array) -> jax.Array:
    """Cosine of the parallax angle between rays C1->X and C2->X (batched).

    Used by the reference's triangulation acceptance gates
    (LocalMapping.cc:401-440) and CheckRT (Initializer.cc:865-875).
    """
    r1 = X - C1
    r2 = X - C2
    n1 = jnp.linalg.norm(r1, axis=-1).clip(1e-12)
    n2 = jnp.linalg.norm(r2, axis=-1).clip(1e-12)
    return jnp.sum(r1 * r2, axis=-1) / (n1 * n2)
