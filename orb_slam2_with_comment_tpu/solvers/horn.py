"""Horn's closed-form absolute orientation (batched).

JAX rebuild of the reference's Sim3Solver::ComputeSim3 core
(reference: Sim3Solver.cc:239-351 — Horn 1987: quaternion from the largest
eigenvector of the 4x4 N matrix, optional scale): fully batched over
hypothesis sets so a whole RANSAC round is one eigh call.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp




def solve(P1: jax.Array, P2: jax.Array, with_scale: bool = True,
          w: jax.Array | None = None):
    """Find (R, t, s) minimizing || sqrt(w) (P1 - (s R P2 + t)) ||.

    P1, P2: [..., N, 3] paired point sets (P1 = s R P2 + t).
    w: optional [..., N] per-pair weights (0/1 masks or soft weights).
    Returns R [..., 3, 3], t [..., 3], s [...].
    """
    if w is None:
        c1 = jnp.mean(P1, axis=-2, keepdims=True)
        c2 = jnp.mean(P2, axis=-2, keepdims=True)
    else:
        wn = w[..., None]
        wsum = jnp.clip(jnp.sum(wn, axis=-2, keepdims=True), 1e-9, None)
        c1 = jnp.sum(P1 * wn, axis=-2, keepdims=True) / wsum
        c2 = jnp.sum(P2 * wn, axis=-2, keepdims=True) / wsum
    q1 = P1 - c1
    q2 = P2 - c2
    wq1 = q1 if w is None else q1 * w[..., None]
    # Kabsch (equivalent to Horn's quaternion eigen-solve, simpler to batch):
    # maximize tr(R H) with H = sum w_i q2_i q1_i^T -> R = V diag(1,1,d) U^T.
    H = jnp.einsum("...ni,...nj->...ij", q2, wq1)
    U, S, Vt = jnp.linalg.svd(H)
    V = jnp.swapaxes(Vt, -1, -2)
    Ut = jnp.swapaxes(U, -1, -2)
    d = jnp.linalg.det(V @ Ut)
    D = jnp.zeros_like(H).at[..., 0, 0].set(1.0).at[..., 1, 1].set(1.0)
    D = D.at[..., 2, 2].set(d)
    R = V @ D @ Ut
    if with_scale:
        # s = sum(w q1 . (R q2)) / sum(w |q2|^2) (asymmetric form, as reference)
        Rq2 = jnp.einsum("...ij,...nj->...ni", R, q2)
        num = jnp.sum(wq1 * Rq2, axis=(-1, -2))
        wq2 = q2 if w is None else q2 * w[..., None]
        den = jnp.sum(wq2 * q2, axis=(-1, -2))
        s = num / jnp.clip(den, 1e-12, None)
    else:
        s = jnp.ones(R.shape[:-2], R.dtype)
    t = c1[..., 0, :] - s[..., None] * jnp.einsum("...ij,...j->...i", R, c2[..., 0, :])
    return R, t, s
