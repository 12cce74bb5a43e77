"""Sim3 RANSAC for loop-closure relative pose.

JAX rebuild of the reference's Sim3Solver (reference:
Sim3Solver.cc:37-220): 3-point Horn hypotheses with two-sided reprojection
chi2 gating (9.210 * sigma2 per image, :51-52,87-88), recast as a single
vmapped batch — all max_iters hypotheses solved and scored in one shot
instead of the reference's sequential early-exit loop (SURVEY §7 stance 5).
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from . import horn

CHI2_SIM3 = 9.210  # 99% 2-dof (reference: Sim3Solver.cc:51-52)


class Sim3RansacResult(NamedTuple):
    R: jax.Array  # [3,3] R12 (maps camera-2 points into camera-1 frame)
    t: jax.Array
    s: jax.Array
    inliers: jax.Array  # [N] bool
    n_inliers: jax.Array


def _project(K, Xc):
    fx, fy, cx, cy = K
    z = jnp.clip(Xc[..., 2], 1e-6, None)
    return jnp.stack([fx * Xc[..., 0] / z + cx, fy * Xc[..., 1] / z + cy], -1)


def solve_ransac(
    key: jax.Array,
    K1, K2,
    X1: jax.Array,  # [N, 3] matched landmarks in camera-1 frame
    X2: jax.Array,  # [N, 3] same landmarks in camera-2 frame
    uv1: jax.Array,  # [N, 2] observed pixels in image 1
    uv2: jax.Array,  # [N, 2]
    sigma2_1: jax.Array,  # [N] level sigma^2 in image 1
    sigma2_2: jax.Array,
    valid: jax.Array,  # [N]
    max_iters: int = 300,
    min_inliers: int = 20,
    fix_scale: bool = False,
) -> Sim3RansacResult:
    """All hypotheses batched: sample 3-point sets, Horn-solve, score with
    the two-sided chi2 gate, return the best model + its inliers."""
    N = X1.shape[0]
    nv = jnp.sum(valid.astype(jnp.int32))
    # Sample 3 indices per hypothesis from the valid set (with replacement
    # across hypotheses; degenerate samples score poorly and lose).
    probs = valid.astype(jnp.float32) / jnp.clip(nv, 1, None)
    idx = jax.random.categorical(
        key, jnp.log(jnp.clip(probs, 1e-12, None))[None, :].repeat(max_iters * 3, 0)
    ).reshape(max_iters, 3)
    P1 = X1[idx]  # [T, 3, 3]
    P2 = X2[idx]
    R, t, s = horn.solve(P1, P2, with_scale=not fix_scale)  # [T,...]
    if fix_scale:
        s = jnp.ones(max_iters, X1.dtype)
    # score every hypothesis against every correspondence
    X2in1 = s[:, None, None] * jnp.einsum("tij,nj->tni", R, X2) + t[:, None, :]
    Rt = jnp.swapaxes(R, -1, -2)
    s_inv = 1.0 / jnp.clip(s, 1e-9, None)
    t_inv = -s_inv[:, None] * jnp.einsum("tij,tj->ti", Rt, t)
    X1in2 = s_inv[:, None, None] * jnp.einsum("tij,nj->tni", Rt, X1) + t_inv[:, None, :]
    e1 = _project(K1, X2in1) - uv1[None]
    e2 = _project(K2, X1in2) - uv2[None]
    c1 = jnp.sum(e1 * e1, -1) / jnp.clip(sigma2_1, 1e-9, None)[None]
    c2 = jnp.sum(e2 * e2, -1) / jnp.clip(sigma2_2, 1e-9, None)[None]
    inlier = (c1 < CHI2_SIM3) & (c2 < CHI2_SIM3) & valid[None]  # [T, N]
    counts = jnp.sum(inlier.astype(jnp.int32), axis=1)
    best = jnp.argmax(counts)
    ok = counts[best] >= min_inliers
    return Sim3RansacResult(
        R[best], t[best], s[best],
        inlier[best] & ok, jnp.where(ok, counts[best], 0),
    )
