"""Sim(3) relative-pose refinement with bidirectional projection edges.

JAX rebuild of the reference's ``Optimizer::OptimizeSim3``
(reference: Optimizer.cc:1145-1347): refine the loop-closure Sim3 S_12
between keyframe 1 and keyframe 2 from matched landmark pairs, with
bidirectional mono projection residuals —

  e1_i = obs1_i - proj1( S_12 · X2_i )      (point of KF2, seen in KF1)
  e2_i = obs2_i - proj2( S_12^-1 · X1_i )   (point of KF1, seen in KF2)

Huber kernel with delta = sqrt(th2=10) (reference: Optimizer.cc:1184-1190),
inlier classification at chi2 > th2 per direction pair, ``fix_scale``
for stereo/RGB-D. Points are expressed in the two camera frames (X1, X2),
exactly as the reference builds its edges from camera-frame coordinates.
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..geometry import sim3
from .residuals import huber_weight


class Sim3OptResult(NamedTuple):
    R: jax.Array  # [3,3] refined R_12
    t: jax.Array  # [3]
    s: jax.Array  # []
    inliers: jax.Array  # [N] bool (both directions pass)
    n_inliers: jax.Array  # [] int32


def _project(fx, fy, cx, cy, Xc):
    z = Xc[..., 2]
    iz = 1.0 / jnp.where(jnp.abs(z) < 1e-9, 1e-9, z)
    return jnp.stack([fx * Xc[..., 0] * iz + cx, fy * Xc[..., 1] * iz + cy], axis=-1)


def optimize_sim3(
    K1: tuple,
    K2: tuple,
    R0: jax.Array,
    t0: jax.Array,
    s0: jax.Array,
    X1: jax.Array,  # [N,3] matched points in camera-1 frame
    X2: jax.Array,  # [N,3] same landmarks in camera-2 frame
    obs1: jax.Array,  # [N,2] pixel obs in image 1 (of the X2 points)
    obs2: jax.Array,  # [N,2] pixel obs in image 2 (of the X1 points)
    inv_sigma2_1: jax.Array,  # [N]
    inv_sigma2_2: jax.Array,  # [N]
    valid: jax.Array,  # [N] bool
    iters: int = 10,
    th2: float = 10.0,
    fix_scale: bool = False,
) -> Sim3OptResult:
    fx1, fy1, cx1, cy1 = K1
    fx2, fy2, cx2, cy2 = K2
    delta = jnp.sqrt(jnp.float32(th2))

    def residuals(xi, R, t, s):
        R_, t_, s_ = sim3.retract(R, t, s, xi)
        e1 = obs1 - _project(fx1, fy1, cx1, cy1, sim3.transform(R_, t_, s_, X2))
        Ri, ti, si = sim3.inverse(R_, t_, s_)
        e2 = obs2 - _project(fx2, fy2, cx2, cy2, sim3.transform(Ri, ti, si, X1))
        return e1, e2

    def chi2_pair(R, t, s):
        e1, e2 = residuals(jnp.zeros(7, R.dtype), R, t, s)
        c1 = jnp.sum(e1 * e1, axis=-1) * inv_sigma2_1
        c2 = jnp.sum(e2 * e2, axis=-1) * inv_sigma2_2
        return c1, c2

    def iteration(carry, _):
        R, t, s, lam, inlier = carry
        zero = jnp.zeros(7, R.dtype)
        e1, e2 = residuals(zero, R, t, s)
        J1, J2 = jax.jacfwd(lambda xi: residuals(xi, R, t, s))(zero)  # [N,2,7]
        c1 = jnp.sum(e1 * e1, axis=-1) * inv_sigma2_1
        c2 = jnp.sum(e2 * e2, axis=-1) * inv_sigma2_2
        w1 = jnp.where(valid & inlier, inv_sigma2_1 * huber_weight(c1, delta), 0.0)
        w2 = jnp.where(valid & inlier, inv_sigma2_2 * huber_weight(c2, delta), 0.0)
        if fix_scale:
            J1 = J1.at[..., 6].set(0.0)
            J2 = J2.at[..., 6].set(0.0)
        H = jnp.einsum("nri,n,nrj->ij", J1, w1, J1) + jnp.einsum("nri,n,nrj->ij", J2, w2, J2)
        b = jnp.einsum("nri,n,nr->i", J1, w1, e1) + jnp.einsum("nri,n,nr->i", J2, w2, e2)
        D = jnp.diag(jnp.clip(jnp.diagonal(H), 1e-6, None))
        dxi = -jnp.linalg.solve(H + lam * D, b)
        if fix_scale:
            dxi = dxi.at[6].set(0.0)
        R_new, t_new, s_new = sim3.retract(R, t, s, dxi)
        c1n, c2n = chi2_pair(R_new, t_new, s_new)
        mask = (valid & inlier).astype(R.dtype)
        chi2_old = jnp.sum((c1 + c2) * mask)
        chi2_new = jnp.sum((c1n + c2n) * mask)
        ok = (chi2_new < chi2_old) & jnp.all(jnp.isfinite(dxi))
        R = jnp.where(ok, R_new, R)
        t = jnp.where(ok, t_new, t)
        s = jnp.where(ok, s_new, s)
        lam = jnp.where(ok, lam * 0.5, lam * 4.0).clip(1e-12, 1e8)
        return (R, t, s, lam, inlier), None

    inlier0 = jnp.ones(X1.shape[0], jnp.bool_)
    # Two passes of (iters/2) with an inlier reclassification in between,
    # mirroring the reference's optimize -> drop chi2>th2 -> re-optimize
    # (Optimizer.cc:1287-1340).
    carry = (R0, t0, jnp.asarray(s0, R0.dtype), jnp.float32(1e-3), inlier0)
    carry, _ = jax.lax.scan(iteration, carry, None, length=max(1, iters // 2))
    R, t, s, lam, _ = carry
    c1, c2 = chi2_pair(R, t, s)
    inlier = (c1 <= th2) & (c2 <= th2) & valid
    carry = (R, t, s, lam, inlier)
    carry, _ = jax.lax.scan(iteration, carry, None, length=max(1, iters - iters // 2))
    R, t, s, _, _ = carry
    c1, c2 = chi2_pair(R, t, s)
    inlier = (c1 <= th2) & (c2 <= th2) & valid
    return Sim3OptResult(R, t, s, inlier, jnp.sum(inlier.astype(jnp.int32)))
