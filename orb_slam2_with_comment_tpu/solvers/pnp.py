"""EPnP + RANSAC pose solver for relocalization.

JAX rebuild of the reference's PnPsolver (reference:
PnPsolver.cc:67-352 — EPnP control points + adaptive RANSAC with per-level
chi2 gating). Hypotheses are vmapped: each RANSAC sample solves the FULL
EPnP formulation on its 4-point minimal set (reference minSet=4,
PnPsolver.cc:131) in one batched pipeline:

  control points -> barycentric -> 2Sx12 M-matrix -> 4-dim null basis
  (PnPsolver.cc:compute_pose:490-560) -> beta cases 1/2/3 seeded from the
  L_6x10 distance system (find_betas_approx_1/2/3, :562-652) -> fixed
  Gauss-Newton on the 6 inter-control-point distance constraints
  (gauss_newton, :853-871) -> per-case pose by point alignment
  (estimate_R_and_t) -> keep the case with least reprojection error.

All hypotheses are scored against all correspondences at once, and the
winner is re-estimated from ALL of its inliers (the reference's Refine,
PnPsolver.cc:273-318) before the caller feeds it to the pose-only
optimizer (as the reference feeds PoseOptimization, Tracking.cc:1676).

Degenerate samples (collinear / coplanar-through-centroid) produce NaN
poses in some branches; those cases score +inf reprojection error and the
beta-case select / RANSAC vote discard them — no data-dependent control
flow is needed.
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from . import horn

CHI2_PNP = 5.991

# the 10 monomials beta_i*beta_j (i<=j) in the order the L_6x10 columns
# use (reference compute_L_6x10, PnPsolver.cc:770-805)
_B10_I = jnp.asarray([0, 0, 1, 0, 1, 2, 0, 1, 2, 3])
_B10_J = jnp.asarray([0, 1, 1, 2, 2, 2, 3, 3, 3, 3])
# the 6 control-point pairs (rho order: reference compute_rho :807-815)
_PAIR_I = jnp.asarray([0, 0, 0, 1, 1, 2])
_PAIR_J = jnp.asarray([1, 2, 3, 2, 3, 3])


class PnPResult(NamedTuple):
    R: jax.Array
    t: jax.Array
    inliers: jax.Array  # [N]
    n_inliers: jax.Array


def _b10(beta: jax.Array) -> jax.Array:
    """[4] betas -> the [10] monomial vector matching the L columns."""
    return beta[_B10_I] * beta[_B10_J]


def _lstsq_nm(A: jax.Array, b: jax.Array, m: int) -> jax.Array:
    """Tiny dense least squares via damped normal equations ([6,m] @ [m]).
    The ridge scales with trace(AtA)/m so the f32 solve stays
    well-conditioned for near-planar control-point geometry (the
    reference solves these in double via SVD/QR; ADVICE r4)."""
    AtA = A.T @ A
    ridge = 1e-7 * jnp.trace(AtA) / m + 1e-12
    AtA = AtA + ridge * jnp.eye(m, dtype=A.dtype)
    return jnp.linalg.solve(AtA, A.T @ b)


def _gauss_newton(L: jax.Array, rho: jax.Array, beta: jax.Array,
                  iters: int = 5) -> jax.Array:
    """Refine betas on the 6 distance constraints (PnPsolver.cc:853-871)."""

    def step(beta, _):
        r = L @ _b10(beta) - rho  # [6]
        # d b10_c / d beta_k = beta_j * [i==k] + beta_i * [j==k]
        eye = jnp.eye(4, dtype=beta.dtype)
        dB = (beta[_B10_J][:, None] * eye[_B10_I]
              + beta[_B10_I][:, None] * eye[_B10_J])  # [10, 4]
        J = L @ dB  # [6, 4]
        delta = _lstsq_nm(J, -r, 4)
        return beta + delta, None

    beta, _ = jax.lax.scan(step, beta, None, length=iters)
    return beta


def _epnp_core(Xw: jax.Array, uv: jax.Array, w: jax.Array, K):
    """Full EPnP on [S,3]/[S,2] with per-point weights w [S] (0/1 mask for
    the Refine pass; all-ones for minimal sets). Returns (R, t, err) where
    err is the weighted mean squared reprojection error of the winning
    beta case."""
    fx, fy, cx, cy = K
    S = Xw.shape[0]
    wsum = jnp.clip(jnp.sum(w), 1e-6, None)
    c0 = jnp.sum(Xw * w[:, None], axis=0) / wsum
    Xc0 = (Xw - c0) * jnp.sqrt(w)[:, None]
    cov = Xc0.T @ Xc0 / wsum
    evals, evecs = jnp.linalg.eigh(cov)
    # control points: centroid + principal axes scaled by sqrt(eigenvalue)
    # (choose_control_points, PnPsolver.cc:388-430)
    axes = evecs.T * jnp.sqrt(jnp.clip(evals, 1e-9, None))[:, None]  # [3,3]
    ctrl_w = jnp.concatenate([c0[None], c0[None] + axes], axis=0)  # [4, 3]
    # barycentric: Xw = sum_j alpha_j ctrl_w[j], sum alpha = 1
    Cmat = jnp.concatenate([ctrl_w.T, jnp.ones((1, 4))], axis=0)  # [4,4]
    Xh = jnp.concatenate([Xw.T, jnp.ones((1, S))], axis=0)  # [4,S]
    alpha = jnp.linalg.solve(Cmat, Xh).T  # [S, 4]
    # M matrix [2S, 12] in per-control-point (x_j, y_j, z_j) layout
    u, v = uv[:, 0], uv[:, 1]
    zeros = jnp.zeros_like(alpha)
    row_u = jnp.concatenate(
        [alpha * fx, zeros, alpha * (cx - u)[:, None]], axis=1)
    row_v = jnp.concatenate(
        [zeros, alpha * fy, alpha * (cy - v)[:, None]], axis=1)
    Mm = jnp.concatenate([row_u * w[:, None], row_v * w[:, None]], axis=0)
    perm = jnp.asarray([0, 4, 8, 1, 5, 9, 2, 6, 10, 3, 7, 11])
    Mm = Mm[:, perm]
    MtM = Mm.T @ Mm
    _, V = jnp.linalg.eigh(MtM)
    # 4 smallest eigenvectors = the null basis (compute_pose :523-529);
    # v[k] holds the k-th basis vector as 4 camera-frame control points
    vbasis = V[:, :4].T.reshape(4, 4, 3)
    # L_6x10 and rho over the 6 control-point pairs
    dv = vbasis[:, _PAIR_I, :] - vbasis[:, _PAIR_J, :]  # [4, 6, 3]
    dots = jnp.einsum("ipc,jpc->pij", dv, dv)  # [6, 4, 4]
    coef = jnp.where(_B10_I == _B10_J, 1.0, 2.0)
    L6 = dots[:, _B10_I, _B10_J] * coef[None, :]  # [6, 10]
    dw = ctrl_w[_PAIR_I] - ctrl_w[_PAIR_J]
    rho = jnp.sum(dw * dw, axis=1)  # [6]

    # --- beta seeds, cases 1..3 (find_betas_approx_*, :562-652) ---
    # case 1: x = [b11, b12, b13, b14] from L[:, (0,1,3,6)]
    x1 = _lstsq_nm(L6[:, jnp.asarray([0, 1, 3, 6])], rho, 4)
    b0 = jnp.sqrt(jnp.abs(x1[0]))
    beta1 = jnp.concatenate([
        b0[None], x1[1:] * jnp.sign(x1[0]) / jnp.clip(b0, 1e-9, None)])
    # case 2: x = [b11, b12, b22] from L[:, (0,1,2)]. The b22 seed only
    # survives when sign(b22) is consistent with sign(b11) — the
    # reference zeroes it otherwise (find_betas_approx_2 :607-616;
    # ADVICE r4).
    x2 = _lstsq_nm(L6[:, jnp.asarray([0, 1, 2])], rho, 3)
    b0 = jnp.sqrt(jnp.abs(x2[0]))
    b1 = jnp.where(x2[0] * x2[2] > 0, jnp.sqrt(jnp.abs(x2[2])), 0.0)
    beta2 = jnp.stack([
        b0, b1 * jnp.sign(x2[1]) * jnp.sign(x2[0]),
        jnp.float32(0.0), jnp.float32(0.0)])
    # case 3: x = [b11, b12, b22, b13, b23] from L[:, (0,1,2,3,4)]
    # (same sign-consistency rule, find_betas_approx_3 :630-645)
    x3 = _lstsq_nm(L6[:, jnp.asarray([0, 1, 2, 3, 4])], rho, 5)
    b0 = jnp.sqrt(jnp.abs(x3[0]))
    b1 = jnp.where(x3[0] * x3[2] > 0, jnp.sqrt(jnp.abs(x3[2])), 0.0)
    beta3 = jnp.stack([
        b0, b1 * jnp.sign(x3[1]) * jnp.sign(x3[0]),
        x3[3] * jnp.sign(x3[0]) / jnp.clip(b0, 1e-9, None),
        jnp.float32(0.0)])
    betas = jnp.stack([beta1, beta2, beta3])  # [3, 4]
    betas = jax.vmap(lambda b: _gauss_newton(L6, rho, b))(betas)

    def pose_for(beta):
        ctrl_c = jnp.einsum("k,kcd->cd", beta, vbasis)  # [4, 3]
        Xc_est = alpha @ ctrl_c  # [S, 3]
        flip = jnp.sum(Xc_est[:, 2] * w) < 0
        Xc_est = jnp.where(flip, -Xc_est, Xc_est)
        # rigid alignment of the (weighted) point sets
        # (estimate_R_and_t, PnPsolver.cc:900-960)
        R, t, _ = horn.solve(Xc_est[None], Xw[None], with_scale=False,
                             w=w[None])
        R, t = R[0], t[0]
        Xc = Xw @ R.T + t
        z = jnp.clip(Xc[:, 2], 1e-6, None)
        pu = fx * Xc[:, 0] / z + cx
        pv = fy * Xc[:, 1] / z + cy
        e2 = (pu - u) ** 2 + (pv - v) ** 2
        bad_depth = jnp.sum((Xc[:, 2] <= 0) * w) > 0
        err = jnp.sum(e2 * w) / wsum
        err = jnp.where(jnp.isfinite(err) & ~bad_depth, err, jnp.inf)
        return R, t, err

    Rs, ts, errs = jax.vmap(pose_for)(betas)
    best = jnp.argmin(errs)
    return (jnp.nan_to_num(Rs[best]), jnp.nan_to_num(ts[best]), errs[best])


def _epnp_minimal(Xw: jax.Array, uv: jax.Array, K):
    R, t, _ = _epnp_core(Xw, uv, jnp.ones(Xw.shape[0], jnp.float32), K)
    return R, t


def solve_ransac(
    key: jax.Array,
    K,
    Xw: jax.Array,  # [N, 3] world landmarks
    uv: jax.Array,  # [N, 2] observations
    sigma2: jax.Array,  # [N] level sigma^2
    valid: jax.Array,
    max_iters: int = 300,
    sample_size: int = 4,
    min_inliers: int = 10,
) -> PnPResult:
    """Batched EPnP RANSAC (reference SetRansacParameters defaults:
    P=0.99, minInliers=10, maxIts=300, minSet=4; PnPsolver.cc:121-157),
    followed by the all-inlier Refine (:273-318)."""
    N = Xw.shape[0]
    fx, fy, cx, cy = K
    # minimal sets WITHOUT replacement per hypothesis (Gumbel top-k over
    # valid slots; duplicate indices in a 4-point set waste the
    # hypothesis — ADVICE r4)
    g = jax.random.gumbel(key, (max_iters, N))
    g = jnp.where(valid[None, :], g, -jnp.inf)
    _, idx = jax.lax.top_k(g, sample_size)  # [T, S] distinct per row

    def one(sample_idx):
        return _epnp_minimal(Xw[sample_idx], uv[sample_idx], K)

    R, t = jax.vmap(one)(idx)  # [T,3,3], [T,3]

    def classify(R, t):
        Xc = jnp.einsum("tij,nj->tni", R, Xw) + t[:, None, :]
        z = jnp.clip(Xc[..., 2], 1e-6, None)
        pu = fx * Xc[..., 0] / z + cx
        pv = fy * Xc[..., 1] / z + cy
        e2 = (pu - uv[None, :, 0]) ** 2 + (pv - uv[None, :, 1]) ** 2
        chi2 = e2 / jnp.clip(sigma2, 1e-9, None)[None]
        inlier = (chi2 < CHI2_PNP) & (Xc[..., 2] > 0) & valid[None]
        return inlier, jnp.sum(inlier.astype(jnp.int32), axis=1)

    inlier, counts = classify(R, t)
    best = jnp.argmax(counts)
    R_b, t_b, in_b, n_b = R[best], t[best], inlier[best], counts[best]
    # Refine: re-run EPnP from ALL the winning inliers (PnPsolver.cc:273)
    w_ref = in_b.astype(jnp.float32)
    R_r, t_r, err_r = _epnp_core(Xw, uv, w_ref, K)
    in_r, n_r = classify(R_r[None], t_r[None])
    in_r, n_r = in_r[0], n_r[0]
    take = jnp.isfinite(err_r) & (n_r >= n_b)
    R_b = jnp.where(take, R_r, R_b)
    t_b = jnp.where(take, t_r, t_b)
    in_b = jnp.where(take, in_r, in_b)
    n_b = jnp.where(take, n_r, n_b)
    ok = n_b >= min_inliers
    return PnPResult(R_b, t_b, in_b & ok, jnp.where(ok, n_b, 0))
