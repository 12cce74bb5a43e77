"""Batched Levenberg-Marquardt bundle adjustment with Schur complement.

JAX replacement for the reference's g2o-based local/global BA
(reference: Optimizer.cc:56-255 BundleAdjustment, Optimizer.cc:483-808
LocalBundleAdjustment; solver internals: Thirdparty/g2o block_solver.h —
landmark marginalization via setMarginalized(true) + reduced camera system).

Design (SURVEY.md §7.4): one batched LM engine over a fixed-shape,
landmark-major observation table:

  poses      R [P,3,3], t [P,3]   world->camera
  landmarks  X [L,3]
  obs        pose_idx [L,D] int32, uvr [L,D,3], w [L,D] (invSigma2; 0=absent)

Each LM iteration is one XLA program: residuals/Jacobians batched over the
[L,D] table, H_ll inverted as [L] 3x3 blocks, the reduced camera system
S = H_pp - H_pl H_ll^-1 H_lp assembled densely by segment-sum of [6,6]
blocks (pose-pair coupling through shared landmarks is a (d,d') outer loop
over the D observation slots), and solved with a dense Cholesky. Fixed poses (gauge / frontier keyframes, reference: Optimizer.cc:89,
519-534) get identity rows in S. Huber IRLS weights implement the robust
kernel (reference: g2o robust_kernel_impl + Optimizer.cc:95-96).
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..geometry import se3
from .residuals import (
    CamParams,
    HUBER_MONO,
    HUBER_STEREO,
    huber_weight,
)


class BAProblem(NamedTuple):
    """Fixed-shape BA problem. P poses, L landmarks, D observation slots."""

    R: jax.Array  # [P, 3, 3]
    t: jax.Array  # [P, 3]
    X: jax.Array  # [L, 3]
    obs_pose: jax.Array  # [L, D] int32, pose index (0 where invalid)
    obs_uvr: jax.Array  # [L, D, 3]; uvr[...,2] < 0 => mono observation
    obs_w: jax.Array  # [L, D] invSigma2 information scale; 0 => absent
    pose_fixed: jax.Array  # [P] bool
    point_valid: jax.Array  # [L] bool


class BAResult(NamedTuple):
    R: jax.Array
    t: jax.Array
    X: jax.Array
    chi2: jax.Array  # final total weighted chi2
    obs_chi2: jax.Array  # [L, D] per-observation chi2 (for outlier culling)
    # final LM damping — thread back as init_lambda when chunking one
    # logical optimization across bounded calls (the reference's single
    # g2o run keeps its damping schedule across all iterations; chunked
    # GBA otherwise resets the schedule every chunk)
    final_lambda: jax.Array = jnp.float32(1e-4)


def _inv3x3(M: jax.Array) -> jax.Array:
    """Closed-form batched 3x3 inverse (adjugate / det) — elementwise
    work instead of the batched-LU custom call."""
    a, b, c = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    d, e, f = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    g, h, i = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    A = e * i - f * h
    B = c * h - b * i
    C = b * f - c * e
    Dd = f * g - d * i
    E = a * i - c * g
    F = c * d - a * f
    G = d * h - e * g
    H = b * g - a * h
    Ii = a * e - b * d
    det = a * A + b * Dd + c * G
    inv_det = 1.0 / jnp.where(jnp.abs(det) < 1e-12, 1e-12, det)
    adj = jnp.stack([
        jnp.stack([A, B, C], axis=-1),
        jnp.stack([Dd, E, F], axis=-1),
        jnp.stack([G, H, Ii], axis=-1),
    ], axis=-2)
    return adj * inv_det[..., None, None]


def _plane_components(cam, Robs, tobs, obsT, X):
    """Residual + Jacobian planes from per-observation pose rows.

    Robs [3,3,D,L], tobs [3,D,L], obsT [3,D,L], X [L,3] ->
    (e [3,D,L], Jp [3,6,D,L], Jl [3,3,D,L], stereo_row [D,L]).

    All per-observation math is [D, L]-plane arithmetic with the tiny
    (3-long) contractions unrolled in Python, so it fuses into elementwise
    loops instead of [D*L]-batched micro-dots, and the big (D, L) dims stay
    minor instead of the naive [L, D, 3, 6] layout's small ones.
    """
    # camera-frame points as unrolled 3x3 matvec on [D, L] planes
    Xc = jnp.stack([
        sum(Robs[i, j] * X[:, j] for j in range(3)) + tobs[i]
        for i in range(3)])  # [3, D, L]
    x, y, z = Xc[0], Xc[1], Xc[2]
    z = jnp.where(jnp.abs(z) < 1e-9, 1e-9, z)
    iz = 1.0 / z
    iz2 = iz * iz
    stereo = obsT[2] >= 0
    srow = stereo.astype(jnp.float32)
    u = cam.fx * x * iz + cam.cx
    v = cam.fy * y * iz + cam.cy
    ur = u - cam.bf * iz
    e = jnp.stack([obsT[0] - u, obsT[1] - v, (obsT[2] - ur) * srow])
    zero = jnp.zeros_like(x)
    # dproj/dXc rows (u, v, ur), [3, 3, D, L]
    Jproj = jnp.stack([
        jnp.stack([cam.fx * iz, zero, -cam.fx * x * iz2]),
        jnp.stack([zero, cam.fy * iz, -cam.fy * y * iz2]),
        jnp.stack([(cam.fx * iz) * srow, zero,
                   (-cam.fx * x * iz2 + cam.bf * iz2) * srow]),
    ])
    # d e/d xi = -Jproj @ [I | -hat(Xc)]  ([3, 6, D, L])
    D_, L_ = x.shape
    hatX = jnp.stack([
        jnp.stack([zero, -Xc[2], Xc[1]]),
        jnp.stack([Xc[2], zero, -Xc[0]]),
        jnp.stack([-Xc[1], Xc[0], zero]),
    ])  # [3, 3, D, L]
    dXc_dxi = jnp.concatenate(
        [jnp.broadcast_to(
            jnp.eye(3, dtype=x.dtype)[:, :, None, None], (3, 3, D_, L_)),
         -hatX], axis=1)  # [3, 6, D, L]
    Jp = -sum(Jproj[:, m][:, None] * dXc_dxi[m][None, :]
              for m in range(3))  # [3,6,D,L]
    # d e/d Xw = -Jproj @ R_obs
    Jl = -sum(Jproj[:, m][:, None] * Robs[m][None, :]
              for m in range(3))  # [3,3,D,L]
    return e, Jp, Jl, srow


def _obs_components(cam, prob: BAProblem, G_dlp, R, t, X):
    """Per-observation residual + Jacobian COMPONENTS in [.., D, L] layout
    (see _plane_components), pose rows gathered through the one-hot as ONE
    fat GEMM [D*L, P] @ [P, 12] — the einsum form "dlp,pli->idl" is a
    [24]-contraction batched over L."""
    L, D = prob.obs_w.shape
    RTobs = _gather_pose_rows(G_dlp, R, t)
    Robs = RTobs[..., :9].reshape(D, L, 3, 3).transpose(2, 3, 0, 1)  # [3,3,D,L]
    tobs = RTobs[..., 9:].transpose(2, 0, 1)  # [3, D, L]
    obsT = prob.obs_uvr.transpose(2, 1, 0)  # [3, D, L]
    return _plane_components(cam, Robs, tobs, obsT, X)


def _obs_components_gather(cam, prob: BAProblem, R, t, X):
    """Per-observation components in [.., D, L] layout with pose rows
    fetched by ROW GATHER instead of the one-hot GEMM — O(L*D) memory in
    P, for the dataset-scale CG path where a [D, L, P] one-hot would be
    hundreds of MB (P ~ 10^3)."""
    RT = jnp.concatenate([R.reshape(R.shape[0], 9), t], axis=1)  # [P, 12]
    RTobs = RT[prob.obs_pose]  # [L, D, 12]
    RTf = RTobs.transpose(2, 1, 0)  # [12, D, L]
    Robs = RTf[:9].reshape(3, 3, *RTf.shape[1:])
    tobs = RTf[9:]
    obsT = prob.obs_uvr.transpose(2, 1, 0)
    return _plane_components(cam, Robs, tobs, obsT, X)


def _gather_pose_rows(G_dlp, R, t):
    """[D, L, 12] pose rows (R flattened, t) per observation through the
    one-hot [D, L, P]. HIGHEST keeps the selection exact: at default
    precision a GPU runs this f32 GEMM in TF32 and rounds every pose
    entry to ~1e-3 relative (measured: final chi2 0.5% off the f32 result
    at L=8000, D=8, P=24)."""
    D, L, P = G_dlp.shape
    RT = jnp.concatenate([R.reshape(P, 9), t], axis=1)  # [P, 12]
    return jnp.matmul(G_dlp.reshape(D * L, P), RT,
                      precision=jax.lax.Precision.HIGHEST).reshape(D, L, 12)


def _eval_chi2_T(cam, prob: BAProblem, G_dlp, w_active, R, t, X):
    """Per-observation chi2 in [D, L] layout (active-masked)."""
    D, L, _ = G_dlp.shape
    RTobs = _gather_pose_rows(G_dlp, R, t)
    Robs = RTobs[..., :9].reshape(D, L, 3, 3).transpose(2, 3, 0, 1)
    tobs = RTobs[..., 9:]
    Xc = jnp.stack([
        sum(Robs[i, j] * X[:, j] for j in range(3)) + tobs[..., i]
        for i in range(3)])
    x, y, z = Xc[0], Xc[1], Xc[2]
    z = jnp.where(jnp.abs(z) < 1e-9, 1e-9, z)
    iz = 1.0 / z
    obs = prob.obs_uvr.transpose(2, 1, 0)
    srow = (obs[2] >= 0).astype(jnp.float32)
    u = cam.fx * x * iz + cam.cx
    v = cam.fy * y * iz + cam.cy
    ur = u - cam.bf * iz
    e2 = ((obs[0] - u) ** 2 + (obs[1] - v) ** 2
          + ((obs[2] - ur) * srow) ** 2)
    return e2 * w_active


def _eval_chi2(cam, prob: BAProblem, R, t, X):
    """Per-observation chi2 in the public [L, D] layout."""
    P = R.shape[0]
    G_dlp = (prob.obs_pose.T[:, :, None]
             == jnp.arange(P, dtype=jnp.int32)).astype(jnp.float32)
    active = (prob.obs_w > 0) & prob.point_valid[:, None]
    w_active = jnp.where(active, prob.obs_w, 0.0).T
    return _eval_chi2_T(cam, prob, G_dlp, w_active, R, t, X).T


def ba_solve(
    cam: CamParams,
    prob: BAProblem,
    iters: int = 10,
    robust: bool = True,
    init_lambda: float = 1e-4,
) -> BAResult:
    """Run `iters` bounded LM iterations (reference interruption semantics —
    mbAbortBA — become 'call with fewer iters per chunk', SURVEY §2.5 P6)."""
    P = prob.R.shape[0]
    L, D = prob.obs_w.shape
    is_stereo_T = prob.obs_uvr[..., 2].T >= 0  # [D, L]
    delta_h = jnp.where(is_stereo_T, HUBER_STEREO, HUBER_MONO)
    active = (prob.obs_w > 0) & prob.point_valid[:, None]
    w_active = jnp.where(active, prob.obs_w, 0.0).T  # [D, L]
    free_pose = ~prob.pose_fixed
    # Normal-equation assembly at HIGH, which a GPU runs in TF32. On an
    # H100 at L=8000, D=8, P=24 (10 iterations) the final chi2 equals the
    # f32 CPU result to 1e-7 at both HIGH and HIGHEST, and HIGH solves in
    # 6.6 ms against 7.5 ms; accept/reject always compares exact f32
    # chi2, so an approximate Hessian can only slow convergence.
    hi = jax.lax.Precision.HIGH
    # One-hot observation->pose assignment [D, L, P]: every gather/scatter
    # over the pose axis becomes a matmul. ALL per-observation tensors
    # below keep the big (D, L) dims minor (see _obs_components). Whether
    # a plain gather/segment-sum is faster on a GPU is not measured yet.
    G = (prob.obs_pose.T[:, :, None]
         == jnp.arange(P, dtype=jnp.int32)).astype(jnp.float32)  # [D,L,P]
    free_obs = jnp.einsum("dlp,p->dl", G, free_pose.astype(jnp.float32),
                          precision=hi)
    eyeP = jnp.eye(P, dtype=jnp.float32)

    def iteration(carry, _):
        R, t, X, lam = carry
        e, Jp, Jl, _ = _obs_components(cam, prob, G, R, t, X)
        # e [3,D,L], Jp [3,6,D,L], Jl [3,3,D,L]
        chi2_i = jnp.sum(e * e, axis=0) * prob.obs_w.T  # [D, L]
        w_rob = (huber_weight(chi2_i, delta_h) if robust
                 else jnp.ones_like(chi2_i))
        w = w_active * w_rob  # [D, L]
        Jp = Jp * free_obs  # fixed poses: zero pose-Jacobians
        wJp = Jp * w  # [3,6,D,L]
        wJl = Jl * w

        # --- Hessian blocks (outputs keep L minor) ---
        # (r, d) contractions batched over L are unrolled in Python so
        # they fuse into f32 elementwise plane arithmetic instead of
        # [L]-batched micro-dots.
        Hll = sum(wJl[r, :, None, d] * Jl[r, None, :, d]
                  for r in range(3) for d in range(D))  # [3,3,L]
        bl = sum(wJl[r, :, d] * e[r, d][None]
                 for r in range(3) for d in range(D))  # [3, L]
        Y = sum(wJp[r][:, None] * Jl[r][None, :]
                for r in range(3))  # [6,3,D,L]
        # Hpp via an explicit [6,6,D,L] product then ONE clean GEMM against
        # the flattened one-hot: XLA's 3-operand einsum path for
        # "ridl,rjdl,dlp->pij" materializes a pose-major intermediate.
        Zpp = jnp.sum(wJp[:, :, None] * Jp[:, None, :], axis=0)  # [6,6,D,L]
        Hpp = jnp.einsum("ijdl,dlp->pij", Zpp, G, precision=hi)  # [P,6,6]
        bp = jnp.einsum("ridl,rdl,dlp->pi", wJp, e, G, precision=hi)

        # --- damping (multiplicative diagonal, floors for rank safety) ---
        diag_ll = jnp.clip(jnp.stack([Hll[0, 0], Hll[1, 1], Hll[2, 2]]),
                           1e-6, None)  # [3, L]
        eye3L = jnp.eye(3, dtype=Hll.dtype)[:, :, None]
        Hll_d = Hll + lam * diag_ll[None, :, :] * eye3L
        # invalid landmarks: identity block keeps the inverse well-posed
        Hll_d = jnp.where(prob.point_valid, Hll_d, eye3L)
        Hll_inv = _inv3x3(Hll_d.transpose(2, 0, 1)).transpose(1, 2, 0)
        # [3,3,L] closed-form batched inverse (transposes are tiny: the
        # inverse itself is elementwise on [L] component planes)

        # --- Schur complement ---
        # S[p,q] -= sum_l (sum_d G Y Hinv)[p] (sum_c G Y)[q]^T: the pair
        # sum factorizes through the one-hot G into three GEMM-shaped
        # contractions with (d, l) as the big axes.
        YHinv = sum(Y[:, m][:, None] * Hll_inv[m][None, :, None, :]
                    for m in range(3))  # [6,3,D,L]
        # the d-slot contraction against the one-hot is a [P,d]@[d,18]
        # batched-small matmul as an einsum; unrolling the D slot axis into
        # broadcast multiply-adds keeps it elementwise
        def _gdot(T):  # [6,3,D,L] -> [P, 18, L], summing slots through G
            Tf = T.reshape(18, D, L)
            acc = G[0].T[:, None, :] * Tf[None, :, 0]
            for d in range(1, D):
                acc = acc + G[d].T[:, None, :] * Tf[None, :, d]
            return acc
        A = _gdot(YHinv).reshape(P, 6, 3, L)  # [P,6,3,L]
        B = _gdot(Y).reshape(P, 6, 3, L)
        S_off = jnp.einsum("pikl,qjkl->pqij", A, B, precision=hi)
        diag_pp = jnp.clip(jnp.diagonal(Hpp, axis1=-2, axis2=-1), 1e-6, None)
        Hpp_d = Hpp + lam * jax.vmap(jnp.diag)(diag_pp)
        S = -S_off + jnp.einsum("pq,pij->pqij", eyeP, Hpp_d, precision=hi)
        b_corr = jnp.einsum("pikl,kl->pi", A, bl, precision=hi)
        b_s = bp - b_corr

        # Fixed poses: identity row/col, zero rhs.
        fixed = prob.pose_fixed
        eye6 = jnp.eye(6, dtype=S.dtype)
        keep = (free_pose[:, None] & free_pose[None, :]).astype(S.dtype)[..., None, None]
        S = S * keep
        S = S + jnp.einsum("pq,pij->pqij", eyeP,
                           jnp.where(fixed[:, None, None], eye6,
                                     jnp.zeros_like(eye6)), precision=hi)
        b_s = jnp.where(fixed[:, None], 0.0, b_s)

        # --- dense reduced solve ---
        S_mat = S.transpose(0, 2, 1, 3).reshape(P * 6, P * 6)
        dxi = -jnp.linalg.solve(S_mat, b_s.reshape(P * 6)).reshape(P, 6)

        # --- back-substitute landmarks ---
        # Hll dXl = -(bl + sum_d Y^T dxi_pose)
        dxi_obs = jnp.einsum("dlp,pi->idl", G, dxi, precision=hi)
        Yt_dxi = jnp.sum(Y * dxi_obs[:, None], axis=(0, 2))  # [3, L]
        rhs_l = bl + Yt_dxi
        dX = -jnp.stack([sum(Hll_inv[i, j] * rhs_l[j] for j in range(3))
                         for i in range(3)], axis=-1)  # [L, 3]
        dX = jnp.where(prob.point_valid[:, None], dX, 0.0)

        # --- candidate + accept/reject ---
        R_new, t_new = se3.retract(R, t, dxi)
        X_new = X + dX
        chi2_old = jnp.sum(jnp.where(active.T, chi2_i, 0.0))
        chi2_new = jnp.sum(_eval_chi2_T(cam, prob, G, w_active,
                                        R_new, t_new, X_new))
        finite = jnp.all(jnp.isfinite(dxi)) & jnp.all(jnp.isfinite(dX))
        ok = (chi2_new < chi2_old) & finite
        R = jnp.where(ok, R_new, R)
        t = jnp.where(ok, t_new, t)
        X = jnp.where(ok, X_new, X)
        lam = jnp.where(ok, lam * 0.5, lam * 5.0).clip(1e-9, 1e8)
        return (R, t, X, lam), chi2_old

    (R, t, X, lam_f), chi2_hist = jax.lax.scan(
        iteration, (prob.R, prob.t, prob.X,
                    jnp.asarray(init_lambda, jnp.float32)), None,
        length=iters)
    R = se3.orthonormalize(R)  # keyframe poses re-enter tracking chains
    obs_chi2 = _eval_chi2(cam, prob, R, t, X)
    return BAResult(R, t, X, jnp.sum(obs_chi2), obs_chi2, lam_f)


# ---------------------------------------------------------------------------
# dataset-scale BA: Schur + preconditioned CG, nothing dense in P
# ---------------------------------------------------------------------------
#
# ba_solve materializes a one-hot [D, L, P] observation->pose tensor and the
# dense reduced camera system [P*6, P*6] — the right trade at local-BA
# window sizes (P <= ~24: everything is matmuls, zero scatters), but
# quadratic-in-P memory makes it unusable for global BA over a KITTI-scale
# map (P ~ 1300, L ~ 10^5). ba_solve_cg keeps the SAME BAProblem layout and
# solves the reduced camera system ITERATIVELY: per LM step the Schur
# matvec S v = Hpp v - Hpl Hll^-1 Hlp v is evaluated through the
# landmark-major observation table (landmark-side contractions are einsums
# over the D slot axis — the table layout IS the Hll block structure — and
# only the pose side needs segment-sums), with block-Jacobi (Hpp^-1)
# preconditioned CG. Memory is O(L*D) and the per-iteration cost is
# O(L*D*36) FLOPs — global BA over the whole map in bounded chunks
# (reference: GlobalBundleAdjustemnt Optimizer.cc:41-255, 10 iterations,
# interruptible; SURVEY §2.5 P3/P6).


def _batched_inv6(M: jax.Array) -> jax.Array:
    """[P,6,6] block inverse (batched LU; blocks are damped SPD + identity
    rows for fixed poses, so this is well-conditioned)."""
    return jnp.linalg.inv(M)


def ba_solve_cg(
    cam: CamParams,
    prob: BAProblem,
    iters: int = 10,
    cg_iters: int = 40,
    robust: bool = True,
    init_lambda: float = 1e-4,
) -> BAResult:
    """LM bundle adjustment with CG-on-Schur (see module comment above)."""
    P = prob.R.shape[0]
    L, D = prob.obs_w.shape
    flat_pose = prob.obs_pose.reshape(-1)
    is_stereo_T = prob.obs_uvr[..., 2].T >= 0  # [D, L]
    delta_h = jnp.where(is_stereo_T, HUBER_STEREO, HUBER_MONO)
    active = (prob.obs_w > 0) & prob.point_valid[:, None]
    w_active = jnp.where(active, prob.obs_w, 0.0).T  # [D, L]
    free_pose = ~prob.pose_fixed
    free_obs = free_pose[prob.obs_pose].astype(jnp.float32).T  # [D, L]
    # HIGH runs these f32 contractions in TF32 on a GPU (10-bit mantissa)
    hi = jax.lax.Precision.HIGH

    def chi2_at(R, t, X):
        # [L, D] for the public obs_chi2 contract
        return _eval_chi2_gather_T(cam, prob, w_active, R, t, X).T

    def _eval_chi2_gather_T(cam_, prob_, w_act, R, t, X):
        RT = jnp.concatenate([R.reshape(P, 9), t], axis=1)
        RTf = RT[prob_.obs_pose].transpose(2, 1, 0)  # [12, D, L]
        Robs = RTf[:9].reshape(3, 3, D, L)
        tobs = RTf[9:]
        Xc = jnp.stack([
            sum(Robs[i, j] * X[:, j] for j in range(3)) + tobs[i]
            for i in range(3)])
        z = jnp.where(jnp.abs(Xc[2]) < 1e-9, 1e-9, Xc[2])
        iz = 1.0 / z
        obsT = prob_.obs_uvr.transpose(2, 1, 0)
        srow = (obsT[2] >= 0).astype(jnp.float32)
        u = cam_.fx * Xc[0] * iz + cam_.cx
        v = cam_.fy * Xc[1] * iz + cam_.cy
        ur = u - cam_.bf * iz
        e2 = ((obsT[0] - u) ** 2 + (obsT[1] - v) ** 2
              + ((obsT[2] - ur) * srow) ** 2)
        return e2 * w_act

    def iteration(carry, _):
        R, t, X, lam = carry
        e, Jp, Jl, _ = _obs_components_gather(cam, prob, R, t, X)
        # e [3,D,L], Jp [3,6,D,L], Jl [3,3,D,L]
        chi2_i = jnp.sum(e * e, axis=0) * prob.obs_w.T  # [D, L]
        w_rob = (huber_weight(chi2_i, delta_h) if robust
                 else jnp.ones_like(chi2_i))
        w = w_active * w_rob  # [D, L]
        Jp = Jp * free_obs
        wJp = Jp * w
        wJl = Jl * w
        # landmark-side blocks: unrolled plane contractions (no scatters)
        Hll = sum(wJl[r, :, None, d] * Jl[r, None, :, d]
                  for r in range(3) for d in range(D))  # [3,3,L]
        bl = sum(wJl[r, :, d] * e[r, d][None]
                 for r in range(3) for d in range(D))  # [3, L]
        Y = sum(wJp[r][:, None] * Jl[r][None, :]
                for r in range(3))  # [6,3,D,L]
        # pose-side diagonal blocks: ONE segment-sum over observations
        Zpp = sum(wJp[r][:, None] * Jp[r][None, :]
                  for r in range(3))  # [6,6,D,L]
        Hpp = jax.ops.segment_sum(
            Zpp.transpose(3, 2, 0, 1).reshape(-1, 6, 6),
            flat_pose, num_segments=P)
        zbp = sum(wJp[r] * e[r][None] for r in range(3))  # [6, D, L]
        bp = jax.ops.segment_sum(
            zbp.transpose(2, 1, 0).reshape(-1, 6),
            flat_pose, num_segments=P)
        diag_ll = jnp.clip(jnp.stack([Hll[0, 0], Hll[1, 1], Hll[2, 2]]),
                           1e-6, None)  # [3, L]
        eye3L = jnp.eye(3, dtype=Hll.dtype)[:, :, None]
        Hll_d = Hll + lam * diag_ll[None, :, :] * eye3L
        Hll_d = jnp.where(prob.point_valid, Hll_d, eye3L)
        Hll_inv = _inv3x3(Hll_d.transpose(2, 0, 1)).transpose(1, 2, 0)
        # [3,3,L]
        diag_pp = jnp.clip(jnp.diagonal(Hpp, axis1=-2, axis2=-1), 1e-6, None)
        Hpp_d = Hpp + lam * jax.vmap(jnp.diag)(diag_pp)
        eye6 = jnp.eye(6, dtype=Hpp.dtype)
        Hpp_d = jnp.where(free_pose[:, None, None], Hpp_d, eye6)
        Minv = _batched_inv6(Hpp_d)  # block-Jacobi preconditioner

        def S_mv(v):  # v [P, 6] -> S v
            vpT = v[prob.obs_pose].transpose(2, 1, 0)  # [6, D, L]
            a = jnp.sum(Y * vpT[:, None], axis=(0, 2))  # [3, L]
            y = jnp.stack([sum(Hll_inv[i, j] * a[j] for j in range(3))
                           for i in range(3)])  # [3, L]
            c = sum(Y[:, j] * y[j][None, None, :] for j in range(3))
            # [6, D, L]
            s = jax.ops.segment_sum(
                c.transpose(2, 1, 0).reshape(-1, 6), flat_pose,
                num_segments=P)
            out = jnp.einsum("pij,pj->pi", Hpp_d, v, precision=hi) - s
            return jnp.where(free_pose[:, None], out, v)

        # rhs of S dxi = -b_s with b_s = bp - Hpl Hll^-1 bl
        yb = jnp.stack([sum(Hll_inv[i, j] * bl[j] for j in range(3))
                        for i in range(3)])  # [3, L]
        cb = sum(Y[:, j] * yb[j][None, None, :] for j in range(3))
        corr = jax.ops.segment_sum(
            cb.transpose(2, 1, 0).reshape(-1, 6), flat_pose,
            num_segments=P)
        b_s = jnp.where(free_pose[:, None], bp - corr, 0.0)
        rhs = -b_s

        def cg_body(cgc, _):
            x, r, z, p, rz = cgc
            Ap = S_mv(p)
            pAp = jnp.sum(p * Ap)
            alpha = rz / jnp.where(jnp.abs(pAp) < 1e-20, 1e-20, pAp)
            x = x + alpha * p
            r = r - alpha * Ap
            z = jnp.einsum("pij,pj->pi", Minv, r, precision=hi)
            rz_new = jnp.sum(r * z)
            beta = rz_new / jnp.where(jnp.abs(rz) < 1e-20, 1e-20, rz)
            p = z + beta * p
            return (x, r, z, p, rz_new), None

        x0 = jnp.zeros_like(rhs)
        r0 = rhs
        z0 = jnp.einsum("pij,pj->pi", Minv, r0, precision=hi)
        (dxi, *_), _ = jax.lax.scan(
            cg_body, (x0, r0, z0, z0, jnp.sum(r0 * z0)), None,
            length=cg_iters)
        dxi = jnp.where(free_pose[:, None], dxi, 0.0)

        # back-substitute landmarks
        dxiT = dxi[prob.obs_pose].transpose(2, 1, 0)  # [6, D, L]
        Yt_dxi = jnp.sum(Y * dxiT[:, None], axis=(0, 2))  # [3, L]
        rhs_l = bl + Yt_dxi
        dX = -jnp.stack([sum(Hll_inv[i, j] * rhs_l[j] for j in range(3))
                         for i in range(3)], axis=-1)  # [L, 3]
        dX = jnp.where(prob.point_valid[:, None], dX, 0.0)

        R_new, t_new = se3.retract(R, t, dxi)
        X_new = X + dX
        chi2_old = jnp.sum(jnp.where(active.T, chi2_i, 0.0))
        chi2_new = jnp.sum(chi2_at(R_new, t_new, X_new))
        finite = jnp.all(jnp.isfinite(dxi)) & jnp.all(jnp.isfinite(dX))
        ok = (chi2_new < chi2_old) & finite
        R = jnp.where(ok, R_new, R)
        t = jnp.where(ok, t_new, t)
        X = jnp.where(ok, X_new, X)
        lam = jnp.where(ok, lam * 0.5, lam * 5.0).clip(1e-9, 1e8)
        return (R, t, X, lam), chi2_old

    (R, t, X, lam_f), _ = jax.lax.scan(
        iteration, (prob.R, prob.t, prob.X,
                    jnp.asarray(init_lambda, jnp.float32)),
        None, length=iters)
    R = se3.orthonormalize(R)
    obs_chi2 = chi2_at(R, t, X)
    return BAResult(R, t, X, jnp.sum(obs_chi2), obs_chi2, lam_f)
