"""Pose-only optimization (motion-only bundle adjustment).

JAX rebuild of the reference's ``Optimizer::PoseOptimization``
(reference: Optimizer.cc:257-481): one SE3 pose, N unary reprojection edges
against fixed landmarks, 4 rounds x 10 LM iterations, chi-squared
inlier/outlier reclassification between rounds (outliers may return), Huber
kernel active for the first two rounds only (reference drops it at round 3,
Optimizer.cc:436-437).

Everything is fixed-shape: observations carry a validity mask, outliers are
expressed as a weight mask — no dynamic resizing, one compiled XLA program.
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..geometry import se3
from .residuals import (
    CHI2_MONO,
    CHI2_STEREO,
    CamParams,
    HUBER_MONO,
    HUBER_STEREO,
    huber_weight,
    reproj_residual,
)


class PoseOptResult(NamedTuple):
    R: jax.Array  # [3, 3] optimized world->camera rotation
    t: jax.Array  # [3]
    inliers: jax.Array  # [N] bool, post-optimization classification
    n_inliers: jax.Array  # [] int32
    chi2: jax.Array  # [] final total chi2 over inliers


def _per_obs_chi2(cam, R, t, Xw, obs_uvr, inv_sigma2):
    e, _, _ = reproj_residual(cam, R, t, Xw, obs_uvr)
    return jnp.sum(e * e, axis=-1) * inv_sigma2


def _pose_components_T(cam, R, t, XwT, obsT, srow):
    """Residual + pose Jacobian in [row, N] / [row, 6, N] plane layout.

    Keeping N minor (instead of the [N, 3, 6] layout of
    reproj_jacobians, whose tiny 3x3 @ 3x6 products lower as [N]-batched
    micro-dots) makes every step fused elementwise plane arithmetic and
    the normal equations one big-K GEMM (same rewrite as
    optim.ba._obs_components)."""
    x = R[0, 0] * XwT[0] + R[0, 1] * XwT[1] + R[0, 2] * XwT[2] + t[0]
    y = R[1, 0] * XwT[0] + R[1, 1] * XwT[1] + R[1, 2] * XwT[2] + t[1]
    z = R[2, 0] * XwT[0] + R[2, 1] * XwT[1] + R[2, 2] * XwT[2] + t[2]
    z = jnp.where(jnp.abs(z) < 1e-9, 1e-9, z)
    iz = 1.0 / z
    iz2 = iz * iz
    u = cam.fx * x * iz + cam.cx
    v = cam.fy * y * iz + cam.cy
    ur = u - cam.bf * iz
    e = jnp.stack([obsT[0] - u, obsT[1] - v, (obsT[2] - ur) * srow])
    zero = jnp.zeros_like(x)
    Jproj = jnp.stack([
        jnp.stack([cam.fx * iz, zero, -cam.fx * x * iz2]),
        jnp.stack([zero, cam.fy * iz, -cam.fy * y * iz2]),
        jnp.stack([(cam.fx * iz) * srow, zero,
                   (-cam.fx * x * iz2 + cam.bf * iz2) * srow]),
    ])  # [3, 3, N]
    one = jnp.ones_like(x)
    Xc = jnp.stack([x, y, z])
    dXc_dxi = jnp.stack([
        jnp.stack([one, zero, zero, zero, Xc[2], -Xc[1]]),
        jnp.stack([zero, one, zero, -Xc[2], zero, Xc[0]]),
        jnp.stack([zero, zero, one, Xc[1], -Xc[0], zero]),
    ])  # [3, 6, N]  ([I | -hat(Xc)])
    Jp = -sum(Jproj[:, m][:, None] * dXc_dxi[m][None, :]
              for m in range(3))  # [3, 6, N]
    return e, Jp


def optimize_pose(
    cam: CamParams,
    R0: jax.Array,
    t0: jax.Array,
    Xw: jax.Array,
    obs_uvr: jax.Array,
    inv_sigma2: jax.Array,
    valid: jax.Array,
    rounds: int = 4,
    iters_per_round: int = 10,
) -> PoseOptResult:
    """Optimize a single pose against fixed landmarks.

    Args:
      cam: intrinsics (+bf for stereo rows).
      R0, t0: initial world->camera pose.
      Xw: [N, 3] landmark positions (fixed).
      obs_uvr: [N, 3] observations (u, v, u_r); u_r < 0 => mono.
      inv_sigma2: [N] per-observation information scale (1/1.2^(2 level)).
      valid: [N] bool mask of real observations.
    """
    is_stereo = obs_uvr[..., 2] >= 0
    chi2_th = jnp.where(is_stereo, CHI2_STEREO, CHI2_MONO)
    delta = jnp.where(is_stereo, HUBER_STEREO, HUBER_MONO)
    valid = valid.astype(jnp.bool_)
    XwT = Xw.T  # [3, N]
    obsT = obs_uvr.T  # [3, N]
    srow = is_stereo.astype(obs_uvr.dtype)

    def lm_iteration(state, sched):
        """sched = (robust_flag, kernel_scale). kernel_scale > 1 in early
        rounds is graduated non-convexity: a wide Huber basin first, so a
        motion-model prediction a few degrees off cannot trap the solve in
        a robust-cost local minimum (tight kernels flatten exactly the
        high-residual tail that discriminates the true pose), then the
        reference's standard kernel for the final rounds."""
        robust, kscale = sched
        R, t, lam, inlier = state
        e, Jp = _pose_components_T(cam, R, t, XwT, obsT, srow)
        chi2_i = jnp.sum(e * e, axis=0) * inv_sigma2  # [N]
        w_rob = jnp.where(robust, huber_weight(chi2_i, delta * kscale), 1.0)
        w = jnp.where(valid & inlier, inv_sigma2 * w_rob, 0.0)  # [N]
        wJp = Jp * w  # [3, 6, N]
        # normal equations as one big-K GEMM ([6, 3N] @ [3N, 6])
        H = jnp.einsum("rin,rjn->ij", wJp, Jp,
                       precision=jax.lax.Precision.HIGHEST)
        b = jnp.einsum("rin,rn->i", wJp, e,
                       precision=jax.lax.Precision.HIGHEST)
        D = jnp.diag(jnp.clip(jnp.diagonal(H), 1e-6, None))
        delta_xi = -jnp.linalg.solve(H + lam * D, b)
        R_new, t_new = se3.retract(R, t, delta_xi)
        # Accept iff total (robust-weighted) chi2 decreases.
        chi2_old = jnp.sum(jnp.where(valid & inlier, chi2_i * w_rob, 0.0))
        chi2_new_i = _per_obs_chi2(cam, R_new, t_new, Xw, obs_uvr, inv_sigma2)
        w_rob_new = jnp.where(robust, huber_weight(chi2_new_i, delta * kscale), 1.0)
        chi2_new = jnp.sum(jnp.where(valid & inlier, chi2_new_i * w_rob_new, 0.0))
        ok = (chi2_new < chi2_old) & jnp.all(jnp.isfinite(delta_xi))
        R = jnp.where(ok, R_new, R)
        t = jnp.where(ok, t_new, t)
        lam = jnp.where(ok, lam * 0.5, lam * 4.0).clip(1e-9, 1e6)
        return (R, t, lam, inlier), None

    def round_body(state, sched):
        robust, kscale = sched
        R, t, lam, inlier = state

        def body(carry, _):
            return lm_iteration(carry, (robust, kscale))

        (R, t, lam, inlier), _ = jax.lax.scan(
            body, (R, t, jnp.asarray(lam), inlier), None, length=iters_per_round
        )
        # Reclassify: chi2 against the threshold at the new pose; outliers can
        # come back (reference: Optimizer.cc:400-471 moves edges between
        # level 0/1 every round). Early wide-kernel rounds get a matching
        # widened gate so GNC progress is not trimmed away.
        chi2_i = _per_obs_chi2(cam, R, t, Xw, obs_uvr, inv_sigma2)
        inlier = chi2_i <= chi2_th * kscale * kscale
        return (R, t, lam, inlier), None

    # Reference schedule: Huber for the first two rounds, kernel-free
    # refinement afterwards (kscale plumbing kept for GNC experiments;
    # widening admitted too many wrong associations in testing).
    robust_schedule = jnp.arange(rounds) < 2
    kscale_schedule = jnp.ones(rounds, jnp.float32)
    init = (R0, t0, jnp.float32(1e-3), jnp.ones(Xw.shape[0], jnp.bool_))
    (R, t, _, inlier), _ = jax.lax.scan(
        round_body, init, (robust_schedule, kscale_schedule))

    inlier = inlier & valid
    chi2_i = _per_obs_chi2(cam, R, t, Xw, obs_uvr, inv_sigma2)
    total = jnp.sum(jnp.where(inlier, chi2_i, 0.0))
    # Re-project onto SO(3): tracking chains this pose through velocity
    # compositions that amplify non-orthonormality (se3.orthonormalize).
    R = se3.orthonormalize(R)
    return PoseOptResult(R, t, inlier, jnp.sum(inlier.astype(jnp.int32)), total)
