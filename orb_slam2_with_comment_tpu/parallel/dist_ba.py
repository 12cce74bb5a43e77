"""Distributed bundle adjustment over a device mesh.

The reference has no distributed capability (SURVEY.md §2.5 P7); this is the
multi-device scaling story from BASELINE.json: landmarks (and their
observation rows) are sharded across devices on a 1-D mesh axis ``lm``;
poses are replicated. Each device builds the partial pose-side normal
equations from its landmark shard, the reduced camera system is combined
with ``psum`` over the interconnect, solved (replicated dense Cholesky), and the
landmark back-substitution happens shard-locally — Schur-complement
reduction of landmark blocks over collectives, exactly the
"distributed BA via psum/all_gather" north star.

Works on any jax.sharding.Mesh — including the virtual
``--xla_force_host_platform_device_count`` CPU mesh used by tests and the
driver's multi-chip dry run.
"""
from __future__ import annotations

from functools import lru_cache, partial

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from ..geometry import se3
from ..optim.ba import BAProblem
from ..optim.residuals import (
    HUBER_MONO,
    HUBER_STEREO,
    huber_weight,
    reproj_jacobians,
    reproj_residual,
)


def _damp(Hblk, lam, eps):
    diag = jnp.clip(jnp.diagonal(Hblk, axis1=-2, axis2=-1), eps, None)
    n = diag.shape[-1]
    eye = jnp.eye(n, dtype=Hblk.dtype)
    return Hblk + lam * diag[..., None] * eye


@lru_cache(maxsize=32)
def _build_step(mesh: Mesh, P_n: int, robust: bool):
    """Compile one sharded GN/LM step for a (mesh, pose-count) signature.
    lam rides as a traced replicated scalar so retunes don't recompile."""
    lm_spec = P("lm")
    rep = P()

    @jax.jit
    @partial(
        shard_map,
        mesh=mesh,
        in_specs=(rep, rep, rep, lm_spec, lm_spec, lm_spec, lm_spec, rep, lm_spec, rep),
        out_specs=(rep, rep, lm_spec, rep),
    )
    def step(cam, R, t, X, obs_pose, obs_uvr, obs_w, pose_fixed, point_valid, lam):
        # every product at f32: the steps are accepted unchecked, and on a
        # GPU a TF32 Hessian and Schur complement made them diverge (4
        # H100s, P=64 L=50000: chi2 850x its start after 5 steps)
        with jax.default_matmul_precision("float32"):
            return _step_body(cam, R, t, X, obs_pose, obs_uvr, obs_w,
                              pose_fixed, point_valid, lam)

    def _step_body(cam, R, t, X, obs_pose, obs_uvr, obs_w, pose_fixed,
                   point_valid, lam):
        free_pose = ~pose_fixed
        is_stereo = obs_uvr[..., 2] >= 0
        delta_h = jnp.where(is_stereo, HUBER_STEREO, HUBER_MONO)
        active = (obs_w > 0) & point_valid[:, None]
        Rp = R[obs_pose]
        tp = t[obs_pose]
        e, Jp, Jl = reproj_jacobians(cam, Rp, tp, X[:, None, :], obs_uvr)
        chi2_i = jnp.sum(e * e, axis=-1) * obs_w
        w_rob = huber_weight(chi2_i, delta_h) if robust else jnp.ones_like(chi2_i)
        w = jnp.where(active, obs_w * w_rob, 0.0)
        Jp = Jp * free_pose[obs_pose].astype(Jp.dtype)[..., None, None]
        wJp = w[..., None, None] * Jp
        Hll = jnp.einsum("ldri,ldrj->lij", w[..., None, None] * Jl, Jl)
        bl = jnp.einsum("ldri,ldr->li", w[..., None, None] * Jl, e)
        Y = jnp.einsum("ldri,ldrj->ldij", wJp, Jl)
        flat_pose = obs_pose.reshape(-1)
        Hpp_part = jax.ops.segment_sum(
            jnp.einsum("ldri,ldrj->ldij", wJp, Jp).reshape(-1, 6, 6),
            flat_pose, num_segments=P_n)
        bp_part = jax.ops.segment_sum(
            jnp.einsum("ldri,ldr->ldi", wJp, e).reshape(-1, 6),
            flat_pose, num_segments=P_n)
        Hll_d = _damp(Hll, lam, 1e-6)
        eye3 = jnp.eye(3, dtype=Hll.dtype)
        Hll_d = jnp.where(point_valid[:, None, None], Hll_d, eye3)
        Hll_inv = jnp.linalg.inv(Hll_d)
        YHinv = jnp.einsum("ldij,ljk->ldik", Y, Hll_inv)
        pair = jnp.einsum("ldik,lcjk->ldcij", YHinv, Y)
        pair_idx = (obs_pose[:, :, None] * P_n + obs_pose[:, None, :]).reshape(-1)
        S_off_part = jax.ops.segment_sum(
            pair.reshape(-1, 6, 6), pair_idx, num_segments=P_n * P_n
        ).reshape(P_n, P_n, 6, 6)
        b_corr_part = jax.ops.segment_sum(
            jnp.einsum("ldik,lk->ldi", YHinv, bl).reshape(-1, 6),
            flat_pose, num_segments=P_n)
        chi2_part = jnp.sum(jnp.where(active, chi2_i, 0.0))

        # --- combine partial pose-side systems over the landmark shards ---
        Hpp = jax.lax.psum(Hpp_part, "lm")
        bp = jax.lax.psum(bp_part, "lm")
        S_off = jax.lax.psum(S_off_part, "lm")
        b_corr = jax.lax.psum(b_corr_part, "lm")
        chi2 = jax.lax.psum(chi2_part, "lm")

        Hpp_d = _damp(Hpp, lam, 1e-6)
        S = -S_off
        idx = jnp.arange(P_n)
        S = S.at[idx, idx].add(Hpp_d)
        b_s = bp - b_corr
        eye6 = jnp.eye(6, dtype=S.dtype)
        keep = (free_pose[:, None] & free_pose[None, :]).astype(S.dtype)[..., None, None]
        S = S * keep
        S = S.at[idx, idx].set(
            jnp.where(pose_fixed[:, None, None], eye6, S[idx, idx]))
        b_s = jnp.where(pose_fixed[:, None], 0.0, b_s)
        S_mat = S.transpose(0, 2, 1, 3).reshape(P_n * 6, P_n * 6)
        dxi = -jnp.linalg.solve(S_mat, b_s.reshape(-1)).reshape(P_n, 6)

        # --- shard-local landmark back-substitution ---
        Yt_dxi = jnp.einsum("ldij,ldi->lj", Y, dxi[obs_pose])
        dX = -jnp.einsum("lij,lj->li", Hll_inv, bl + Yt_dxi)
        dX = jnp.where(point_valid[:, None], dX, 0.0)

        R_new, t_new = se3.retract(R, t, dxi)
        X_new = X + dX
        return R_new, t_new, X_new, chi2

    return step


def ba_step_sharded(cam, prob: BAProblem, mesh: Mesh, lam: float = 1e-4,
                    robust: bool = True):
    """One Gauss-Newton/LM step with landmark-sharded Schur reduction.

    prob arrays must have L divisible by the mesh axis size.
    Returns (R, t, X, chi2_before).
    """
    step = _build_step(mesh, prob.R.shape[0], robust)
    return step(cam, prob.R, prob.t, prob.X, prob.obs_pose, prob.obs_uvr,
                prob.obs_w, prob.pose_fixed, prob.point_valid,
                jnp.float32(lam))


def ba_solve_sharded(cam, prob: BAProblem, mesh: Mesh, iters: int = 5,
                     lam: float = 1e-4, robust: bool = True):
    """Fixed-iteration sharded BA (accept-all steps; the single-device
    ba_solve keeps the adaptive accept/reject loop — distributed chunks
    favor fixed schedules to avoid per-iteration host sync)."""
    R, t, X = prob.R, prob.t, prob.X
    chi2 = None
    for _ in range(iters):
        R, t, X, chi2 = ba_step_sharded(
            cam, prob._replace(R=R, t=t, X=X), mesh, lam, robust)
    return R, t, X, chi2
