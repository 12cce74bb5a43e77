"""Sim(3) pose-graph (essential graph) optimization.

JAX rebuild of the reference's ``Optimizer::OptimizeEssentialGraph``
(reference: Optimizer.cc:829-1118): vertices are Sim3 world->keyframe poses,
edges are relative Sim3 measurements (loop edges, spanning-tree edges,
strong-covisibility edges w>=100), error = log(S_ji^-1 * S_jw * S_iw^-1)
with identity information, Gauss-Newton with autodiff Jacobians, all edges
batched with vmap. ``fix_scale`` freezes the 7th (scale) coordinate for
stereo/RGB-D (reference: bFixScale via System.cc:100).

The reference runs 20 LM iterations with lambda_init=1e-16 (Optimizer.cc:843,
1057) — effectively Gauss-Newton; we default to the same.
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..geometry import sim3


class PoseGraphProblem(NamedTuple):
    # Vertices: world->keyframe Sim3, [N]
    R: jax.Array  # [N, 3, 3]
    t: jax.Array  # [N, 3]
    s: jax.Array  # [N]
    # Edges: measurement S_ji (= S_jw * S_iw^-1 at measurement time), [E]
    e_i: jax.Array  # [E] int32 from-vertex
    e_j: jax.Array  # [E] int32 to-vertex
    m_R: jax.Array  # [E, 3, 3]
    m_t: jax.Array  # [E, 3]
    m_s: jax.Array  # [E]
    e_valid: jax.Array  # [E] bool
    v_fixed: jax.Array  # [N] bool (the loop keyframe, reference Optimizer.cc:891)


class PoseGraphResult(NamedTuple):
    R: jax.Array
    t: jax.Array
    s: jax.Array
    chi2: jax.Array


def _edge_residual(Ri, ti, si, Rj, tj, sj, mR, mt, ms):
    """e = log( S_ji^meas^-1 * S_jw * S_iw^-1 )  [7]."""
    iR, it, is_ = sim3.inverse(Ri, ti, si)
    Rji, tji, sji = sim3.compose(Rj, tj, sj, iR, it, is_)
    imR, imt, ims = sim3.inverse(mR, mt, ms)
    Re, te, se_ = sim3.compose(imR, imt, ims, Rji, tji, sji)
    return sim3.log(Re, te, se_)


def optimize_pose_graph(
    prob: PoseGraphProblem,
    iters: int = 20,
    fix_scale: bool = False,
) -> PoseGraphResult:
    N = prob.R.shape[0]

    def residual_wrt_updates(xi_i, xi_j, Ri, ti, si, Rj, tj, sj, mR, mt, ms):
        Ri2, ti2, si2 = sim3.retract(Ri, ti, si, xi_i)
        Rj2, tj2, sj2 = sim3.retract(Rj, tj, sj, xi_j)
        return _edge_residual(Ri2, ti2, si2, Rj2, tj2, sj2, mR, mt, ms)

    # Jacobians of the 7-vector residual wrt the two 7-vector twists at 0.
    jac_fn = jax.vmap(
        jax.jacfwd(residual_wrt_updates, argnums=(0, 1)),
        in_axes=(0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0),
    )
    res_fn = jax.vmap(_edge_residual)

    def gather(Rv, tv, sv):
        return (
            Rv[prob.e_i], tv[prob.e_i], sv[prob.e_i],
            Rv[prob.e_j], tv[prob.e_j], sv[prob.e_j],
        )

    free = (~prob.v_fixed).astype(prob.R.dtype)
    E = prob.e_i.shape[0]
    zeros7 = jnp.zeros((E, 7), prob.R.dtype)
    w_edge = prob.e_valid.astype(prob.R.dtype)

    def iteration(carry, _):
        Rv, tv, sv, lam = carry
        Ri, ti, si, Rj, tj, sj = gather(Rv, tv, sv)
        e = res_fn(Ri, ti, si, Rj, tj, sj, prob.m_R, prob.m_t, prob.m_s)  # [E,7]
        Ji, Jj = jac_fn(
            zeros7, zeros7, Ri, ti, si, Rj, tj, sj, prob.m_R, prob.m_t, prob.m_s
        )  # [E,7,7] each
        # Freeze fixed vertices; optionally freeze scale coordinate.
        Ji = Ji * free[prob.e_i][:, None, None]
        Jj = Jj * free[prob.e_j][:, None, None]
        if fix_scale:
            Ji = Ji.at[:, :, 6].set(0.0)
            Jj = Jj.at[:, :, 6].set(0.0)
        wJi = Ji * w_edge[:, None, None]
        wJj = Jj * w_edge[:, None, None]
        # Assemble dense H [N,7,N,7] and b [N,7] by segment-sum of blocks.
        Hii = jnp.einsum("eri,erj->eij", wJi, Ji)
        Hjj = jnp.einsum("eri,erj->eij", wJj, Jj)
        Hij = jnp.einsum("eri,erj->eij", wJi, Jj)
        bi = jnp.einsum("eri,er->ei", wJi, e)
        bj = jnp.einsum("eri,er->ei", wJj, e)
        idx_ii = prob.e_i * N + prob.e_i
        idx_jj = prob.e_j * N + prob.e_j
        idx_ij = prob.e_i * N + prob.e_j
        idx_ji = prob.e_j * N + prob.e_i
        H = jax.ops.segment_sum(
            jnp.concatenate([Hii, Hjj, Hij, jnp.swapaxes(Hij, -1, -2)], axis=0),
            jnp.concatenate([idx_ii, idx_jj, idx_ij, idx_ji], axis=0),
            num_segments=N * N,
        ).reshape(N, N, 7, 7)
        b = jax.ops.segment_sum(
            jnp.concatenate([bi, bj], axis=0),
            jnp.concatenate([prob.e_i, prob.e_j], axis=0),
            num_segments=N,
        )
        # Damping + gauge: fixed vertices and (optionally) scale coords get
        # identity diagonal so the dense solve stays nonsingular.
        diag_idx = jnp.arange(N)
        Hd = H.at[diag_idx, diag_idx].add(
            lam * jnp.eye(7, dtype=H.dtype) + 1e-8 * jnp.eye(7, dtype=H.dtype)
        )
        fixed_f = prob.v_fixed.astype(H.dtype)
        Hd = Hd.at[diag_idx, diag_idx].add(fixed_f[:, None, None] * jnp.eye(7, dtype=H.dtype))
        if fix_scale:
            scale_fix = jnp.zeros((7, 7), H.dtype).at[6, 6].set(1.0)
            Hd = Hd.at[diag_idx, diag_idx].add(scale_fix)
        b = b * free[:, None]
        H_mat = Hd.transpose(0, 2, 1, 3).reshape(N * 7, N * 7)
        dxi = -jnp.linalg.solve(H_mat, b.reshape(N * 7)).reshape(N, 7)
        if fix_scale:
            dxi = dxi.at[:, 6].set(0.0)
        dxi = dxi * free[:, None]
        R_new, t_new, s_new = sim3.retract(Rv, tv, sv, dxi)
        chi2_old = jnp.sum(e * e * w_edge[:, None])
        e_new = res_fn(*gather(R_new, t_new, s_new), prob.m_R, prob.m_t, prob.m_s)
        chi2_new = jnp.sum(e_new * e_new * w_edge[:, None])
        ok = (chi2_new < chi2_old) & jnp.all(jnp.isfinite(dxi))
        Rv = jnp.where(ok, R_new, Rv)
        tv = jnp.where(ok, t_new, tv)
        sv = jnp.where(ok, s_new, sv)
        lam = jnp.where(ok, lam * 0.5, lam * 10.0).clip(1e-16, 1e8)
        return (Rv, tv, sv, lam), chi2_old

    init = (prob.R, prob.t, prob.s, jnp.float32(1e-16))
    (Rv, tv, sv, _), hist = jax.lax.scan(iteration, init, None, length=iters)
    e = res_fn(*gather(Rv, tv, sv), prob.m_R, prob.m_t, prob.m_s)
    chi2 = jnp.sum(e * e * w_edge[:, None])
    return PoseGraphResult(Rv, tv, sv, chi2)


def optimize_pose_graph_cg(
    prob: PoseGraphProblem,
    iters: int = 20,
    fix_scale: bool = False,
    cg_iters: int | None = None,
) -> PoseGraphResult:
    """Matrix-free essential-graph solve for dataset-scale maps.

    optimize_pose_graph assembles the DENSE [N*7, N*7] normal matrix —
    the right trade below N≈256 vertices (one Cholesky, no
    scatters), but ~441 MB of H blocks at K=1500. This variant solves the
    same Gauss-Newton system ITERATIVELY: the Hessian is only ever
    applied edge-wise (H v = Σ_e J_e^T (J_e v_gather)), with block-Jacobi
    (7x7 vertex blocks) preconditioned CG — memory O(E·49), matching the
    reference's sparse g2o solve (Optimizer.cc:829-1118) in structure.
    Same PoseGraphProblem layout and semantics as the dense path.

    cg_iters defaults to 2N: block-Jacobi CG moves information ~one
    vertex per iteration along the temporal chain, and a loop correction
    is a GLOBAL mode (for monocular scale drift, literally a smooth
    scale ramp across every vertex) — with fewer iterations than the
    chain length, the correction stalls ~cg_iters keyframes from the
    loop edge and the rest of the trajectory keeps its drift. The dense
    path (and the reference's g2o sparse Cholesky, Optimizer.cc:1057)
    solves each Gauss-Newton step exactly; 2N-iteration CG restores that
    parity at O(E) memory. Each iteration is a handful of edge-wise
    7-vector ops — latency-, not flop-bound.
    """
    N = prob.R.shape[0]
    if cg_iters is None:
        cg_iters = max(60, 2 * N)

    def residual_wrt_updates(xi_i, xi_j, Ri, ti, si, Rj, tj, sj,
                             mR, mt, ms):
        Ri2, ti2, si2 = sim3.retract(Ri, ti, si, xi_i)
        Rj2, tj2, sj2 = sim3.retract(Rj, tj, sj, xi_j)
        return _edge_residual(Ri2, ti2, si2, Rj2, tj2, sj2, mR, mt, ms)

    jac_fn = jax.vmap(
        jax.jacfwd(residual_wrt_updates, argnums=(0, 1)),
        in_axes=(0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0),
    )
    res_fn = jax.vmap(_edge_residual)

    def gather(Rv, tv, sv):
        return (
            Rv[prob.e_i], tv[prob.e_i], sv[prob.e_i],
            Rv[prob.e_j], tv[prob.e_j], sv[prob.e_j],
        )

    free = (~prob.v_fixed).astype(prob.R.dtype)
    E = prob.e_i.shape[0]
    zeros7 = jnp.zeros((E, 7), prob.R.dtype)
    w_edge = prob.e_valid.astype(prob.R.dtype)
    eye7 = jnp.eye(7, dtype=prob.R.dtype)

    def iteration(carry, _):
        Rv, tv, sv, lam = carry
        Ri, ti, si, Rj, tj, sj = gather(Rv, tv, sv)
        e = res_fn(Ri, ti, si, Rj, tj, sj, prob.m_R, prob.m_t, prob.m_s)
        Ji, Jj = jac_fn(zeros7, zeros7, Ri, ti, si, Rj, tj, sj,
                        prob.m_R, prob.m_t, prob.m_s)  # [E,7,7]
        Ji = Ji * free[prob.e_i][:, None, None]
        Jj = Jj * free[prob.e_j][:, None, None]
        if fix_scale:
            Ji = Ji.at[:, :, 6].set(0.0)
            Jj = Jj.at[:, :, 6].set(0.0)
        sw = jnp.sqrt(w_edge)[:, None, None]
        Ji = Ji * sw  # fold edge weights into J so H = J^T J exactly
        Jj = Jj * sw
        ew = e * jnp.sqrt(w_edge)[:, None]
        # gradient b = J^T e
        b = (jax.ops.segment_sum(
                jnp.einsum("eri,er->ei", Ji, ew), prob.e_i,
                num_segments=N)
             + jax.ops.segment_sum(
                jnp.einsum("eri,er->ei", Jj, ew), prob.e_j,
                num_segments=N))
        b = b * free[:, None]
        # block-diagonal of H (+ damping + gauge), for the preconditioner
        # and the damped matvec
        Dii = (jax.ops.segment_sum(
                  jnp.einsum("eri,erj->eij", Ji, Ji), prob.e_i,
                  num_segments=N)
               + jax.ops.segment_sum(
                  jnp.einsum("eri,erj->eij", Jj, Jj), prob.e_j,
                  num_segments=N))
        reg = ((lam + 1e-8) * eye7
               + prob.v_fixed.astype(eye7.dtype)[:, None, None] * eye7)
        if fix_scale:
            reg = reg + jnp.zeros((7, 7), eye7.dtype).at[6, 6].set(1.0)
        Minv = jnp.linalg.inv(Dii + reg)

        def Hmv(v):  # damped-H @ v, edge-wise
            u = (jnp.einsum("eij,ej->ei", Ji, v[prob.e_i])
                 + jnp.einsum("eij,ej->ei", Jj, v[prob.e_j]))
            r = (jax.ops.segment_sum(
                    jnp.einsum("eri,er->ei", Ji, u), prob.e_i,
                    num_segments=N)
                 + jax.ops.segment_sum(
                    jnp.einsum("eri,er->ei", Jj, u), prob.e_j,
                    num_segments=N))
            return r + jnp.einsum("nij,nj->ni", reg, v)

        rhs = -b

        def cg_body(cgc, _):
            x, r, z, p, rz = cgc
            Ap = Hmv(p)
            pAp = jnp.sum(p * Ap)
            alpha = rz / jnp.where(jnp.abs(pAp) < 1e-20, 1e-20, pAp)
            x = x + alpha * p
            r = r - alpha * Ap
            z = jnp.einsum("nij,nj->ni", Minv, r)
            rz_new = jnp.sum(r * z)
            beta = rz_new / jnp.where(jnp.abs(rz) < 1e-20, 1e-20, rz)
            p = z + beta * p
            return (x, r, z, p, rz_new), None

        x0 = jnp.zeros_like(rhs)
        z0 = jnp.einsum("nij,nj->ni", Minv, rhs)
        (dxi, *_), _ = jax.lax.scan(
            cg_body, (x0, rhs, z0, z0, jnp.sum(rhs * z0)), None,
            length=cg_iters)
        if fix_scale:
            dxi = dxi.at[:, 6].set(0.0)
        dxi = dxi * free[:, None]
        R_new, t_new, s_new = sim3.retract(Rv, tv, sv, dxi)
        chi2_old = jnp.sum(e * e * w_edge[:, None])
        e_new = res_fn(*gather(R_new, t_new, s_new),
                       prob.m_R, prob.m_t, prob.m_s)
        chi2_new = jnp.sum(e_new * e_new * w_edge[:, None])
        ok = (chi2_new < chi2_old) & jnp.all(jnp.isfinite(dxi))
        Rv = jnp.where(ok, R_new, Rv)
        tv = jnp.where(ok, t_new, tv)
        sv = jnp.where(ok, s_new, sv)
        lam = jnp.where(ok, lam * 0.5, lam * 10.0).clip(1e-16, 1e8)
        return (Rv, tv, sv, lam), chi2_old

    init = (prob.R, prob.t, prob.s, jnp.float32(1e-16))
    (Rv, tv, sv, _), _ = jax.lax.scan(iteration, init, None, length=iters)
    e = res_fn(*gather(Rv, tv, sv), prob.m_R, prob.m_t, prob.m_s)
    chi2 = jnp.sum(e * e * w_edge[:, None])
    return PoseGraphResult(Rv, tv, sv, chi2)
