"""Break one dense-Schur LM iteration into parts and time each on the device.

Local BA is a large part of the keyframe-maintenance cycle; this isolates
where an LM iteration's time goes: Jacobian/residual assembly,
Hessian-block einsums, the Schur product, the dense [P*6, P*6] solve, or
the accept/reject chi2 pass.

Run: python scripts/profile_ba_parts.py
"""
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import jax
import jax.numpy as jnp

from orb_slam2_with_comment_tpu.runtime import enable_compilation_cache

enable_compilation_cache()

from orb_slam2_with_comment_tpu.optim import ba
from orb_slam2_with_comment_tpu.optim.residuals import CamParams

P, L, D = 24, 8192, 8


def make_problem(key):
    ks = jax.random.split(key, 8)
    X = jax.random.uniform(ks[0], (L, 3), minval=-4, maxval=4) + jnp.array([0, 0, 8.0])
    R = jnp.broadcast_to(jnp.eye(3), (P, 3, 3))
    t = jax.random.normal(ks[1], (P, 3)) * 0.1
    obs_pose = jax.random.randint(ks[2], (L, D), 0, P)
    cam = CamParams(500.0, 500.0, 320.0, 240.0, 40.0)
    # project to synthesize observations
    Rp = R[obs_pose]
    tp = t[obs_pose]
    Xc = jnp.einsum("ldij,lj->ldi", Rp, X) + tp
    z = jnp.clip(Xc[..., 2], 1e-3, None)
    u = cam.fx * Xc[..., 0] / z + cam.cx
    v = cam.fy * Xc[..., 1] / z + cam.cy
    ur = u - cam.bf / z
    uvr = jnp.stack([u, v, ur], axis=-1)
    uvr = uvr + jax.random.normal(ks[3], uvr.shape) * 0.5
    prob = ba.BAProblem(
        R=R, t=t, X=X + jax.random.normal(ks[4], X.shape) * 0.05,
        obs_pose=obs_pose, obs_uvr=uvr,
        obs_w=jnp.ones((L, D), jnp.float32),
        pose_fixed=jnp.zeros(P, bool).at[0].set(True),
        point_valid=jnp.ones(L, bool))
    return cam, prob


def timeit(fn, *args, n=30):
    out = jax.block_until_ready(fn(*args))
    t0 = time.perf_counter()
    for _ in range(n):
        out = fn(*args)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / n


def main():
    cam, prob = make_problem(jax.random.PRNGKey(0))
    hi = jax.lax.Precision.HIGH
    G = (prob.obs_pose.T[:, :, None]
         == jnp.arange(P, dtype=jnp.int32)).astype(jnp.float32)
    free_pose = ~prob.pose_fixed
    active = (prob.obs_w > 0) & prob.point_valid[:, None]
    w_active = jnp.where(active, prob.obs_w, 0.0).T

    @jax.jit
    def f_components(R, t, X):
        e, Jp, Jl, srow = ba._obs_components(cam, prob, G, R, t, X)
        return e.sum() + Jp.sum() + Jl.sum()

    @jax.jit
    def f_blocks(R, t, X):
        e, Jp, Jl, _ = ba._obs_components(cam, prob, G, R, t, X)
        w = w_active
        wJp = Jp * w
        wJl = Jl * w
        Hll = jnp.einsum("ridl,rjdl->ijl", wJl, Jl, precision=hi)
        bl = jnp.einsum("ridl,rdl->il", wJl, e, precision=hi)
        Y = jnp.einsum("ridl,rkdl->ikdl", wJp, Jl, precision=hi)
        Hpp = jnp.einsum("ridl,rjdl,dlp->pij", wJp, Jp, G, precision=hi)
        bp = jnp.einsum("ridl,rdl,dlp->pi", wJp, e, G, precision=hi)
        return Hll.sum() + bl.sum() + Y.sum() + Hpp.sum() + bp.sum()

    @jax.jit
    def f_schur(R, t, X):
        lam = jnp.float32(1e-4)
        e, Jp, Jl, _ = ba._obs_components(cam, prob, G, R, t, X)
        w = w_active
        wJp = Jp * w
        wJl = Jl * w
        Hll = jnp.einsum("ridl,rjdl->ijl", wJl, Jl, precision=hi)
        bl = jnp.einsum("ridl,rdl->il", wJl, e, precision=hi)
        Y = jnp.einsum("ridl,rkdl->ikdl", wJp, Jl, precision=hi)
        Hpp = jnp.einsum("ridl,rjdl,dlp->pij", wJp, Jp, G, precision=hi)
        diag_ll = jnp.clip(jnp.stack([Hll[0, 0], Hll[1, 1], Hll[2, 2]]),
                           1e-6, None)
        eye3L = jnp.eye(3, dtype=Hll.dtype)[:, :, None]
        Hll_d = Hll + lam * diag_ll[None, :, :] * eye3L
        Hll_d = jnp.where(prob.point_valid, Hll_d, eye3L)
        Hll_inv = ba._inv3x3(Hll_d.transpose(2, 0, 1)).transpose(1, 2, 0)
        YHinv = jnp.einsum("imdl,mkl->ikdl", Y, Hll_inv, precision=hi)
        A = jnp.einsum("dlp,ikdl->pikl", G, YHinv, precision=hi)
        B = jnp.einsum("dlp,ikdl->pikl", G, Y, precision=hi)
        S_off = jnp.einsum("pikl,qjkl->pqij", A, B, precision=hi)
        return S_off.sum() + bl.sum() + Hpp.sum()

    @jax.jit
    def f_solve_only(S_mat, b):
        return jnp.linalg.solve(S_mat, b)

    @jax.jit
    def f_full_1iter(R, t, X):
        r = ba.ba_solve(cam, prob._replace(R=R, t=t, X=X), iters=1)
        return r.chi2

    @jax.jit
    def f_full_5iter(R, t, X):
        r = ba.ba_solve(cam, prob._replace(R=R, t=t, X=X), iters=5)
        return r.chi2

    @jax.jit
    def f_chi2(R, t, X):
        return ba._eval_chi2_T(cam, prob, G, w_active, R, t, X).sum()

    R, t, X = prob.R, prob.t, prob.X
    S_mat = jnp.eye(P * 6) + 0.01 * jax.random.normal(
        jax.random.PRNGKey(1), (P * 6, P * 6))
    S_mat = S_mat @ S_mat.T
    b = jnp.ones(P * 6)

    for name, fn, args in [
        ("components (e, Jp, Jl)", f_components, (R, t, X)),
        ("+ hessian blocks", f_blocks, (R, t, X)),
        ("+ schur product", f_schur, (R, t, X)),
        ("chi2 eval alone", f_chi2, (R, t, X)),
        ("dense solve [144x144] alone", f_solve_only, (S_mat, b)),
        ("full 1-iter ba_solve", f_full_1iter, (R, t, X)),
        ("full 5-iter ba_solve", f_full_5iter, (R, t, X)),
    ]:
        dt = timeit(fn, *args)
        print(f"{name:36s} {dt*1e3:8.2f} ms", flush=True)


if __name__ == "__main__":
    main()
