"""Monocular two-view initialization: parallel H/F RANSAC + reconstruction.

JAX rebuild of the reference's Initializer (reference:
Initializer.cc:53-948): 200 RANSAC sets scored for BOTH a homography (DLT)
and a fundamental matrix (8-point) with symmetric-transfer chi2, model
choice RH = SH/(SH+SF) > 0.40, then reconstruction — F via the essential
matrix's 4 (R,t) hypotheses, H via the Faugeras 8-motion decomposition —
with the cheirality/parallax/reprojection CheckRT vote (:816-925).

The reference runs H and F estimation in two threads with sequential
hypothesis loops; here every hypothesis of both models is solved and
scored in one vmapped batch (SURVEY §2.5 P2, §7 stance 5).
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..geometry import triangulate

TH_H = 5.991
TH_F = 3.841
SCORE_CAP = 5.991


def _normalize(pts: jax.Array, valid: jax.Array):
    """Mean/abs-dev normalization (reference: Initializer::Normalize)."""
    w = valid.astype(pts.dtype)
    n = jnp.clip(jnp.sum(w), 1.0, None)
    mean = jnp.sum(pts * w[:, None], axis=0) / n
    d = jnp.abs(pts - mean) * w[:, None]
    dev = jnp.sum(d, axis=0) / n
    s = 1.0 / jnp.clip(dev, 1e-9, None)
    T = jnp.asarray([[s[0], 0, -mean[0] * s[0]],
                     [0, s[1], -mean[1] * s[1]],
                     [0, 0, 1.0]], pts.dtype)
    return (pts - mean) * s, T


def _solve_h(p1: jax.Array, p2: jax.Array) -> jax.Array:
    """DLT homography from 8 correspondences ([8,2] each) -> [3,3]."""
    x1, y1 = p1[:, 0], p1[:, 1]
    x2, y2 = p2[:, 0], p2[:, 1]
    z = jnp.zeros_like(x1)
    o = jnp.ones_like(x1)
    r1 = jnp.stack([z, z, z, -x1, -y1, -o, y2 * x1, y2 * y1, y2], -1)
    r2 = jnp.stack([x1, y1, o, z, z, z, -x2 * x1, -x2 * y1, -x2], -1)
    A = jnp.concatenate([r1, r2], axis=0)  # [16, 9]
    _, V = jnp.linalg.eigh(A.T @ A)
    return V[:, 0].reshape(3, 3)


def _solve_f(p1: jax.Array, p2: jax.Array) -> jax.Array:
    """8-point fundamental matrix ([8,2] each) -> rank-2 [3,3]."""
    x1, y1 = p1[:, 0], p1[:, 1]
    x2, y2 = p2[:, 0], p2[:, 1]
    o = jnp.ones_like(x1)
    A = jnp.stack([x2 * x1, x2 * y1, x2, y2 * x1, y2 * y1, y2, x1, y1, o], -1)
    _, V = jnp.linalg.eigh(A.T @ A)
    F = V[:, 0].reshape(3, 3)
    U, S, Vt = jnp.linalg.svd(F)
    S = S.at[2].set(0.0)
    return U @ jnp.diag(S) @ Vt


def _score_h(H, p1, p2, valid, sigma2=1.0):
    """Symmetric transfer score (reference: CheckHomography, :323-406)."""
    Hi = jnp.linalg.inv(H)

    def transfer(M, a):
        ah = jnp.concatenate([a, jnp.ones_like(a[:, :1])], -1)
        b = ah @ M.T
        return b[:, :2] / jnp.clip(b[:, 2:3], 1e-9, None)

    e12 = jnp.sum((transfer(H, p1) - p2) ** 2, -1) / sigma2
    e21 = jnp.sum((transfer(Hi, p2) - p1) ** 2, -1) / sigma2
    ok = (e12 < TH_H) & (e21 < TH_H) & valid
    score = jnp.sum(jnp.where(ok, (SCORE_CAP - e12) + (SCORE_CAP - e21), 0.0))
    return score, ok


def _score_f(F, p1, p2, valid, sigma2=1.0):
    """Epipolar-distance score (reference: CheckFundamental, :408-486)."""
    p1h = jnp.concatenate([p1, jnp.ones_like(p1[:, :1])], -1)
    p2h = jnp.concatenate([p2, jnp.ones_like(p2[:, :1])], -1)
    l2 = p1h @ F.T  # lines in image 2
    l1 = p2h @ F  # lines in image 1
    d2 = (jnp.sum(l2 * p2h, -1) ** 2) / jnp.clip(l2[:, 0] ** 2 + l2[:, 1] ** 2, 1e-12, None)
    d1 = (jnp.sum(l1 * p1h, -1) ** 2) / jnp.clip(l1[:, 0] ** 2 + l1[:, 1] ** 2, 1e-12, None)
    c2 = d2 / sigma2
    c1 = d1 / sigma2
    ok = (c1 < TH_F) & (c2 < TH_F) & valid
    score = jnp.sum(jnp.where(c2 < TH_F, SCORE_CAP - c2, 0.0) * valid
                    + jnp.where(c1 < TH_F, SCORE_CAP - c1, 0.0) * valid)
    return score, ok


def _check_rt(R, t, K, p1, p2, valid, sigma2=1.0):
    """Cheirality + parallax + reprojection vote (reference: CheckRT,
    :816-925). Returns (n_good, parallax_cos50, X [N,3], good_mask)."""
    fx, fy, cx, cy = K
    Km = jnp.asarray([[fx, 0, cx], [0, fy, cy], [0, 0, 1.0]])
    P1 = Km @ jnp.concatenate([jnp.eye(3), jnp.zeros((3, 1))], 1)
    P2 = Km @ jnp.concatenate([R, t[:, None]], 1)
    N = p1.shape[0]
    X = triangulate.triangulate_dlt(
        jnp.broadcast_to(P1, (N, 3, 4)), jnp.broadcast_to(P2, (N, 3, 4)), p1, p2)
    C1 = jnp.zeros(3)
    C2 = -R.T @ t
    cos_par = triangulate.rays_parallax_cos(C1[None], C2[None], X)
    z1 = X[:, 2]
    Xc2 = X @ R.T + t
    z2 = Xc2[:, 2]
    finite = jnp.all(jnp.isfinite(X), axis=-1)
    # cheirality enforced only at sufficient parallax (reference :875-919)
    chei = ((z1 > 0) & (z2 > 0)) | (cos_par >= 0.99998)
    u1 = fx * X[:, 0] / jnp.where(z1 == 0, 1e-9, z1) + cx
    v1 = fy * X[:, 1] / jnp.where(z1 == 0, 1e-9, z1) + cy
    u2 = fx * Xc2[:, 0] / jnp.where(z2 == 0, 1e-9, z2) + cx
    v2 = fy * Xc2[:, 1] / jnp.where(z2 == 0, 1e-9, z2) + cy
    e1 = (u1 - p1[:, 0]) ** 2 + (v1 - p1[:, 1]) ** 2
    e2 = (u2 - p2[:, 0]) ** 2 + (v2 - p2[:, 1]) ** 2
    reproj_ok = (e1 < 4.0 * sigma2) & (e2 < 4.0 * sigma2)
    good = valid & finite & chei & reproj_ok & (cos_par < 0.99998)
    n_good = jnp.sum(good.astype(jnp.int32))
    # parallax at the 50th-smallest cos among good points (reference :919)
    cos_sorted = jnp.sort(jnp.where(good, cos_par, 1.0))
    k50 = jnp.minimum(49, jnp.clip(n_good - 1, 0, None))
    par_cos = cos_sorted[k50]
    return n_good, par_cos, X, good


class InitResult(NamedTuple):
    success: jax.Array  # bool
    R: jax.Array  # [3,3] pose of frame 2 (world = frame 1)
    t: jax.Array  # [3]
    X: jax.Array  # [N, 3] triangulated points
    good: jax.Array  # [N] bool triangulated-point mask
    used_h: jax.Array  # bool


def initialize(
    key: jax.Array,
    K,
    p1: jax.Array,  # [N, 2] matched keypoints in frame 1
    p2: jax.Array,  # [N, 2] in frame 2
    valid: jax.Array,
    iterations: int = 200,
    sigma: float = 1.0,
) -> InitResult:
    """Full two-view bootstrap. All RANSAC hypotheses for both models are
    batch-solved; reconstruction hypotheses (4 from E, 8 from H) are
    batch-voted with CheckRT."""
    sigma2 = sigma * sigma
    N = p1.shape[0]
    n1, T1 = _normalize(p1, valid)
    n2, T2 = _normalize(p2, valid)
    nv = jnp.sum(valid.astype(jnp.int32))
    probs = valid.astype(jnp.float32) / jnp.clip(nv, 1, None)
    idx = jax.random.categorical(
        key, jnp.log(jnp.clip(probs, 1e-12, None))[None, :]
        .repeat(iterations * 8, 0)).reshape(iterations, 8)

    Hs = jax.vmap(lambda i: _solve_h(n1[i], n2[i]))(idx)
    Fs = jax.vmap(lambda i: _solve_f(n1[i], n2[i]))(idx)
    T2i = jnp.linalg.inv(T2)
    H_img = jax.vmap(lambda H: T2i @ H @ T1)(Hs)
    F_img = jax.vmap(lambda F: T2.T @ F @ T1)(Fs)
    h_scores, h_inl = jax.vmap(lambda H: _score_h(H, p1, p2, valid, sigma2))(H_img)
    f_scores, f_inl = jax.vmap(lambda F: _score_f(F, p1, p2, valid, sigma2))(F_img)
    bh = jnp.argmax(h_scores)
    bf = jnp.argmax(f_scores)
    SH = h_scores[bh]
    SF = f_scores[bf]
    H = H_img[bh]
    F = F_img[bf]
    use_h = SH / jnp.clip(SH + SF, 1e-9, None) > 0.40

    fx, fy, cx, cy = K
    Km = jnp.asarray([[fx, 0, cx], [0, fy, cy], [0, 0, 1.0]])
    Km_inv = jnp.linalg.inv(Km)

    # --- F path: E = K^T F K -> 4 hypotheses ---
    E = Km.T @ F @ Km
    U, S, Vt = jnp.linalg.svd(E)
    # enforce proper rotations
    W = jnp.asarray([[0.0, -1, 0], [1, 0, 0], [0, 0, 1.0]])
    R1 = U @ W @ Vt
    R2 = U @ W.T @ Vt
    R1 = R1 * jnp.sign(jnp.linalg.det(R1))
    R2 = R2 * jnp.sign(jnp.linalg.det(R2))
    tv = U[:, 2]
    tv = tv / jnp.clip(jnp.linalg.norm(tv), 1e-12, None)
    f_Rs = jnp.stack([R1, R1, R2, R2])
    f_ts = jnp.stack([tv, -tv, tv, -tv])

    # --- H path: Faugeras SVD decomposition -> 8 hypotheses ---
    A = Km_inv @ H @ Km
    Ua, Da, Vat = jnp.linalg.svd(A)
    d1, d2, d3 = Da[0], Da[1], Da[2]
    s_det = jnp.linalg.det(Ua) * jnp.linalg.det(Vat)
    aux1 = jnp.sqrt(jnp.clip((d1 * d1 - d2 * d2) / jnp.clip(d1 * d1 - d3 * d3, 1e-12, None), 0, None))
    aux3 = jnp.sqrt(jnp.clip((d2 * d2 - d3 * d3) / jnp.clip(d1 * d1 - d3 * d3, 1e-12, None), 0, None))
    x1s = jnp.asarray([1.0, 1.0, -1.0, -1.0]) * aux1
    x3s = jnp.asarray([1.0, -1.0, 1.0, -1.0]) * aux3
    aux_st = jnp.sqrt(jnp.clip((d1 * d1 - d2 * d2) * (d2 * d2 - d3 * d3), 0, None)) / jnp.clip((d1 + d3) * d2, 1e-12, None)
    ct = (d2 * d2 + d1 * d3) / jnp.clip((d1 + d3) * d2, 1e-12, None)
    sts = jnp.asarray([1.0, -1.0, -1.0, 1.0]) * aux_st

    def h_case(x1, x3, st, sign_dp):
        ctheta = jnp.where(sign_dp > 0, ct,
                           (d1 * d3 - d2 * d2) / jnp.clip((d1 - d3) * d2, 1e-12, None))
        Rp = jnp.where(
            sign_dp > 0,
            jnp.asarray([[ctheta, 0, -st], [0, 1, 0], [st, 0, ctheta]]),
            jnp.asarray([[ctheta, 0, st], [0, -1, 0], [st, 0, -ctheta]]),
        )
        tp = jnp.where(
            sign_dp > 0,
            (d1 - d3) * jnp.asarray([x1, 0.0, -x3]),
            (d1 + d3) * jnp.asarray([x1, 0.0, x3]),
        )
        R = s_det * Ua @ Rp @ Vat
        t = Ua @ tp
        t = t / jnp.clip(jnp.linalg.norm(t), 1e-12, None)
        return R * jnp.sign(jnp.linalg.det(R)), t

    aux_sp = jnp.sqrt(jnp.clip((d1 * d1 - d2 * d2) * (d2 * d2 - d3 * d3), 0, None)) / jnp.clip((d1 - d3) * d2, 1e-12, None)
    sps = jnp.asarray([1.0, -1.0, -1.0, 1.0]) * aux_sp
    h_R_pos, h_t_pos = jax.vmap(lambda a, b, c: h_case(a, b, c, 1.0))(x1s, x3s, sts)
    h_R_neg, h_t_neg = jax.vmap(lambda a, b, c: h_case(a, b, c, -1.0))(x1s, x3s, sps)
    h_Rs = jnp.concatenate([h_R_pos, h_R_neg])
    h_ts = jnp.concatenate([h_t_pos, h_t_neg])

    # Pad F hypotheses to 8 so both paths share one batched CheckRT.
    Rs = jnp.where(use_h, h_Rs, jnp.concatenate([f_Rs, f_Rs]))
    ts = jnp.where(use_h, h_ts, jnp.concatenate([f_ts, f_ts]))
    model_inl = jnp.where(use_h, h_inl[bh], f_inl[bf])
    n_good, par_cos, Xs, goods = jax.vmap(
        lambda R, t: _check_rt(R, t, K, p1, p2, model_inl, sigma2))(Rs, ts)
    # F path counted each hypothesis twice; halve duplicates' influence by
    # masking the second copy
    dup_mask = jnp.where(use_h, jnp.ones(8, bool),
                         jnp.asarray([True] * 4 + [False] * 4))
    n_good = jnp.where(dup_mask, n_good, -1)
    best = jnp.argmax(n_good)
    n_best = n_good[best]
    n_second = jnp.sort(n_good)[-2]
    n_inl = jnp.sum(model_inl.astype(jnp.int32))
    # acceptance (reference :134-136, 522-535): clear winner, enough points,
    # sufficient parallax (cos < cos(1 deg))
    success = (
        (n_best >= jnp.maximum(50, (0.9 * n_inl).astype(jnp.int32)))
        & (n_second < 0.75 * n_best)
        & (par_cos[best] < 0.9998477)  # cos(1.0 deg)
    )
    return InitResult(success, Rs[best], ts[best], Xs[best],
                      goods[best] & success, use_h)
