"""SO(3)/SE(3) Lie-group operations, batched and jit-friendly.

Poses are stored as (R, t): rotation matrices ``[..., 3, 3]`` and translations
``[..., 3]`` — matrix form keeps compositions as matmuls and avoids quaternion
renormalization inside optimization loops. Updates use the se(3) exponential
map with *left* multiplication ``T <- exp(xi) @ T``, matching the convention of
the reference optimizer's vertex update (reference: g2o VertexSE3Expmap oplus,
Thirdparty/g2o/g2o/types/types_six_dof_expmap.h:59-100), so pose-Jacobian
structure carries over.

All functions broadcast over leading batch dimensions.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

_EPS = 1e-8


def hat(w: jax.Array) -> jax.Array:
    """so(3) hat operator: [..., 3] -> skew-symmetric [..., 3, 3]."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    z = jnp.zeros_like(wx)
    return jnp.stack(
        [
            jnp.stack([z, -wz, wy], axis=-1),
            jnp.stack([wz, z, -wx], axis=-1),
            jnp.stack([-wy, wx, z], axis=-1),
        ],
        axis=-2,
    )


def exp_so3(w: jax.Array) -> jax.Array:
    """Rodrigues: axis-angle [..., 3] -> rotation matrix [..., 3, 3].

    Taylor-guarded near theta=0 so it is safe under jit and autodiff.
    """
    theta2 = jnp.sum(w * w, axis=-1)
    theta = jnp.sqrt(theta2 + _EPS * _EPS)
    small = theta2 < 1e-8
    # sin(t)/t and (1-cos(t))/t^2 with series fallbacks.
    a = jnp.where(small, 1.0 - theta2 / 6.0, jnp.sin(theta) / theta)
    b = jnp.where(small, 0.5 - theta2 / 24.0, (1.0 - jnp.cos(theta)) / theta2.clip(1e-16))
    W = hat(w)
    W2 = W @ W
    eye = jnp.broadcast_to(jnp.eye(3, dtype=w.dtype), W.shape)
    return eye + a[..., None, None] * W + b[..., None, None] * W2


def log_so3(R: jax.Array) -> jax.Array:
    """Rotation matrix [..., 3, 3] -> axis-angle [..., 3].

    Numerically robust at theta ~ 0 AND theta ~ pi, and — critically for the
    optimizers, which differentiate through this via jacfwd — free of NaN
    gradients: theta comes from atan2(|vee|/2, (tr-1)/2) instead of arccos
    (whose derivative blows up at the identity), and every guarded division
    uses the double-where pattern so the untaken branch stays finite under
    autodiff.
    """
    vee = jnp.stack(
        [
            R[..., 2, 1] - R[..., 1, 2],
            R[..., 0, 2] - R[..., 2, 0],
            R[..., 1, 0] - R[..., 0, 1],
        ],
        axis=-1,
    )
    cos_t = jnp.clip((R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2] - 1.0) * 0.5, -1.0, 1.0)
    sin_t = 0.5 * jnp.sqrt(jnp.sum(vee * vee, axis=-1) + _EPS * _EPS)
    theta = jnp.arctan2(sin_t, cos_t)  # well-conditioned at 0 and pi
    # Generic branch: w = theta/(2 sin theta) * vee, series near theta=0.
    small = sin_t < 1e-5
    sin_safe = jnp.where(small, 1.0, sin_t)
    k = jnp.where(small, 0.5 + theta * theta / 12.0, theta / (2.0 * sin_safe))
    w_generic = k[..., None] * vee
    # Near pi: |vee| ~ 0 and the generic branch collapses. At theta=pi,
    # B = (R + I)/2 = a a^T exactly; take the pivot column of B and normalize
    # (full float32 precision, unlike sqrt(diag) sign-fixing), with the sign
    # chosen to agree with vee (vee = 2 sin(theta) a, sin > 0 below pi).
    B = (R + jnp.eye(3, dtype=R.dtype)) * 0.5
    diag = jnp.stack([B[..., 0, 0], B[..., 1, 1], B[..., 2, 2]], axis=-1)
    kidx = jnp.argmax(diag, axis=-1)
    col = jnp.take_along_axis(B, kidx[..., None, None].repeat(3, -2), axis=-1)[..., 0]
    col_norm = jnp.sqrt(jnp.sum(col * col, axis=-1, keepdims=True) + _EPS * _EPS)
    axis = col / col_norm
    axis_sign = jnp.where(jnp.sum(axis * vee, axis=-1) < 0, -1.0, 1.0)
    w_pi = axis * (axis_sign * theta)[..., None]
    near_pi = cos_t < -0.999999
    return jnp.where(near_pi[..., None], w_pi, w_generic)


def _left_jacobian(w: jax.Array) -> jax.Array:
    """SO(3) left Jacobian V such that exp_se3 translation = V @ rho."""
    theta2 = jnp.sum(w * w, axis=-1)
    theta = jnp.sqrt(theta2 + _EPS * _EPS)
    small = theta2 < 1e-8
    b = jnp.where(small, 0.5 - theta2 / 24.0, (1.0 - jnp.cos(theta)) / theta2.clip(1e-16))
    c = jnp.where(
        small, 1.0 / 6.0 - theta2 / 120.0, (theta - jnp.sin(theta)) / (theta2 * theta).clip(1e-16)
    )
    W = hat(w)
    W2 = W @ W
    eye = jnp.broadcast_to(jnp.eye(3, dtype=w.dtype), W.shape)
    return eye + b[..., None, None] * W + c[..., None, None] * W2


def exp_se3(xi: jax.Array) -> tuple[jax.Array, jax.Array]:
    """se(3) exp: xi = [rho(3), phi(3)] [..., 6] -> (R [...,3,3], t [...,3])."""
    rho, phi = xi[..., :3], xi[..., 3:]
    R = exp_so3(phi)
    V = _left_jacobian(phi)
    t = jnp.einsum("...ij,...j->...i", V, rho)
    return R, t


def log_se3(R: jax.Array, t: jax.Array) -> jax.Array:
    """Inverse of exp_se3: -> [..., 6] = [rho, phi]."""
    phi = log_so3(R)
    V = _left_jacobian(phi)
    rho = jnp.linalg.solve(V, t[..., None])[..., 0]
    return jnp.concatenate([rho, phi], axis=-1)


def compose(Ra, ta, Rb, tb):
    """(Ra,ta) * (Rb,tb): applies b first, then a."""
    R = Ra @ Rb
    t = jnp.einsum("...ij,...j->...i", Ra, tb) + ta
    return R, t


def inverse(R, t):
    Rt = jnp.swapaxes(R, -1, -2)
    return Rt, -jnp.einsum("...ij,...j->...i", Rt, t)


def transform(R, t, X):
    """Apply pose to points. R [...,3,3], t [...,3], X [...,3] -> [...,3]."""
    return jnp.einsum("...ij,...j->...i", R, X) + t


def retract(R, t, xi):
    """Left-multiplicative update: exp(xi) * (R, t) — the optimizer's oplus."""
    dR, dt = exp_se3(xi)
    return compose(dR, dt, R, t)


def orthonormalize(R):
    """One Newton step of the polar projection onto SO(3):
    R <- R (3I - R^T R) / 2, squaring the orthonormality error.

    Per-frame tracking composes velocity * inverse * pose chains whose
    retractions PRESERVE any non-orthonormality while the composition
    amplifies it ~2.4x per frame (exponential blow-up measured over ~15
    frames in float32). One Newton step per frame drives the error to
    roundoff. Must run at HIGHEST precision: TF32 or bf16 matmuls would
    re-inject ~1e-3 error each application."""
    hi = jax.lax.Precision.HIGHEST
    rtr = jnp.matmul(jnp.swapaxes(R, -1, -2), R, precision=hi)
    eye = jnp.eye(3, dtype=R.dtype)
    return jnp.matmul(R, 1.5 * eye - 0.5 * rtr, precision=hi)


def quat_to_matrix(q: jax.Array) -> jax.Array:
    """Unit quaternion [..., 4] (w, x, y, z) -> rotation matrix [..., 3, 3]."""
    q = q / jnp.linalg.norm(q, axis=-1, keepdims=True).clip(1e-12)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return jnp.stack(
        [
            jnp.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], -1),
            jnp.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], -1),
            jnp.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], -1),
        ],
        axis=-2,
    )


def matrix_to_quat(R: jax.Array) -> jax.Array:
    """Rotation matrix [..., 3, 3] -> unit quaternion [..., 4] (w, x, y, z).

    Branch-free Shepperd-style selection of the numerically best component,
    safe under vmap/jit.
    """
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22
    # Four candidate constructions; pick by the largest pivot.
    qw = jnp.stack(
        [1.0 + tr, 1.0 + m00 - m11 - m22, 1.0 - m00 + m11 - m22, 1.0 - m00 - m11 + m22], axis=-1
    )
    qw = jnp.sqrt(jnp.clip(qw, 1e-12, None)) * 0.5
    w0, x1, y2, z3 = qw[..., 0], qw[..., 1], qw[..., 2], qw[..., 3]
    cands = jnp.stack(
        [
            jnp.stack([w0, (m21 - m12) / (4 * w0), (m02 - m20) / (4 * w0), (m10 - m01) / (4 * w0)], -1),
            jnp.stack([(m21 - m12) / (4 * x1), x1, (m01 + m10) / (4 * x1), (m02 + m20) / (4 * x1)], -1),
            jnp.stack([(m02 - m20) / (4 * y2), (m01 + m10) / (4 * y2), y2, (m12 + m21) / (4 * y2)], -1),
            jnp.stack([(m10 - m01) / (4 * z3), (m02 + m20) / (4 * z3), (m12 + m21) / (4 * z3), z3], -1),
        ],
        axis=-2,
    )  # [..., 4, 4]
    idx = jnp.argmax(jnp.stack([tr, m00, m11, m22], axis=-1), axis=-1)
    q = jnp.take_along_axis(cands, idx[..., None, None].repeat(4, -1), axis=-2)[..., 0, :]
    q = q / jnp.linalg.norm(q, axis=-1, keepdims=True).clip(1e-12)
    # Canonical sign: w >= 0.
    return q * jnp.where(q[..., :1] < 0, -1.0, 1.0)
