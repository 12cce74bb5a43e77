"""IC-angle keypoint orientation via whole-image moment maps.

JAX rebuild of the reference's IC_Angle (reference:
ORBextractor.cc:77-104): the intensity centroid angle over a radius-15
circular patch whose row extents come from the umax table (ctor,
ORBextractor.cc:472-506). Instead of per-keypoint pixel loops, the patch
moments m10 = sum(x * I) and m01 = sum(y * I) are computed for EVERY pixel
at once as two 31x31 convolutions, then gathered at keypoint
locations. atan2(m01, m10) matches cv::fastAtan2 semantics (radians here).
"""
from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from .image import conv2d_same

HALF_PATCH = 15


def _umax_table() -> np.ndarray:
    """Circle row half-widths, replicating the reference's symmetric table."""
    umax = np.zeros(HALF_PATCH + 1, np.int32)
    vmax = int(np.floor(HALF_PATCH * np.sqrt(2.0) / 2 + 1))
    vmin = int(np.ceil(HALF_PATCH * np.sqrt(2.0) / 2))
    hp2 = HALF_PATCH * HALF_PATCH
    for v in range(vmax + 1):
        umax[v] = int(round(np.sqrt(hp2 - v * v)))
    # Ensure symmetry (reference: ORBextractor.cc:497-505)
    v0 = 0
    for v in range(HALF_PATCH, vmin - 1, -1):
        while umax[v0] == umax[v0 + 1]:
            v0 += 1
        umax[v] = v0
        v0 += 1
    return umax


UMAX = _umax_table()


def _moment_kernels() -> tuple[np.ndarray, np.ndarray]:
    """31x31 kernels K10[y, x] = x * in_circle, K01[y, x] = y * in_circle."""
    size = 2 * HALF_PATCH + 1
    k10 = np.zeros((size, size), np.float32)
    k01 = np.zeros((size, size), np.float32)
    for v in range(-HALF_PATCH, HALF_PATCH + 1):
        half = UMAX[abs(v)]
        for u in range(-half, half + 1):
            k10[v + HALF_PATCH, u + HALF_PATCH] = u
            k01[v + HALF_PATCH, u + HALF_PATCH] = v
    return k10, k01


_K10, _K01 = _moment_kernels()


def moment_kernel_matrix() -> jax.Array:
    """[P*P, 2] flat (m10, m01) weight matrix for patch-matmul IC angles:
    angles = arctan2(patch_flat @ K [:, 1], patch_flat @ K [:, 0])."""
    return jnp.stack([jnp.asarray(_K10).reshape(-1),
                      jnp.asarray(_K01).reshape(-1)], axis=1)


@jax.jit
def orientation_maps(img: jax.Array) -> tuple[jax.Array, jax.Array]:
    """Whole-image m10/m01 maps ([H, W] each)."""
    # conv2d_same performs correlation, so the kernels index patch offsets
    # directly (out[y,x] = sum_{v,u} img[y+v, x+u] * K[v, u]).
    k10 = jnp.asarray(_K10)
    k01 = jnp.asarray(_K01)
    return conv2d_same(img, k10), conv2d_same(img, k01)


def angles_at(img: jax.Array, yx: jax.Array) -> jax.Array:
    """Orientation angle (radians) for keypoints yx [N, 2] (row, col)."""
    m10, m01 = orientation_maps(img)
    g10 = m10[yx[:, 0], yx[:, 1]]
    g01 = m01[yx[:, 0], yx[:, 1]]
    return jnp.arctan2(g01, g10)


@jax.jit
def angles_at_patches(img: jax.Array, yx: jax.Array) -> jax.Array:
    """Orientation angles via per-keypoint 31x31 patch gathers + one
    [N, 961] x [961, 2] matmul.

    The whole-image moment maps (orientation_maps) are two 31x31
    single-channel convolutions over every pixel; gathering only the N
    keypoint patches does ~300x less work and turns the reduction into a
    matrix multiply.
    """
    pad = jnp.pad(img, HALF_PATCH)

    def patch(y, x):
        return jax.lax.dynamic_slice(
            pad, (y, x), (2 * HALF_PATCH + 1, 2 * HALF_PATCH + 1))

    patches = jax.vmap(patch)(yx[:, 0], yx[:, 1])  # [N, 31, 31]
    flat = patches.reshape(patches.shape[0], -1)
    kmat = jnp.stack([jnp.asarray(_K10).reshape(-1),
                      jnp.asarray(_K01).reshape(-1)], axis=1)  # [961, 2]
    m = jnp.matmul(flat, kmat, precision=jax.lax.Precision.HIGHEST)
    return jnp.arctan2(m[:, 1], m[:, 0])
