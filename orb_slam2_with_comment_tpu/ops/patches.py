"""Patch extraction and point sampling as one-hot matmuls.

Every per-keypoint sampling operation in the frontend is expressed as two
one-hot matrix multiplies instead of a gather (the engine was first built
for an accelerator without a hardware gather; whether a direct gather is
faster on a GPU is not measured yet):

    patch[n] = Ry[n] @ map @ Cx[n]^T

where ``Ry``/``Cx`` are one-hot row/column selector matrices built with
iota comparisons (pure elementwise work). The contraction over the image
height runs as ONE dense GEMM for all keypoints at once; the column
contraction is a small batched GEMM.

This replaces the per-keypoint work in the reference's ORBextractor
(reference: src/ORBextractor.cc:77-147 IC_Angle/computeOrbDescriptor read
pixels through pointer arithmetic per keypoint — the CPU-native
equivalent of these samplings).
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp


def _row_col_onehot(yx: jax.Array, h: int, w: int, radius: int,
                    dtype=jnp.float32):
    """One-hot row/col selectors for (2*radius+1)-wide windows.

    yx: [N, 2] int (row, col). Returns (Ry [N, P, H], Cx [N, P, W]) with
    P = 2*radius+1. Out-of-image rows/cols are clipped (callers keep
    keypoints inside the extraction margin)."""
    d = jnp.arange(-radius, radius + 1, dtype=jnp.int32)
    rows = jnp.clip(yx[:, 0:1] + d[None, :], 0, h - 1)  # [N, P]
    cols = jnp.clip(yx[:, 1:2] + d[None, :], 0, w - 1)
    ry = (rows[:, :, None] == jnp.arange(h, dtype=jnp.int32)).astype(dtype)
    cx = (cols[:, :, None] == jnp.arange(w, dtype=jnp.int32)).astype(dtype)
    return ry, cx


@partial(jax.jit, static_argnames=("radius",))
def extract_patches(maps: jax.Array, yx: jax.Array, radius: int) -> jax.Array:
    """Extract square windows around keypoints from stacked maps.

    maps: [C, H, W] float32 channel-stacked images (e.g. raw, blurred,
    score); yx: [N, 2] int32 (row, col). Returns [N, C, P, P] with
    P = 2*radius+1.
    """
    c, h, w = maps.shape
    n = yx.shape[0]
    p = 2 * radius + 1
    ry, cx = _row_col_onehot(yx, h, w, radius)
    # Row selection: ONE dense GEMM [N*P, H] @ [H, C*W]. Precision must be
    # HIGHEST: default precision may run f32 GEMMs in TF32 (GPU) or bf16
    # passes, which round the selected values (one-hot selection must be
    # exact — rounded intensities flip BRIEF comparison bits and break
    # matching).
    hi = jax.lax.Precision.HIGHEST
    rows = jnp.matmul(ry.reshape(n * p, h),
                      maps.transpose(1, 0, 2).reshape(h, c * w),
                      precision=hi)
    rows = rows.reshape(n, p, c, w)
    # Column selection: batched GEMM over keypoints.
    out = jnp.einsum("npcw,nqw->ncpq", rows, cx, precision=hi)
    return out


@jax.jit
def sample_maps(maps: jax.Array, yx: jax.Array) -> jax.Array:
    """Point-sample stacked maps at integer coords: [C, H, W], [N, 2] ->
    [N, C]. Same one-hot-matmul trick with a 1x1 window."""
    c, h, w = maps.shape
    ry = (jnp.clip(yx[:, 0:1], 0, h - 1)
          == jnp.arange(h, dtype=jnp.int32)[None, :]).astype(maps.dtype)
    cx = (jnp.clip(yx[:, 1:2], 0, w - 1)
          == jnp.arange(w, dtype=jnp.int32)[None, :]).astype(maps.dtype)
    hi = jax.lax.Precision.HIGHEST
    rows = jnp.matmul(ry, maps.transpose(1, 0, 2).reshape(h, c * w),
                      precision=hi)  # [N, C*W]
    return jnp.einsum("ncw,nw->nc", rows.reshape(-1, c, w), cx, precision=hi)


def take_rows(table: jax.Array, idx: jax.Array,
              dtype=jnp.float32) -> jax.Array:
    """Row gather ``table[idx]`` as a one-hot matmul.

    table: [M, D] numeric (values must be exactly representable in
    ``dtype`` — float32 is exact for int32 magnitudes < 2^24).
    idx: [N] int32 (caller clips to range). Returns [N, D] in table dtype.
    """
    m = table.shape[0]
    oh = (jnp.clip(idx[:, None], 0, m - 1)
          == jnp.arange(m, dtype=jnp.int32)[None, :]).astype(dtype)
    out = jnp.matmul(oh, table.astype(dtype),
                     precision=jax.lax.Precision.HIGHEST)
    return out.astype(table.dtype)
