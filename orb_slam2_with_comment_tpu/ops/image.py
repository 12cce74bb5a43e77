"""Image-level ops: pyramid construction, Gaussian blur, 2D convolution.

JAX counterparts of the reference's OpenCV usage:
  - ORBextractor::ComputePyramid (reference: ORBextractor.cc:1107-1132),
    scale factor 1.2, 8 levels, bilinear resize.
  - GaussianBlur(7x7, sigma=2) before BRIEF (reference: ORBextractor.cc:1086).
Convolutions go through lax.conv_general_dilated; images are [H, W]
float32 in [0, 255].
"""
from __future__ import annotations

import math
from functools import partial

import jax
import jax.numpy as jnp

SCALE_FACTOR = 1.2
N_LEVELS = 8


def level_scales(n_levels: int = N_LEVELS, scale_factor: float = SCALE_FACTOR):
    """Per-level scale (1.2^l) and inverse, as Python floats (static)."""
    return [scale_factor ** i for i in range(n_levels)]


def level_sizes(h: int, w: int, n_levels: int = N_LEVELS, scale_factor: float = SCALE_FACTOR):
    """Static (h, w) per level, matching cvRound semantics of resize."""
    out = []
    for s in level_scales(n_levels, scale_factor):
        out.append((int(round(h / s)), int(round(w / s))))
    return out


def build_pyramid(img: jax.Array, n_levels: int = N_LEVELS,
                  scale_factor: float = SCALE_FACTOR) -> list[jax.Array]:
    """[H, W] float32 -> list of n_levels images, level l scaled by 1.2^-l.

    Like the reference, each level is resized from the previous one (not from
    level 0) to match the incremental blur accumulation of cv::resize chains.
    """
    h, w = img.shape
    sizes = level_sizes(h, w, n_levels, scale_factor)
    pyr = [img]
    for l in range(1, n_levels):
        prev = pyr[-1]
        pyr.append(jax.image.resize(prev, sizes[l], method="bilinear"))
    return pyr


def gaussian_kernel1d(ksize: int = 7, sigma: float = 2.0) -> jax.Array:
    r = ksize // 2
    x = jnp.arange(-r, r + 1, dtype=jnp.float32)
    k = jnp.exp(-(x * x) / (2.0 * sigma * sigma))
    return k / jnp.sum(k)


@partial(jax.jit, static_argnums=(1,))
def gaussian_blur(img: jax.Array, ksize: int = 7, sigma: float = 2.0) -> jax.Array:
    """Separable Gaussian blur with replicate padding (matches cv2 BORDER_REFLECT_101
    closely enough for descriptor sampling)."""
    # Unrolled shift-and-add separable filter: 2*ksize shifted
    # multiply-adds that XLA fuses into elementwise loops, in place of a
    # single-channel 2D convolution.
    k = gaussian_kernel1d(ksize, sigma)
    r = ksize // 2
    h, w = img.shape
    x = jnp.pad(img, ((r, r), (0, 0)), mode="edge")
    x = sum(k[i] * jax.lax.dynamic_slice_in_dim(x, i, h, 0)
            for i in range(ksize))
    x = jnp.pad(x, ((0, 0), (r, r)), mode="edge")
    x = sum(k[i] * jax.lax.dynamic_slice_in_dim(x, i, w, 1)
            for i in range(ksize))
    return x


def conv2d_same(img: jax.Array, kernel: jax.Array) -> jax.Array:
    """'SAME' 2D correlation of [H, W] with [kh, kw] (zero padding)."""
    kh, kw = kernel.shape
    out = jax.lax.conv_general_dilated(
        img[None, None], kernel[None, None], (1, 1),
        ((kh // 2, kh // 2), (kw // 2, kw // 2)))
    return out[0, 0]


def shifted(img: jax.Array, dy: int, dx: int, pad: int) -> jax.Array:
    """Image shifted so out[y, x] = img[y + dy, x + dx] (zero border)."""
    p = jnp.pad(img, ((pad, pad), (pad, pad)))
    h, w = img.shape
    return jax.lax.dynamic_slice(p, (pad + dy, pad + dx), (h, w))
