"""Rotated-BRIEF descriptor sampling, batched over keypoints.

JAX rebuild of the reference's computeOrbDescriptor (reference:
ORBextractor.cc:108-147): 256 intensity comparisons on the 7x7-Gaussian-
blurred image, sampling offsets rotated by the keypoint's IC angle with
rounded (nearest-pixel) coordinates, exactly the reference's
  row = round(px * sin + py * cos), col = round(px * cos - py * sin).
All 512 samples x N keypoints collapse into one flat gather. Descriptors
are packed 256 bits -> uint32[8]; bit k of word w is comparison 32*w + k,
set when I(p_a) < I(p_b).

The sampling pattern is the standard OpenCV ORB learned pattern, shipped as
data (frontend/data/brief_pattern.npy; reference: ORBextractor.cc:150-408).
"""
from __future__ import annotations

import os

import numpy as np
import jax
import jax.numpy as jnp

_PATTERN_PATH = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "frontend", "data", "brief_pattern.npy",
)
# [256, 4] int8: (ax, ay, bx, by) per comparison
PATTERN = np.load(_PATTERN_PATH).astype(np.float32)
# host numpy views: auto-embedded as HLO constants when used in traced
# arithmetic
_PAT_AX = PATTERN[:, 0]
_PAT_AY = PATTERN[:, 1]
_PAT_BX = PATTERN[:, 2]
_PAT_BY = PATTERN[:, 3]


N_ANGLE_BINS = 30  # ORB paper: steered BRIEF at 2*pi/30 (12 deg) increments
# Pattern points reach radius ~18.4, so rotated+rounded offsets need +-19 —
# the origin of the reference's EDGE_THRESHOLD=19 (ORBextractor.cc:72-74).
BRIEF_RADIUS = 19
_PATCH = 2 * BRIEF_RADIUS + 1
_table_cache: dict[int, np.ndarray] = {}


def steered_diff_table(n_bins: int = N_ANGLE_BINS) -> np.ndarray:
    """Per-angle-bin sampling-difference matrices D [B, 256, P*P] float32.

    For bin b with angle theta_b, row s has +1 at the rotated index of
    pattern point a_s and -1 at b_s, so that
      bit[s] = (I(p_a) < I(p_b))  ==  (patch . D[b, s] < 0).
    This is the ORB paper's precomputed steered-BRIEF pattern bank
    (Rublee et al. 2011 sec 4.2, 12-degree increments; the reference
    rotates per-keypoint at float angle instead, ORBextractor.cc:108-147 —
    the bank turns 512 gathers/keypoint into one GEMM).
    """
    tab = _table_cache.get(n_bins)
    if tab is not None:
        return tab
    d = np.zeros((n_bins, 256, _PATCH * _PATCH), np.float32)
    ax, ay = PATTERN[:, 0], PATTERN[:, 1]
    bx, by = PATTERN[:, 2], PATTERN[:, 3]
    for b in range(n_bins):
        th = 2.0 * np.pi * b / n_bins
        ca, sa = np.cos(th), np.sin(th)
        for px, py, sign in ((ax, ay, 1.0), (bx, by, -1.0)):
            r = np.round(px * sa + py * ca).astype(np.int64) + BRIEF_RADIUS
            c = np.round(px * ca - py * sa).astype(np.int64) + BRIEF_RADIUS
            assert r.min() >= 0 and r.max() < _PATCH, "pattern escapes patch"
            assert c.min() >= 0 and c.max() < _PATCH
            np.add.at(d[b], (np.arange(256), r * _PATCH + c), sign)
    _table_cache[n_bins] = d
    return d


def angle_bins(angle: jax.Array, n_bins: int = N_ANGLE_BINS) -> jax.Array:
    """Quantize radian angles to the nearest steered-pattern bin."""
    b = jnp.round(angle * (n_bins / (2.0 * jnp.pi))).astype(jnp.int32)
    return jnp.mod(b, n_bins)


def descriptors_from_patches(patches: jax.Array, angle: jax.Array,
                             n_bins: int = N_ANGLE_BINS) -> jax.Array:
    """ORB descriptors from pre-extracted blurred patches — one GEMM.

    patches: [N, P*P] float32 blurred 39x39 windows (P = 2*BRIEF_RADIUS+1,
    ops.patches extract_patches); angle: [N] IC angle in radians. Returns
    [N, 8] uint32. All comparisons for all angle bins run as ONE GEMM
    [N, P*P] @ [P*P, B*256]; the keypoint's bin row is then selected with
    a one-hot contraction (no gathers anywhere).
    """
    dtab = jnp.asarray(steered_diff_table(n_bins))          # [B, 256, P*P]
    n = patches.shape[0]
    proj = patches @ dtab.transpose(2, 0, 1).reshape(_PATCH * _PATCH, -1)
    proj = proj.reshape(n, n_bins, 256)
    onehot = (angle_bins(angle, n_bins)[:, None]
              == jnp.arange(n_bins, dtype=jnp.int32)[None, :])
    sel = jnp.einsum("nbs,nb->ns", proj, onehot.astype(proj.dtype))
    bits = (sel < 0).astype(jnp.uint32)                     # [N, 256]
    words = bits.reshape(-1, 8, 32)
    shifts = jnp.arange(32, dtype=jnp.uint32)
    return jnp.sum(words << shifts[None, None, :], axis=-1, dtype=jnp.uint32)


def descriptors_from_patches_exact(patches: jax.Array,
                                   angle: jax.Array) -> jax.Array:
    """EXACT per-keypoint-rotation ORB descriptors from extracted patches.

    Reference semantics (ORBextractor.cc:108-147): offsets rotated by the
    keypoint's float angle with nearest-pixel rounding —
      row = round(px sin + py cos), col = round(px cos - py sin).
    The 30-bin steered bank (descriptors_from_patches) quantizes the
    angle to 12-degree steps, which measurably costs 20-30% of correct
    matches at mid-bin roll angles (tests/test_brief_quantization.py);
    this variant samples each keypoint's OWN [P,P] patch at its exact
    rotated offsets with one batched take_along_axis — no image-wide
    gathers, no quantization.

    patches: [N, P*P] float32 blurred windows (P = 2*BRIEF_RADIUS+1);
    angle: [N] radians. Returns [N, 8] uint32.
    """
    n = patches.shape[0]
    ca = jnp.cos(angle)[:, None]
    sa = jnp.sin(angle)[:, None]
    ax, ay = jnp.asarray(_PAT_AX), jnp.asarray(_PAT_AY)
    bx, by = jnp.asarray(_PAT_BX), jnp.asarray(_PAT_BY)

    def rot_idx(px, py):
        r = jnp.round(px[None, :] * sa + py[None, :] * ca).astype(jnp.int32)
        c = jnp.round(px[None, :] * ca - py[None, :] * sa).astype(jnp.int32)
        r = jnp.clip(r + BRIEF_RADIUS, 0, _PATCH - 1)
        c = jnp.clip(c + BRIEF_RADIUS, 0, _PATCH - 1)
        return r * _PATCH + c  # [N, 256]

    idx = jnp.concatenate([rot_idx(ax, ay), rot_idx(bx, by)], axis=1)
    vals = jnp.take_along_axis(patches, idx, axis=1)  # [N, 512]
    va, vb = vals[:, :256], vals[:, 256:]
    bits = (va < vb).astype(jnp.uint32)
    words = bits.reshape(n, 8, 32)
    shifts = jnp.arange(32, dtype=jnp.uint32)
    return jnp.sum(words << shifts[None, None, :], axis=-1,
                   dtype=jnp.uint32)


@jax.jit
def descriptors(blurred: jax.Array, yx: jax.Array, angle: jax.Array) -> jax.Array:
    """Compute ORB descriptors.

    Args:
      blurred: [H, W] Gaussian-blurred level image.
      yx: [N, 2] int keypoint coords (row, col) in level pixels.
      angle: [N] orientation in radians.
    Returns: [N, 8] uint32 packed descriptors.
    """
    h, w = blurred.shape
    ca = jnp.cos(angle)[:, None]  # [N, 1]
    sa = jnp.sin(angle)[:, None]

    def rot_rc(px, py):
        # reference: row offset = round(x sin + y cos), col = round(x cos - y sin)
        r = jnp.round(px[None, :] * sa + py[None, :] * ca)
        c = jnp.round(px[None, :] * ca - py[None, :] * sa)
        return r.astype(jnp.int32), c.astype(jnp.int32)

    ra, ca_ = rot_rc(_PAT_AX, _PAT_AY)  # [N, 256]
    rb, cb = rot_rc(_PAT_BX, _PAT_BY)
    y0 = yx[:, 0:1]
    x0 = yx[:, 1:2]
    ya = jnp.clip(y0 + ra, 0, h - 1)
    xa = jnp.clip(x0 + ca_, 0, w - 1)
    yb = jnp.clip(y0 + rb, 0, h - 1)
    xb = jnp.clip(x0 + cb, 0, w - 1)
    flat = blurred.reshape(-1)
    va = flat[(ya * w + xa).reshape(-1)].reshape(ya.shape)
    vb = flat[(yb * w + xb).reshape(-1)].reshape(yb.shape)
    bits = (va < vb).astype(jnp.uint32)  # [N, 256]
    words = bits.reshape(-1, 8, 32)
    shifts = jnp.arange(32, dtype=jnp.uint32)
    return jnp.sum(words << shifts[None, None, :], axis=-1, dtype=jnp.uint32)
