"""ORB feature extraction pipeline: pyramid -> FAST -> orientation -> BRIEF.

JAX rebuild of ORBextractor::operator() (reference:
ORBextractor.cc:1043-1105): 8-level 1.2x pyramid, per-level FAST with the
20->7 per-cell fallback, spatial balancing, IC-angle orientation, 7x7
sigma=2 Gaussian blur, rotated-BRIEF descriptors, and coordinate rescaling
to level-0 pixels. Everything is fixed-shape: each level contributes a
static budget of keypoint slots (geometric series over levels, reference:
ORBextractor.cc:437-446), invalid slots are masked.

The heavy stages (score maps, moment convolutions, blur, descriptor
gathers) are whole-image batched ops from ``..ops`` — no per-keypoint
Python, single jitted program per image resolution.
"""
from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..ops import brief, fast, image, orientation
from ..ops import patches as patch_ops


class FrameFeatures(NamedTuple):
    """SoA feature bundle for one image (all arrays fixed-size N slots)."""

    xy: jax.Array  # [N, 2] float32, (x=col, y=row) in level-0 pixels (raw)
    response: jax.Array  # [N] float32 FAST score
    octave: jax.Array  # [N] int32 pyramid level
    angle: jax.Array  # [N] float32 radians
    desc: jax.Array  # [N, 8] uint32 packed 256-bit
    valid: jax.Array  # [N] bool

    @property
    def n(self) -> int:
        return self.xy.shape[0]


def level_budgets(n_features: int, n_levels: int = image.N_LEVELS,
                  scale_factor: float = image.SCALE_FACTOR) -> list[int]:
    """Geometric per-level keypoint budgets summing to n_features
    (reference: ORBextractor.cc:437-446)."""
    factor = 1.0 / scale_factor
    first = n_features * (1 - factor) / (1 - factor ** n_levels)
    out = []
    total = 0
    for i in range(n_levels - 1):
        k = int(round(first * factor ** i))
        out.append(k)
        total += k
    out.append(max(n_features - total, 0))
    return out


class OrbExtractor:
    """Configured extractor; __call__ is jit-compiled per image shape.

    scale-sigma bookkeeping mirrors the reference's mvScaleFactor /
    mvLevelSigma2 (sigma2 = 1.2^(2 level)).
    """

    def __init__(self, n_features: int = 1000, n_levels: int = image.N_LEVELS,
                 scale_factor: float = image.SCALE_FACTOR,
                 th_high: float = 20.0, th_low: float = 7.0,
                 cell: int = 32, per_cell: int = 8, margin: int = 16):
        self.n_features = n_features
        self.n_levels = n_levels
        self.scale_factor = scale_factor
        self.th_high = th_high
        self.th_low = th_low
        self.cell = cell
        self.per_cell = per_cell
        self.margin = margin
        self.budgets = level_budgets(n_features, n_levels, scale_factor)
        self.scales = image.level_scales(n_levels, scale_factor)
        self.sigma2 = [s * s for s in self.scales]
        self.inv_sigma2 = [1.0 / s for s in self.sigma2]
        self._jitted = jax.jit(self._extract)
        self._jitted_stereo = jax.jit(self._extract_stereo)

    def __call__(self, img: jax.Array) -> FrameFeatures:
        return self._jitted(img)

    def stereo(self, img_l: jax.Array, img_r: jax.Array, bf, fx):
        """Extract left+right features and associate along rectified rows.

        One jitted program for the whole stereo front end (the reference
        runs L/R extraction on two threads, Frame.cc:78-81; here both
        extractions live in one XLA program and the row-band association
        is a masked dense Hamming matrix, frontend/stereo.py).
        Returns (left FrameFeatures, StereoDepth).
        """
        return self._jitted_stereo(img_l, img_r, jnp.float32(bf), jnp.float32(fx))

    def _extract_stereo(self, img_l, img_r, bf, fx):
        from . import stereo as _stereo
        # ONE pyramid per view, shared between extraction and the SAD
        # subpixel refinement (building them twice doubled the pyramid
        # cost of the stereo front end)
        pyr_l = image.build_pyramid(
            img_l.astype(jnp.float32), self.n_levels, self.scale_factor)
        pyr_r = image.build_pyramid(
            img_r.astype(jnp.float32), self.n_levels, self.scale_factor)
        # L/R extraction stays SEQUENTIAL inside one program (the
        # reference's two threads, Frame.cc:78-81, fuse into one XLA
        # schedule); a vmap-over-pair variant was slower on the engine's
        # first accelerator and is not measured on a GPU
        feats_l = self._extract_from_pyramid(pyr_l)
        feats_r = self._extract_from_pyramid(pyr_r)
        sd = _stereo.match_stereo(
            feats_l, feats_r, pyr_l, pyr_r, self.budgets, bf, fx)
        return feats_l, sd

    def _extract(self, img: jax.Array) -> FrameFeatures:
        img = img.astype(jnp.float32)
        pyr = image.build_pyramid(img, self.n_levels, self.scale_factor)
        return self._extract_from_pyramid(pyr)

    def _extract_from_pyramid(self, pyr, batched: bool = False):
        """pyr: list of [h, w] level images (batched=False) or [B, h, w]
        stacks (batched=True -> returns FrameFeatures with [B, N] axes)."""
        kmat = orientation.moment_kernel_matrix()
        parts = []
        for lvl, (lvl_img, budget) in enumerate(zip(pyr, self.budgets)):
            if budget <= 0:
                continue
            body = partial(self._level_features, lvl=lvl, budget=budget,
                           kmat=kmat)
            parts.append(jax.vmap(body)(lvl_img) if batched
                         else body(lvl_img))
        axis = 1 if batched else 0
        xy = jnp.concatenate([p[0] for p in parts], axis=axis)
        resp = jnp.concatenate([p[1] for p in parts], axis=axis)
        octv = jnp.concatenate([p[2] for p in parts], axis=axis)
        ang = jnp.concatenate([p[3] for p in parts], axis=axis)
        desc = jnp.concatenate([p[4] for p in parts], axis=axis)
        valid = jnp.concatenate([p[5] for p in parts], axis=axis)
        return FrameFeatures(xy, resp, octv, ang, desc, valid)

    def _level_features(self, lvl_img, lvl: int, budget: int, kmat):
        h, w = lvl_img.shape
        score = fast.fast_score_map(lvl_img)
        # Border mask: keypoints must keep the orientation/descriptor
        # patch inside the image (reference EDGE_THRESHOLD=19, FAST
        # domain starts at 16; ORBextractor.cc:72-74,769).
        m = self.margin
        yy = jax.lax.broadcasted_iota(jnp.int32, (h, w), 0)
        xx = jax.lax.broadcasted_iota(jnp.int32, (h, w), 1)
        inb = (yy >= m) & (yy < h - m) & (xx >= m) & (xx < w - m)
        score = jnp.where(inb, score, 0.0)
        yx, resp, valid = fast.select_keypoints(
            score, budget, self.cell, self.per_cell, self.th_high, self.th_low)
        # ALL per-keypoint sampling (IC angle, subpixel parabola, BRIEF)
        # comes from one batched patch extraction expressed as one-hot
        # matmuls (ops.patches).
        # Integer-rounded blurred image: the reference samples BRIEF
        # from a uint8 blurred image (OpenCV GaussianBlur on CV_8U).
        blurred = jnp.round(image.gaussian_blur(lvl_img))
        # Three patch extractions sized to what each consumer reads —
        # blurred at the full BRIEF radius (rotated-pair sampling), raw at
        # 31x31 (IC angle), score at 3x3 (subpixel parabola). One 3-channel
        # call at the BRIEF radius moved ~1.9x these GEMM flops.
        pat_b = patch_ops.extract_patches(
            blurred[None], yx, brief.BRIEF_RADIUS)[:, 0]
        raw31 = patch_ops.extract_patches(
            lvl_img[None], yx, orientation.HALF_PATCH)[:, 0]
        # HIGHEST: at default precision a GPU runs this f32 GEMM in TF32,
        # which moves ~0.3% of angles by >1e-3 rad and flips ~2% of
        # descriptors against the f32 result (rotated BRIEF offsets round
        # to other pixels)
        mom = jnp.matmul(raw31.reshape(budget, -1), kmat,
                         precision=jax.lax.Precision.HIGHEST)
        ang = jnp.arctan2(mom[:, 1], mom[:, 0])
        # exact per-keypoint rotation (reference: computeOrbDescriptor
        # ORBextractor.cc:108-147). The 30-bin steered bank
        # (descriptors_from_patches) measurably loses 20-30% of
        # correct matches at mid-bin roll angles
        # (tests/test_brief_quantization.py).
        desc = brief.descriptors_from_patches_exact(
            pat_b.reshape(budget, -1), ang)
        # Subpixel 1D parabola per axis on the score patch center
        # (fast.subpixel_refine semantics, without the gathers).
        hp = 1
        sp = patch_ops.extract_patches(score[None], yx, 1)[:, 0]
        c = sp[:, hp, hp]
        up, dn = sp[:, hp - 1, hp], sp[:, hp + 1, hp]
        lf, rt = sp[:, hp, hp - 1], sp[:, hp, hp + 1]
        den_y = up - 2 * c + dn
        den_x = lf - 2 * c + rt
        sub_dy = jnp.clip(0.5 * (up - dn) / jnp.where(
            jnp.abs(den_y) < 1e-6, 1e-6, den_y), -0.5, 0.5)
        sub_dx = jnp.clip(0.5 * (lf - rt) / jnp.where(
            jnp.abs(den_x) < 1e-6, 1e-6, den_x), -0.5, 0.5)
        sub = jnp.stack([sub_dy, sub_dx], axis=-1)
        scale = self.scales[lvl]
        xy0 = jnp.stack(
            [(yx[:, 1].astype(jnp.float32) + sub[:, 1]) * scale,
             (yx[:, 0].astype(jnp.float32) + sub[:, 0]) * scale], axis=-1)
        octv = jnp.full(budget, lvl, jnp.int32)
        return (xy0, resp, octv, ang, desc, valid)
