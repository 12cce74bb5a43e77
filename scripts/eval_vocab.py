"""Vocabulary recall comparison: packaged 10k tree vs the 88.5k tree
(VERDICT r3 missing #3 / next #5).

Protocol (held-out worlds, never seen by either training run):
  - positives: two views of the SAME place — same pose re-rendered with
    photometric jitter (gamma/gain/noise) plus a small pose offset, the
    revisit situation loop closure must recognize;
  - negatives: views from DIFFERENT worlds (the analogue of a different
    corridor) and from the opposite side of the same orbit.

Reports, per vocabulary: median same/diff scores, the separation ratio,
and recall at the zero-false-positive threshold (fraction of positives
scoring above EVERY negative).

Run on CPU:
  JAX_PLATFORMS=cpu python scripts/eval_vocab.py
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np
import jax.numpy as jnp

from orb_slam2_with_comment_tpu.dataio.synthetic import (SyntheticWorld,
                                                         orbit_trajectory)
from orb_slam2_with_comment_tpu.frontend import OrbExtractor
from orb_slam2_with_comment_tpu.place.vocabulary import (
    bow_sparse, load_vocabulary, score_l1_sparse, transform)

HELD_OUT_SEEDS = range(200, 212)
CAP = 600


def jitter(img, rng):
    gamma = rng.uniform(0.75, 1.35)
    gain = rng.uniform(0.75, 1.2)
    img = 255.0 * (img / 255.0) ** gamma * gain
    return np.clip(img + rng.normal(0, 3.0, img.shape), 0, 255)


def vec(voc, ext, img):
    f = ext(jnp.asarray(np.clip(img, 0, 255).astype(np.uint8)))
    words = transform(voc, f.desc, f.valid)
    return bow_sparse(voc, words, f.valid, CAP)


def evaluate(voc, label):
    ext = OrbExtractor(n_features=600)
    rng = np.random.default_rng(77)
    same, diff = [], []
    n_words = int(voc.n_words)
    for seed in HELD_OUT_SEEDS:
        world = SyntheticWorld(seed=seed)
        poses = orbit_trajectory(n_frames=16)
        R, t = poses[3]
        img_a, _ = world.render(R, t)
        # revisit positives: same view under new exposure, and the
        # adjacent orbit view (small-baseline offset) under new exposure
        img_b, _ = world.render(*poses[4])
        va = vec(voc, ext, img_a)
        vb = vec(voc, ext, jitter(img_a, rng))
        vb2 = vec(voc, ext, jitter(img_b, rng))
        # negatives: different world, and the far side of this orbit
        other = SyntheticWorld(seed=seed + 1000)
        vn1 = vec(voc, ext, other.render(R, t)[0])
        vn2 = vec(voc, ext, world.render(*poses[11])[0])
        rows_i = jnp.stack([vb[0], vb2[0], vn1[0], vn2[0]])
        rows_w = jnp.stack([vb[1], vb2[1], vn1[1], vn2[1]])
        s = np.asarray(score_l1_sparse(va[0], va[1], rows_i, rows_w,
                                       n_words))
        same.extend([s[0], s[1]])
        diff.extend([s[2], s[3]])
    same = np.asarray(same)
    diff = np.asarray(diff)
    th = diff.max()  # zero-false-positive threshold
    recall = float(np.mean(same > th))
    print(f"| {label} | {voc.n_words} | {np.median(same):.3f} | "
          f"{np.median(diff):.3f} | "
          f"{np.median(same)/max(np.median(diff),1e-9):.2f}x | "
          f"{recall*100:.0f}% |", flush=True)
    return recall


def main():
    base = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "orb_slam2_with_comment_tpu", "place",
        "data")
    print("| vocabulary | words | same-place score (med) | "
          "different-place score (med) | separation | "
          "recall @ zero-FP |")
    print("|---|---|---|---|---|---|")
    evaluate(load_vocabulary(os.path.join(base, "vocab_10k.npz"),
                             as_numpy=True), "10k (24 worlds, r3 default)")
    evaluate(load_vocabulary(os.path.join(base, "vocab_default.npz"),
                             as_numpy=True), "88.5k (48 worlds, default)")


if __name__ == "__main__":
    main()
