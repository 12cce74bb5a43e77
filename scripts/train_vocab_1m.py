#!/usr/bin/env python
"""Train a reference-scale (~10^6-leaf) vocabulary tree (VERDICT r4 #8).

The reference ships ORBvoc.txt: k=10, L=6 => up to 10^6 leaf words
(Thirdparty/DBoW2/DBoW2/TemplatedVocabulary.h:109), trained on Flickr1M.
Real-image corpora are unreachable here (zero egress), so the corpus is
millions of ORB descriptors harvested from procedurally-textured planar
images: a random coarse grid bilinearly upsampled + a fine octave —
exactly the texture statistics the ray-cast worlds show the extractor,
but generated directly as images (no ray casting), which makes harvesting
millions of descriptors tractable on this 2-core host.

What the resulting tree PROVES at reference scale (VOCAB.md):
  - the trainer runs at k=10, L=6 over a multi-million-descriptor corpus;
  - node-array memory at ~10^6 words (~35 MB projected);
  - descent (V.transform) and sparse-row scoring cost at 10^6 words;
  - held-out separation vs the 88.5k default (scripts/eval_vocab.py).

Run (CPU, ~1-2 h):
  JAX_PLATFORMS=cpu python scripts/train_vocab_1m.py
"""
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np  # noqa: E402
import jax.numpy as jnp  # noqa: E402


def textured_image(rng, width=640, height=480):
    """Procedural texture in the plane-texture family of
    dataio.synthetic._Plane: coarse corner-bearing grid + weak fine
    octave + photometric jitter."""
    gh, gw = rng.randint(14, 30), rng.randint(18, 38)
    coarse = rng.uniform(40, 240, (gh, gw)).astype(np.float32)
    ys = np.linspace(0, gh - 1.001, height)
    xs = np.linspace(0, gw - 1.001, width)
    iy, ix = np.floor(ys).astype(int), np.floor(xs).astype(int)
    fy, fx = (ys - iy)[:, None], (xs - ix)[None, :]
    img = (coarse[iy][:, ix] * (1 - fy) * (1 - fx)
           + coarse[iy][:, ix + 1] * (1 - fy) * fx
           + coarse[iy + 1][:, ix] * fy * (1 - fx)
           + coarse[iy + 1][:, ix + 1] * fy * fx)
    fine = rng.uniform(-14, 14, (2 * gh, 2 * gw)).astype(np.float32)
    iy2 = np.minimum((2 * ys).astype(int), 2 * gh - 1)
    ix2 = np.minimum((2 * xs).astype(int), 2 * gw - 1)
    img = img + fine[iy2][:, ix2]
    gamma = rng.uniform(0.7, 1.4)
    gain = rng.uniform(0.7, 1.25)
    img = 255.0 * np.clip(img / 255.0, 0, 1) ** gamma * gain
    img = img + rng.normal(0, 3.0, img.shape)
    return np.clip(img, 0, 255).astype(np.uint8)


def main(n_images: int = 1400, out: str | None = None):
    from orb_slam2_with_comment_tpu.frontend import OrbExtractor
    from orb_slam2_with_comment_tpu.place.vocabulary import (
        save_vocabulary, train_vocabulary)

    rng = np.random.RandomState(7)
    ext = OrbExtractor(n_features=2000)
    all_desc = []
    t0 = time.time()
    for i in range(n_images):
        img = textured_image(rng)
        f = ext(jnp.asarray(img))
        d = np.asarray(f.desc)[np.asarray(f.valid)]
        all_desc.append(d)
        if (i + 1) % 100 == 0:
            tot = sum(len(d) for d in all_desc)
            print(f"{i + 1}/{n_images} images, {tot} descriptors, "
                  f"{time.time() - t0:.0f}s", flush=True)
    descs = np.concatenate(all_desc)
    print(f"corpus: {len(descs)} descriptors")

    t0 = time.time()
    voc = train_vocabulary(descs, k=10, levels=6, seed=0)
    print(f"trained k=10 L=6: {voc.n_words} words, "
          f"{voc.node_desc.shape[0]} nodes in {time.time() - t0:.0f}s")
    nbytes = (np.asarray(voc.node_desc).nbytes
              + np.asarray(voc.children).nbytes
              + np.asarray(voc.leaf_word).nbytes
              + np.asarray(voc.word_weight).nbytes)
    print(f"node-array memory: {nbytes / 1e6:.1f} MB")
    out = out or os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "orb_slam2_with_comment_tpu/place/data/vocab_1m.npz")
    save_vocabulary(voc, out)
    print("saved", out)


if __name__ == "__main__":
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 1400
    main(n)
