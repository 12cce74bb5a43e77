"""Train and ship the default BoW vocabulary (offline, once).

The reference ships ORBvoc.txt — a k=10, L=6 DBoW2 tree trained offline on
Flickr1M (reference: Vocabulary/ referenced by build.sh:20-22; absent from
this mount, SURVEY §7.7). This script is our counterpart trainer: it
harvests ORB descriptors from a spread of synthetic scenes (random
textures sample the binary-descriptor space much like random natural
patches) and trains a k-majority tree, saved as packaged arrays that
``place.vocabulary.load_default_vocabulary`` ships with the library.

Run on CPU:  JAX_PLATFORMS=cpu python scripts/train_vocab.py
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np  # noqa: E402
import jax.numpy as jnp  # noqa: E402


def main(n_worlds: int = 24, frames_per_world: int = 8,
         k: int = 10, levels: int = 4, out: str | None = None):
    """Harvest a diverse descriptor corpus and train the k^L tree.

    Diversity axes (the reference's Flickr1M gives natural-image variety;
    offline we substitute breadth of synthetic worlds + photometric
    augmentation): independent world textures per seed, orbit views at two
    radii/heights per world, and per-frame gamma/brightness/noise jitter —
    the descriptor bit statistics under these match what the intensity-
    comparison BRIEF pattern sees under real exposure variation.
    """
    from orb_slam2_with_comment_tpu.dataio.synthetic import (
        SyntheticWorld, orbit_trajectory)
    from orb_slam2_with_comment_tpu.frontend import OrbExtractor
    from orb_slam2_with_comment_tpu.place.vocabulary import (
        save_vocabulary, train_vocabulary)

    ext = OrbExtractor(n_features=1000)
    rng = np.random.RandomState(42)
    all_desc = []
    for seed in range(n_worlds):
        world = SyntheticWorld(seed=seed)
        poses = orbit_trajectory(n_frames=frames_per_world)
        for i, (R, t) in enumerate(poses):
            img, _ = world.render(R, t)
            img = np.clip(img, 0, 255).astype(np.float32)
            # photometric jitter: gamma + gain + sensor noise
            gamma = rng.uniform(0.7, 1.4)
            gain = rng.uniform(0.7, 1.25)
            img = 255.0 * (img / 255.0) ** gamma * gain
            img = img + rng.normal(0, 3.0, img.shape)
            img = np.clip(img, 0, 255).astype(np.uint8)
            f = ext(jnp.asarray(img))
            d = np.asarray(f.desc)[np.asarray(f.valid)]
            all_desc.append(d)
        print(f"world {seed}: {sum(len(d) for d in all_desc)} descriptors so far")
    descs = np.concatenate(all_desc)
    print(f"training k={k} L={levels} on {len(descs)} descriptors",
          flush=True)
    voc = train_vocabulary(descs, k=k, levels=levels, seed=0)
    if out is None:
        out = os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), "orb_slam2_with_comment_tpu",
            "place", "data", "vocab_default.npz")
    os.makedirs(os.path.dirname(out), exist_ok=True)
    save_vocabulary(voc, out)
    print(f"saved {voc.n_words}-word vocabulary -> {out}")


if __name__ == "__main__":
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("--worlds", type=int, default=24)
    ap.add_argument("--frames", type=int, default=8)
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--levels", type=int, default=4)
    ap.add_argument("--out", default=None)
    a = ap.parse_args()
    main(a.worlds, a.frames, a.k, a.levels, a.out)
