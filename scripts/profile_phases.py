"""Per-phase cost breakdown of the autonomous step (VERDICT r3 #6).

Times on real hardware, steady state (after a map-building pass):
  - full step fps at batch_frames in {4, 8, 16} (rgbd + stereo)
  - each keyframe-maintenance phase as its own jitted program on the
    BUILT map (fuse_in / fuse_out / merge / refresh+cull / ba1 / ba2 /
    loop-detect)
  - the tracking core alone

Writes a markdown table to stdout.
"""
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import jax
import jax.numpy as jnp

from orb_slam2_with_comment_tpu.runtime import enable_compilation_cache

enable_compilation_cache()

from orb_slam2_with_comment_tpu.dataio.synthetic import (SyntheticWorld,
                                                         orbit_trajectory)
from orb_slam2_with_comment_tpu.mapstate.map import MapConfig
from orb_slam2_with_comment_tpu.pipeline import (AutoTracker,
                                                 AutoTrackerConfig,
                                                 TrackerConfig)
from orb_slam2_with_comment_tpu.pipeline import auto_loop, steps

N_FRAMES = 60


def build_frames(cfg, stereo=False):
    world = SyntheticWorld(seed=1)
    poses = orbit_trajectory(n_frames=N_FRAMES)
    out = []
    baseline = cfg.bf / cfg.fx
    for R, t in poses:
        img, depth = world.render(R, t)
        if stereo:
            img_r, _ = world.render(np.asarray(R),
                                    np.asarray(t) - np.array(
                                        [baseline, 0, 0], np.float32))
            out.append((np.clip(img, 0, 255).astype(np.uint8),
                        np.clip(img_r, 0, 255).astype(np.uint8)))
        else:
            out.append((np.clip(img, 0, 255).astype(np.uint8),
                        np.clip(depth * 5000.0, 0, 65535).astype(np.uint16)))
    return out


def fps_at_batch(cfg, frames, batch, stereo=False):
    tr = AutoTracker(cfg, AutoTrackerConfig(traj_capacity=8 * N_FRAMES,
                                            batch_frames=batch))
    feed = tr.process_stereo if stereo else tr.process_rgbd
    for a, b in frames:
        feed(a, b)
    tr.sync()
    rates = []
    for _ in range(3):
        t0 = time.perf_counter()
        for a, b in frames:
            feed(a, b)
        tr.sync()
        rates.append(N_FRAMES / (time.perf_counter() - t0))
    return float(np.median(rates)), tr


def time_fn(fn, *args, n=10):
    out = jax.block_until_ready(fn(*args))
    t0 = time.perf_counter()
    for _ in range(n):
        out = fn(*args)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / n


def main():
    cfg = TrackerConfig(
        n_features=1000, min_init_features=200,
        map_cfg=MapConfig(k_max=24, n_feat=1000, l_max=8000, d_max=8),
        fps=30, depth_factor=1.0 / 5000.0)
    frames = build_frames(cfg)

    print("| config | fps |", flush=True)
    print("|---|---|")
    tr = None
    for batch in (4, 8, 16):
        f, tr = fps_at_batch(cfg, frames, batch)
        print(f"| rgbd batch={batch} | {f:.1f} |", flush=True)

    cfg_st = TrackerConfig(
        sensor="stereo", n_features=1000, min_init_features=200,
        map_cfg=MapConfig(k_max=24, n_feat=1000, l_max=8000, d_max=8),
        fps=30)
    frames_st = build_frames(cfg_st, stereo=True)
    for batch in (4, 8, 16):
        f, _ = fps_at_batch(cfg_st, frames_st, batch, stereo=True)
        print(f"| stereo batch={batch} | {f:.1f} |", flush=True)

    # ---- phase costs on the built map ----
    s = tr.state
    m = s.map
    cam = cfg.cam
    voc = tr.voc
    width, height = cfg.width, cfg.height
    kf = jnp.int32(max(int(jax.device_get(m.n_kf)) - 1, 0))
    from orb_slam2_with_comment_tpu.mapstate.map import covisibility_weights
    from orb_slam2_with_comment_tpu.ops import prims as _prims

    w = covisibility_weights(m, kf)
    top_w, top_i = _prims.sort_top_k(w, 10)
    nbrs = jnp.where(top_w > 0, top_i.astype(jnp.int32), -1)

    phases = {
        "covis_row": jax.jit(lambda m: covisibility_weights(m, kf)),
        "fuse_in": jax.jit(lambda m: steps.fuse_neighbors(
            m, cam, kf, nbrs[:5], width, height, into=True)),
        "fuse_out": jax.jit(lambda m: steps.fuse_neighbors(
            m, cam, kf, nbrs[:5], width, height, into=False)),
        "merge": jax.jit(lambda m: steps.merge_duplicate_landmarks(m, kf)),
        "refresh+cull": jax.jit(lambda m: steps.cull_landmarks(
            steps.refresh_landmarks_for_kf(m, kf), kf)),
        "local_ba3": jax.jit(lambda m: steps.local_bundle_adjustment(
            m, cam, kf, iters_a=3, erase_outliers=False)),
        "local_ba2+cull": jax.jit(lambda m: steps.cull_keyframes(
            steps.local_bundle_adjustment(
                m, cam, kf, iters_a=2, erase_outliers=True), kf, nbrs)),
        "loop_detect": jax.jit(lambda lp, m: auto_loop.detect(
            lp, m, kf, int(voc.n_words))),
        "track_core": jax.jit(lambda m, s: steps.track_frame_core(
            cam, m, s.prev, s.last_R, s.last_t, s.vel_R, s.vel_t,
            s.have_vel, s.ref_kf, s.prev.feats, s.prev.depth,
            jnp.float32(cfg.depth_threshold), jnp.int32(cfg.desc_th),
            jnp.int32(cfg.desc_th_local), jnp.int32(2),
            width, height)),
    }
    print("\n| phase | ms |", flush=True)
    print("|---|---|")
    for name, fn in phases.items():
        if name == "loop_detect":
            dt = time_fn(fn, s.loop, m)
        elif name == "track_core":
            dt = time_fn(fn, m, s)
        else:
            dt = time_fn(fn, m)
        print(f"| {name} | {dt*1e3:.2f} |", flush=True)


if __name__ == "__main__":
    main()
