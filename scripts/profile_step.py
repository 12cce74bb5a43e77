"""Isolate device step time vs host/dispatch overhead for the track step."""
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import jax
import jax.numpy as jnp

from orb_slam2_with_comment_tpu.runtime import enable_compilation_cache

enable_compilation_cache()

from orb_slam2_with_comment_tpu.dataio.synthetic import SyntheticWorld, orbit_trajectory
from orb_slam2_with_comment_tpu.mapstate.map import MapConfig
from orb_slam2_with_comment_tpu.pipeline import Tracker, TrackerConfig
from orb_slam2_with_comment_tpu.pipeline import steps

n_frames = 30
world = SyntheticWorld(seed=1)
poses = orbit_trajectory(n_frames=n_frames)
cfg = TrackerConfig(
    n_features=1000, min_init_features=200,
    map_cfg=MapConfig(k_max=24, n_feat=1000, l_max=8000, d_max=8), fps=30)
frames = [world.render(R, t) for R, t in poses]

tracker = Tracker(cfg)
for k in range(n_frames):
    tracker.process_rgbd(*frames[k], frame_id=k)
tracker.flush()

# steady-state: call the fused step with fixed inputs
img, depth = frames[-1]
img = jnp.asarray(img, jnp.float32)
depth = jnp.asarray(depth, jnp.float32)
obs = tracker.last_obs
R0, t0 = tracker.last_R, tracker.last_t
velR, velt = tracker.velocity
args = (cfg.cam, tracker.map, obs, R0, t0, velR, velt, True,
        jnp.int32(tracker.ref_kf), img, depth,
        jnp.float32(cfg.depth_factor), jnp.float32(cfg.depth_threshold), jnp.int32(cfg.desc_th),
        jnp.int32(cfg.desc_th_local), jnp.int32(2))

def call(m):
    return tracker._step(args[0], m, *args[2:])

res = call(tracker.map)
jax.block_until_ready(res.stats)

# 1. pure device time, synchronous
N = 20
t0_ = time.perf_counter()
for _ in range(N):
    res = call(res.map)
    jax.block_until_ready(res.stats)
dt_sync = (time.perf_counter() - t0_) / N

# 2. pipelined: dispatch all, block at the end
t0_ = time.perf_counter()
for _ in range(N):
    res = call(res.map)
jax.block_until_ready(res.stats)
dt_pipe = (time.perf_counter() - t0_) / N

# 3. dispatch-only cost
t0_ = time.perf_counter()
res = call(res.map)
dt_disp = time.perf_counter() - t0_
jax.block_until_ready(res.stats)

print("sync step:  %.1f ms" % (dt_sync * 1e3))
print("pipelined:  %.1f ms" % (dt_pipe * 1e3))
print("dispatch:   %.1f ms" % (dt_disp * 1e3))
