"""KITTI-geometry stereo throughput (VERDICT r3 weak #3: the 640x480
figure says nothing about KITTI's 1241x376 / 2000-feature / ThDepth=35
operating point, reference: Examples/Stereo/KITTI00-02.yaml).

Renders the synthetic world through the KITTI 00-02 camera (fx=718.856,
cx=607.19, cy=185.22, bf=386.145 -> 53.7 cm baseline), tracks the full
autonomous stereo pipeline (extraction at n_features=2000 + row-band
association + maintenance + loop phase), and reports the anchored
steady-state rate.

Run: python scripts/bench_kitti_shape.py
"""
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import jax

from orb_slam2_with_comment_tpu.runtime import enable_compilation_cache

enable_compilation_cache()

from orb_slam2_with_comment_tpu.dataio.synthetic import (SyntheticWorld,
                                                         orbit_trajectory)
from orb_slam2_with_comment_tpu.mapstate.map import MapConfig
from orb_slam2_with_comment_tpu.pipeline import (AutoTracker,
                                                 AutoTrackerConfig,
                                                 TrackerConfig)

WIDTH, HEIGHT = 1241, 376
FX = FY = 718.856
CX, CY = 607.1928, 185.2157
BF = 386.1448


def main():
    n = int(os.environ.get("BENCH_FRAMES", "40"))
    world = SyntheticWorld(seed=1)
    poses = orbit_trajectory(n_frames=n)
    baseline = BF / FX
    frames = []
    for R, t in poses:
        left, _ = world.render(R, t, fx=FX, fy=FY, cx=CX, cy=CY,
                               width=WIDTH, height=HEIGHT)
        right, _ = world.render(
            np.asarray(R),
            np.asarray(t) - np.array([baseline, 0, 0], np.float32),
            fx=FX, fy=FY, cx=CX, cy=CY, width=WIDTH, height=HEIGHT)
        frames.append((np.clip(left, 0, 255).astype(np.uint8),
                       np.clip(right, 0, 255).astype(np.uint8)))
    cfg = TrackerConfig(
        sensor="stereo", n_features=2000, min_init_features=300,
        fx=FX, fy=FY, cx=CX, cy=CY, bf=BF, width=WIDTH, height=HEIGHT,
        th_depth=35.0,
        map_cfg=MapConfig(k_max=24, n_feat=2000, l_max=16000, d_max=8),
        fps=10)
    tr = AutoTracker(cfg, AutoTrackerConfig(traj_capacity=8 * n,
                                            batch_frames=4))
    for left, right in frames:
        tr.process_stereo(left, right)
    tr.sync()
    t0 = time.perf_counter()
    passes = 3
    for _ in range(passes):
        for left, right in frames:
            tr.process_stereo(left, right)
    tr.drain()
    # anchored: a real data readback inside the timed region
    n_kf = int(np.asarray(jax.device_get(tr.state.map.n_kf)))
    fps = passes * n / (time.perf_counter() - t0)
    out = tr.finalize()
    ok = out["initialized"] and out["lost_at"] < 0
    print({"metric": "kitti_shape_stereo_fps", "value": round(fps, 2),
           "valid": bool(ok), "n_keyframes": n_kf,
           "shape": f"{WIDTH}x{HEIGHT}", "n_features": 2000})
    if not ok:
        sys.exit(1)


if __name__ == "__main__":
    main()
