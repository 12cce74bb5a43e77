#!/usr/bin/env python
"""RGB-D TUM driver (reference: Examples/RGB-D/rgbd_tum — the file is
missing from the reference fork, SURVEY.md §0.1.4; behavior follows
upstream + README.md:151-167: associations loader -> System::TrackRGBD,
then SaveTrajectoryTUM + SaveKeyFrameTrajectoryTUM).

Usage: rgbd_tum.py <settings.yaml> <sequence_dir> [associations.txt] [--auto]

--auto runs the autonomous on-device tracker (pipeline.auto.AutoTracker):
the whole per-frame state machine incl. keyframe maintenance and loop
closing executes on device with zero per-frame host synchronization.
Per-frame poses are then not printed during the run; the trajectory is
read back once at the end.
"""
import sys
import time

sys.path.insert(0, __file__.rsplit("/", 2)[0])

from orb_slam2_with_comment_tpu import Sensor, System
from orb_slam2_with_comment_tpu.runtime import enable_compilation_cache

enable_compilation_cache()
from orb_slam2_with_comment_tpu.dataio.datasets import TumRgbdDataset
from orb_slam2_with_comment_tpu.dataio.settings import load_settings


def main(argv):
    argv = list(argv)
    auto = "--auto" in argv
    if auto:
        argv.remove("--auto")
    if len(argv) < 3:
        print(__doc__)
        return 1
    settings_path, seq_dir = argv[1], argv[2]
    assoc = argv[3] if len(argv) > 3 else None
    s = load_settings(settings_path)
    ds = TumRgbdDataset(seq_dir, depth_map_factor=s.depth_map_factor,
                        associations=assoc)
    print(f"Loaded {len(ds)} frames from {seq_dir}")
    if auto:
        from orb_slam2_with_comment_tpu.dataio.settings import (
            load_tracker_config)
        from orb_slam2_with_comment_tpu.pipeline import AutoTracker
        cfg = load_tracker_config(settings_path, expected_frames=len(ds))
        cfg.sensor = "rgbd"  # loader yields meters; cfg.depth_factor is 1.0
        tracker = AutoTracker(cfg)
        t0 = time.perf_counter()
        for ts, rgb, depth in ds.prefetch():
            tracker.process_rgbd(rgb, depth, timestamp=ts)
        tracker.sync()
        dt = time.perf_counter() - t0
        out = tracker.finalize()
        print(f"{out['n_frames']} frames in {dt:.2f}s "
              f"({out['n_frames'] / dt:.1f} fps), "
              f"{out['n_keyframes']} keyframes, "
              f"{out['n_loops_closed']} loops closed, "
              f"lost_at={out['lost_at']}")
        from _util import write_run_summary
        write_run_summary(out, dt)
        with open("CameraTrajectory.txt", "w") as f:
            f.write("\n".join(tracker.trajectory_tum()) + "\n")
        return 0
    slam = System(settings_path=settings_path, sensor=Sensor.RGBD,
                  expected_frames=len(ds))
    times = []
    for ts, rgb, depth in ds.prefetch():
        t0 = time.perf_counter()
        slam.track_rgbd(rgb, depth, ts)
        times.append(time.perf_counter() - t0)
    slam.shutdown()
    times.sort()
    n = len(times)
    print(f"median tracking time: {times[n // 2]:.4f}s  "
          f"mean: {sum(times) / n:.4f}s")
    slam.save_trajectory_tum("CameraTrajectory.txt")
    slam.save_keyframe_trajectory_tum("KeyFrameTrajectory.txt")
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv))
