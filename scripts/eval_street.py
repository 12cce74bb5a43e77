#!/usr/bin/env python
"""Street-scale long-trajectory driver run (VERDICT r4 #6): drive
examples/stereo_kitti.py --auto over the ~65 m kitti_street_fixture
circuit (real KITTI 00-02 camera geometry) with a capacity that forces
slot recycling/compaction, evaluate KITTI segment drift + ATE, and
append the row to RESULTS.md.

Usage:
  python scripts/eval_street.py [--root /tmp/fixtures500] [--kmax 128]
"""
import argparse
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "scripts"))

# the parent stays off the device; the driver child gets the card
CHILD_ENV = dict(os.environ)
os.environ["JAX_PLATFORMS"] = "cpu"

import numpy as np  # noqa: E402

from run_fixture_eval import read_kitti, read_kitti_full  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default="/tmp/fixtures500")
    ap.add_argument("--kmax", type=int, default=128,
                    help="map capacity; small enough that the street's "
                         "keyframe count forces compaction")
    ap.add_argument("--skip-run", action="store_true")
    args = ap.parse_args()

    from orb_slam2_with_comment_tpu.evaluation.ate import ate_rmse
    from orb_slam2_with_comment_tpu.evaluation.rpe import kitti_segment_drift

    fix = os.path.join(args.root, "kitti_street_fixture")
    wd = os.path.join(args.root, "run_street")
    os.makedirs(wd, exist_ok=True)
    if not args.skip_run:
        subprocess.run(
            [sys.executable, os.path.join(REPO, "examples/stereo_kitti.py"),
             os.path.join(fix, "settings.yaml"), fix, "--auto",
             "--kmax", str(args.kmax)],
            cwd=wd, env=CHILD_ENV, check=True)

    summ = json.load(open(os.path.join(wd, "run_summary.json")))
    R_e, t_e = read_kitti_full(os.path.join(wd, "CameraTrajectory.txt"))
    R_g, t_g = read_kitti_full(os.path.join(fix, "poses_gt.txt"))
    c_e = read_kitti(os.path.join(wd, "CameraTrajectory.txt"))
    c_g = read_kitti(os.path.join(fix, "poses_gt.txt"))
    n = min(len(c_e), len(c_g))
    path_len = float(np.sum(np.linalg.norm(np.diff(c_g, axis=0), axis=1)))
    drift = kitti_segment_drift(R_e[:n], t_e[:n], R_g[:n], t_g[:n],
                                lengths=(5, 10, 20))
    ate = float(ate_rmse(c_e[:n], c_g[:n]))
    row = (f"| KITTI-geometry street circuit, {path_len:.0f} m "
           f"(examples/stereo_kitti.py --auto --kmax {args.kmax}) "
           f"| {summ['n_frames']} | {summ['n_frames']}"
           f" / {summ['n_keyframes']} KFs | {ate*100:.1f} cm | — "
           f"| drift {drift['trans_pct']:.2f}% / "
           f"{drift['rot_deg_per_m']:.3f}°/m, "
           f"{summ['n_loops_closed']} loop(s) closed, "
           f"{summ['n_compact_kf']} KF compactions |")
    print(row)
    print(json.dumps({"summary": summ, "ate_m": ate, **drift,
                      "path_len_m": path_len}))
    out = os.path.join(wd, "street_row.txt")
    open(out, "w").write(row + "\n")
    print("row written to", out)


if __name__ == "__main__":
    main()
