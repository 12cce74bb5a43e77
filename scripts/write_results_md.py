#!/usr/bin/env python
"""Assemble RESULTS.md from fixture-eval run directories.

`run_fixture_eval.py` runs every driver and then writes RESULTS.md at the
end; on a shared 2-core host a full 500-frame pass takes long enough that
the round can end mid-eval. This script recomputes the metrics from
whatever `run_*` trajectory exports already exist under --root and writes
RESULTS.md with the completed rows (marking the rest pending), so partial
evidence is committable at any point and the table upgrades in place as
more drivers finish.

Usage: python scripts/write_results_md.py [--root /tmp/fixtures500] [--frames 500]
"""
import argparse
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "scripts"))
os.environ["JAX_PLATFORMS"] = "cpu"

import numpy as np

from run_fixture_eval import (associate, read_kitti, read_kitti_full,
                              read_tum, read_tum_full)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default="/tmp/fixtures500")
    ap.add_argument("--frames", type=int, default=500)
    ap.add_argument("--log", default="/tmp/eval500.log",
                    help="driver log (parsed for 'loops closed' counts)")
    args = ap.parse_args()

    from orb_slam2_with_comment_tpu.evaluation.ate import ate_rmse
    from orb_slam2_with_comment_tpu.evaluation.rpe import (
        kitti_segment_drift, rpe)

    loops_by_order = []
    if os.path.exists(args.log):
        for ln in open(args.log, errors="replace"):
            if "loops closed" in ln:
                try:
                    loops_by_order.append(
                        int(ln.split("keyframes,")[1].split("loops")[0]))
                except (IndexError, ValueError):
                    pass

    def tum_metrics(est_path, gt_path, with_scale=False):
        ts_e, R_e, t_e = read_tum_full(est_path)
        ts_g, R_g, t_g = read_tum_full(gt_path)
        pairs = associate(ts_e, ts_g)
        ia = [p[0] for p in pairs]
        ib = [p[1] for p in pairs]
        c_e = np.stack([-(R.T @ t) for R, t in zip(R_e[ia], t_e[ia])])
        c_g = np.stack([-(R.T @ t) for R, t in zip(R_g[ib], t_g[ib])])
        out = {"tracked": len(ts_e),
               "ate_rmse_m": float(ate_rmse(c_e, c_g, with_scale=with_scale))}
        if len(pairs) > 30:
            r = rpe(R_e[ia], t_e[ia], R_g[ib], t_g[ib], delta=1)
            out["rpe"] = (f"{r['trans_rmse']*1000:.1f} mm / "
                          f"{float(np.degrees(r['rot_rmse'])):.3f}°")
        return out

    rows = []

    def row(label, frames, tracked, ate_cm, rpe_s, extra):
        rows.append(f"| {label} | {frames} | {tracked} | {ate_cm} | "
                    f"{rpe_s} | {extra} |")

    root = args.root
    traj = lambda d, f="CameraTrajectory.txt": os.path.join(root, d, f)
    done = lambda d, f="CameraTrajectory.txt": os.path.exists(traj(d, f)) \
        and os.path.getsize(traj(d, f)) > 0

    def run_loops(d, order_idx):
        """Loops-closed count for run dir ``d``: prefer the driver's own
        run_summary.json (exact attribution); fall back to the shared
        log's line order only when the summary is absent (ADVICE r4)."""
        p = traj(d, "run_summary.json")
        if os.path.exists(p):
            try:
                import json
                return json.load(open(p))["n_loops_closed"]
            except (ValueError, KeyError):
                pass
        return (loops_by_order[order_idx]
                if len(loops_by_order) > order_idx else "?")

    pending = []
    if done("run_tum"):
        m = tum_metrics(traj("run_tum"),
                        os.path.join(root, "tum_fixture/groundtruth.txt"))
        row("TUM-format RGB-D (examples/rgbd_tum.py)", args.frames,
            m["tracked"], f"{m['ate_rmse_m']*100:.1f} cm",
            m.get("rpe", "—"), "")
    else:
        pending.append("TUM RGB-D")
    if done("run_tum_loop"):
        m = tum_metrics(traj("run_tum_loop"),
                        os.path.join(root, "tum_loop_fixture/groundtruth.txt"))
        nl = run_loops("run_tum_loop", 0)
        row("TUM-format RGB-D 2-lap revisit (--auto, on-device loop closing)",
            args.frames, m["tracked"], f"{m['ate_rmse_m']*100:.1f} cm",
            m.get("rpe", "—"), f"{nl} loop(s) closed")
    else:
        pending.append("TUM RGB-D revisit loop")
    if done("run_kitti"):
        c_e = read_kitti(traj("run_kitti"))
        c_g = read_kitti(os.path.join(root, "kitti_fixture/poses_gt.txt"))
        R_e, t_e = read_kitti_full(traj("run_kitti"))
        R_g, t_g = read_kitti_full(
            os.path.join(root, "kitti_fixture/poses_gt.txt"))
        n = min(len(c_e), len(c_g))
        drift = kitti_segment_drift(R_e[:n], t_e[:n], R_g[:n], t_g[:n],
                                    lengths=(1, 2))
        row("KITTI-format stereo (examples/stereo_kitti.py)", len(c_g),
            len(c_e), f"{float(ate_rmse(c_e[:n], c_g[:n]))*100:.1f} cm",
            "—", f"drift {drift['trans_pct']:.2f}% / "
            f"{drift['rot_deg_per_m']:.3f}°/m")
    else:
        pending.append("KITTI stereo")
    if done("run_euroc"):
        m = tum_metrics(traj("run_euroc"),
                        os.path.join(root, "euroc_fixture/groundtruth_tum.txt"))
        row("EuRoC-format stereo, raw distorted input rectified online "
            "(examples/stereo_euroc.py)", args.frames, m["tracked"],
            f"{m['ate_rmse_m']*100:.1f} cm", m.get("rpe", "—"),
            "radtan k1=-0.2 k2=0.05")
    else:
        pending.append("EuRoC stereo (online rectification)")
    if done("run_mono", "KeyFrameTrajectory.txt"):
        ts_e, c_e = read_tum(traj("run_mono", "KeyFrameTrajectory.txt"))
        ts_g, c_g = read_tum(os.path.join(root, "tum_fixture/groundtruth.txt"))
        pairs = associate(ts_e, ts_g)
        ia = [p[0] for p in pairs]
        ib = [p[1] for p in pairs]
        from orb_slam2_with_comment_tpu.evaluation.ate import ate_rmse as _a
        row("TUM-format mono (examples/mono_tum.py, Sim3-aligned)",
            args.frames, f"{len(ts_e)} KFs",
            f"{float(_a(c_e[ia], c_g[ib], with_scale=True))*100:.1f} cm",
            "—", "monocular gauge")
    else:
        pending.append("TUM mono")
    if done("run_mono_loop"):
        ts_e, c_e = read_tum(traj("run_mono_loop"))
        ts_g, c_g = read_tum(
            os.path.join(root, "tum_loop_fixture/groundtruth.txt"))
        pairs = associate(ts_e, ts_g)
        ia = [p[0] for p in pairs]
        ib = [p[1] for p in pairs]
        nl = run_loops("run_mono_loop", 1)
        from orb_slam2_with_comment_tpu.evaluation.ate import ate_rmse as _a
        ate = (f"{float(_a(c_e[ia], c_g[ib], with_scale=True))*100:.1f} cm"
               if len(pairs) > 10 else "n/a")
        row("TUM-format mono 2-lap revisit (--auto, on-device loop closing, "
            "Sim3-aligned)", args.frames, len(ts_e), ate, "—",
            f"{nl} loop(s) closed")
    else:
        pending.append("mono revisit loop")

    lines = [
        "# RESULTS — dataset-path end-to-end runs",
        "",
        "## Real benchmark datasets: download attempt (documented)",
        "",
        "This environment has **zero network egress**: "
        "`curl https://vision.in.tum.de/...` returns HTTP code 000 "
        "(connection impossible), and no dataset archives exist anywhere "
        "on disk (`/root`, `/data`, `/mnt`, `/srv` checked). The paper "
        "targets in BASELINE.md therefore cannot be re-measured here; "
        "what CAN be validated offline is the complete real-dataset code "
        "path, which the fixtures below drive bit-for-bit: 8/16-bit PNG "
        "decode, TUM/KITTI list+association parsing, EuRoC timestamp "
        "lists with online stereo rectification from the YAML "
        "LEFT./RIGHT. blocks, cv::FileStorage settings, the System "
        "drivers, trajectory export in the exact reference formats "
        "(System.cc:336-486 semantics), and the in-repo ATE/RPE/KITTI-"
        "drift evaluators.",
        "",
        "## Fixture runs (deterministic synthetic sequences, real formats, "
        f"{args.frames} frames each, through the drivers)",
        "",
        "| run | frames | tracked/KFs | ATE RMSE | RPE Δ1 (t/rot) | extra |",
        "|---|---|---|---|---|---|",
    ] + rows + [
        "",
        "Reference bars (BASELINE.md, paper values on real datasets): "
        "TUM RGB-D ≈0.4–1.6 cm, EuRoC stereo ≈3.5–12 cm, "
        "KITTI stereo ≈1.3 m over km-scale drives. The fixture "
        "trajectories span ~1.2–2.6 m, so cm-level ATE at 100% "
        "tracked is the comparable operating point.",
        "",
        "Fixtures: `scripts/make_fixture_dataset.py` (640x480 "
        "textured-room ray-cast orbit, true 8 cm stereo baseline, 16-bit "
        "depth at DepthMapFactor 5000, EuRoC fixture rendered through the "
        "radtan model and rectified online by `dataio/rectify.py`; KITTI "
        "fixture at the KITTI camera geometry). Regenerate + re-measure "
        "with `python scripts/run_fixture_eval.py --frames "
        f"{args.frames}` (or rebuild this table from finished runs with "
        "`python scripts/write_results_md.py`).",
        "",
    ]
    if pending:
        lines += [f"Pending (driver still running when this table was "
                  f"written): {', '.join(pending)}.", ""]
    with open(os.path.join(REPO, "RESULTS.md"), "w") as f:
        f.write("\n".join(lines))
    print("\n".join(lines))


if __name__ == "__main__":
    main()
