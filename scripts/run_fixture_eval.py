#!/usr/bin/env python
"""Run the dataset drivers end-to-end on the deterministic fixtures and
write RESULTS.md with measured ATE (the real TUM/KITTI/EuRoC archives are
unreachable from this environment — the attempt is documented in
RESULTS.md; the fixtures exercise the identical on-disk formats and code
path: PNG decode -> loaders -> System driver -> trajectory export -> ATE).

Usage:
  python scripts/run_fixture_eval.py [--root /tmp/fixtures] [--frames 120]
"""
import argparse
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

# One process per card: a JAX process reserves most of the card's
# memory when it first uses it. The parent (whose package import pulls in
# jax) pins itself to the CPU and hands the ORIGINAL environment to the
# driver subprocesses, which run serially, one at a time on the card.
CHILD_ENV = dict(os.environ)
os.environ["JAX_PLATFORMS"] = "cpu"

import numpy as np


def _quat_to_R(qx, qy, qz, qw):
    x, y, z, w = qx, qy, qz, qw
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
        [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
        [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
    ])


def read_tum(path):
    """TUM trajectory file -> (ts [N], centers [N,3]) (poses are
    camera-to-world; the camera center IS the translation column)."""
    ts, cs = [], []
    for ln in open(path):
        ln = ln.strip()
        if not ln or ln.startswith("#"):
            continue
        v = [float(x) for x in ln.split()]
        ts.append(v[0])
        cs.append(v[1:4])
    return np.asarray(ts), np.asarray(cs)


def read_tum_full(path):
    """TUM file -> (ts, R_cw [N,3,3], t_cw [N,3]) world->camera."""
    ts, Rs, tsl = [], [], []
    for ln in open(path):
        ln = ln.strip()
        if not ln or ln.startswith("#"):
            continue
        v = [float(x) for x in ln.split()]
        Rwc = _quat_to_R(v[4], v[5], v[6], v[7])
        twc = np.asarray(v[1:4])
        Rs.append(Rwc.T)
        tsl.append(-Rwc.T @ twc)
        ts.append(v[0])
    return np.asarray(ts), np.asarray(Rs), np.asarray(tsl)


def read_kitti(path):
    rows = [[float(x) for x in ln.split()] for ln in open(path)
            if ln.strip()]
    P = np.asarray(rows).reshape(-1, 3, 4)
    return P[:, :, 3]  # camera centers (camera-to-world translation)


def read_kitti_full(path):
    """KITTI file (camera-to-world 3x4) -> (R_cw, t_cw) world->camera."""
    rows = [[float(x) for x in ln.split()] for ln in open(path)
            if ln.strip()]
    P = np.asarray(rows).reshape(-1, 3, 4)
    Rwc, twc = P[:, :, :3], P[:, :, 3]
    Rcw = np.transpose(Rwc, (0, 2, 1))
    tcw = -np.einsum("nij,nj->ni", Rcw, twc)
    return Rcw, tcw


def associate(ts_a, ts_b, max_diff=0.02):
    ib = np.searchsorted(ts_b, ts_a)
    out = []
    for i, t in enumerate(ts_a):
        best, bd = -1, max_diff
        for j in (ib[i] - 1, ib[i]):
            if 0 <= j < len(ts_b) and abs(ts_b[j] - t) <= bd:
                best, bd = j, abs(ts_b[j] - t)
        if best >= 0:
            out.append((i, best))
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default="/tmp/fixtures")
    ap.add_argument("--frames", type=int, default=120)
    ap.add_argument("--skip-gen", action="store_true")
    args = ap.parse_args()
    env = CHILD_ENV
    results = {}

    if not args.skip_gen:
        subprocess.run([sys.executable,
                        os.path.join(REPO, "scripts/make_fixture_dataset.py"),
                        args.root, "--frames", str(args.frames)], check=True)

    from orb_slam2_with_comment_tpu.evaluation.ate import ate_rmse
    from orb_slam2_with_comment_tpu.evaluation.rpe import (
        kitti_segment_drift, rpe)

    def run_driver(script, cli, wd_name, capture=False):
        wd = os.path.join(args.root, wd_name)
        os.makedirs(wd, exist_ok=True)
        p = subprocess.run(
            [sys.executable, os.path.join(REPO, script)] + cli,
            cwd=wd, env=env, check=True,
            capture_output=capture, text=capture)
        if capture:
            print(p.stdout)
        return wd, (p.stdout if capture else "")

    def tum_metrics(est_path, gt_path, with_scale=False):
        """ATE (+ per-frame RPE when timestamps pair densely)."""
        ts_e, R_e, t_e = read_tum_full(est_path)
        ts_g, R_g, t_g = read_tum_full(gt_path)
        pairs = associate(ts_e, ts_g)
        ia = [p[0] for p in pairs]
        ib = [p[1] for p in pairs]
        c_e = np.stack([-(R.T @ t) for R, t in zip(R_e[ia], t_e[ia])])
        c_g = np.stack([-(R.T @ t) for R, t in zip(R_g[ib], t_g[ib])])
        out = {"tracked": len(ts_e), "n_paired": len(pairs),
               "ate_rmse_m": float(ate_rmse(c_e, c_g,
                                            with_scale=with_scale))}
        if len(pairs) > 30:
            r = rpe(R_e[ia], t_e[ia], R_g[ib], t_g[ib], delta=1)
            out["rpe_trans_rmse_m"] = r["trans_rmse"]
            out["rpe_rot_rmse_deg"] = float(np.degrees(r["rot_rmse"]))
        return out

    # --- TUM RGB-D driver (host System path) ---
    tum = os.path.join(args.root, "tum_fixture")
    wd, _ = run_driver("examples/rgbd_tum.py",
                       [os.path.join(tum, "settings.yaml"), tum], "run_tum")
    results["tum_rgbd"] = dict(
        frames=args.frames,
        **tum_metrics(os.path.join(wd, "CameraTrajectory.txt"),
                      os.path.join(tum, "groundtruth.txt")))

    # --- TUM RGB-D REVISIT loop sequence (autonomous on-device path:
    # tracking + amortized maintenance + loop closing, zero readbacks) ---
    loopd = os.path.join(args.root, "tum_loop_fixture")
    wd, out_txt = run_driver(
        "examples/rgbd_tum.py",
        [os.path.join(loopd, "settings.yaml"), loopd, "--auto"],
        "run_tum_loop", capture=True)
    m_loops = 0
    for tok in out_txt.split("\n"):
        if "loops closed" in tok:
            m_loops = int(tok.split("keyframes,")[1].split("loops")[0])
    results["tum_loop"] = dict(
        frames=args.frames, loops_closed=m_loops,
        **tum_metrics(os.path.join(wd, "CameraTrajectory.txt"),
                      os.path.join(loopd, "groundtruth.txt")))

    # --- KITTI stereo driver (+ devkit segment drift) ---
    kitti = os.path.join(args.root, "kitti_fixture")
    wd, _ = run_driver("examples/stereo_kitti.py",
                       [os.path.join(kitti, "settings.yaml"), kitti],
                       "run_kitti")
    c_e = read_kitti(os.path.join(wd, "CameraTrajectory.txt"))
    c_g = read_kitti(os.path.join(kitti, "poses_gt.txt"))
    R_e, t_e = read_kitti_full(os.path.join(wd, "CameraTrajectory.txt"))
    R_g, t_g = read_kitti_full(os.path.join(kitti, "poses_gt.txt"))
    n = min(len(c_e), len(c_g))
    drift = kitti_segment_drift(R_e[:n], t_e[:n], R_g[:n], t_g[:n],
                                lengths=(1, 2))  # fixture spans ~2.6 m
    results["kitti_stereo"] = {
        "frames": len(c_g), "tracked": len(c_e),
        "ate_rmse_m": float(ate_rmse(c_e[:n], c_g[:n])),
        "drift_trans_pct": drift["trans_pct"],
        "drift_rot_deg_per_m": drift["rot_deg_per_m"]}

    # --- EuRoC stereo driver: RAW DISTORTED images rectified online
    # through the YAML LEFT./RIGHT. blocks (reference stereo_euroc.cc) ---
    euroc = os.path.join(args.root, "euroc_fixture")
    wd, _ = run_driver(
        "examples/stereo_euroc.py",
        [os.path.join(euroc, "settings.yaml"),
         os.path.join(euroc, "mav0"),
         os.path.join(euroc, "timestamps.txt")], "run_euroc")
    results["euroc_stereo"] = dict(
        frames=len(open(os.path.join(euroc, "timestamps.txt"))
                   .read().split()),
        **tum_metrics(os.path.join(wd, "CameraTrajectory.txt"),
                      os.path.join(euroc, "groundtruth_tum.txt")))

    # --- mono TUM driver (scale-aligned ATE) ---
    wd, _ = run_driver("examples/mono_tum.py",
                       [os.path.join(tum, "settings.yaml"), tum], "run_mono")
    ts_e, c_e = read_tum(os.path.join(wd, "KeyFrameTrajectory.txt"))
    ts_g, c_g = read_tum(os.path.join(tum, "groundtruth.txt"))
    pairs = associate(ts_e, ts_g)
    ia = [p[0] for p in pairs]
    ib = [p[1] for p in pairs]
    results["tum_mono"] = {
        "frames": args.frames, "keyframes": len(ts_e),
        "ate_rmse_m_scaled": float(ate_rmse(c_e[ia], c_g[ib],
                                            with_scale=True))}

    # --- mono REVISIT loop sequence through the autonomous path
    # (VERDICT r3 #8: a mono loop fixture through mono_tum.py --auto) ---
    wd, out_mono_loop = run_driver(
        "examples/mono_tum.py",
        [os.path.join(loopd, "settings.yaml"), loopd, "--auto"],
        "run_mono_loop", capture=True)
    ml_loops = 0
    for tok in out_mono_loop.split("\n"):
        if "loops closed" in tok:
            ml_loops = int(tok.split("keyframes,")[1].split("loops")[0])
    ts_e, c_e = read_tum(os.path.join(wd, "CameraTrajectory.txt"))
    ts_g, c_g = read_tum(os.path.join(loopd, "groundtruth.txt"))
    pairs = associate(ts_e, ts_g)
    ia = [p[0] for p in pairs]
    ib = [p[1] for p in pairs]
    results["tum_mono_loop"] = {
        "frames": args.frames, "tracked": len(ts_e),
        "loops_closed": ml_loops,
        "ate_rmse_m_scaled": (float(ate_rmse(c_e[ia], c_g[ib],
                                             with_scale=True))
                              if len(pairs) > 10 else float("nan"))}

    def fmt_rpe(r):
        if "rpe_trans_rmse_m" not in r:
            return "—"
        return (f"{r['rpe_trans_rmse_m']*1000:.1f} mm / "
                f"{r['rpe_rot_rmse_deg']:.3f}°")

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
        "## Fixture runs (deterministic synthetic sequences, real formats)",
        "",
        "| run | frames | tracked/KFs | ATE RMSE | RPE Δ1 (t/rot) | extra |",
        "|---|---|---|---|---|---|",
    ]
    r = results["tum_rgbd"]
    lines.append(f"| TUM-format RGB-D (examples/rgbd_tum.py) | {r['frames']} "
                 f"| {r['tracked']} | {r['ate_rmse_m']*100:.1f} cm | "
                 f"{fmt_rpe(r)} | |")
    r = results["tum_loop"]
    lines.append(f"| TUM-format RGB-D 2-lap revisit (--auto, on-device "
                 f"loop closing) | {r['frames']} | {r['tracked']} | "
                 f"{r['ate_rmse_m']*100:.1f} cm | {fmt_rpe(r)} | "
                 f"{r['loops_closed']} loop(s) closed |")
    r = results["kitti_stereo"]
    lines.append(f"| KITTI-format stereo (examples/stereo_kitti.py) | "
                 f"{r['frames']} | {r['tracked']} | "
                 f"{r['ate_rmse_m']*100:.1f} cm | — | "
                 f"drift {r['drift_trans_pct']:.2f}% / "
                 f"{r['drift_rot_deg_per_m']:.3f}°/m |")
    r = results["euroc_stereo"]
    lines.append(f"| EuRoC-format stereo, raw distorted input rectified "
                 f"online (examples/stereo_euroc.py) | {r['frames']} | "
                 f"{r['tracked']} | {r['ate_rmse_m']*100:.1f} cm | "
                 f"{fmt_rpe(r)} | radtan k1=-0.2 k2=0.05 |")
    r = results["tum_mono"]
    lines.append(f"| TUM-format mono (examples/mono_tum.py, Sim3-aligned) | "
                 f"{r['frames']} | {r['keyframes']} KFs | "
                 f"{r['ate_rmse_m_scaled']*100:.1f} cm | — | "
                 f"monocular gauge |")
    r = results.get("tum_mono_loop")
    if r:
        lines.append(f"| TUM-format mono 2-lap revisit (--auto, on-device "
                     f"loop closing, Sim3-aligned) | {r['frames']} | "
                     f"{r['tracked']} | {r['ate_rmse_m_scaled']*100:.1f} cm "
                     f"| — | {r['loops_closed']} loop(s) closed |")
    lines += [
        "",
        "Reference bars (BASELINE.md, paper values on real datasets): "
        "TUM RGB-D ≈0.4–1.6 cm, EuRoC stereo ≈3.5–12 cm, KITTI stereo "
        "≈1.3 m over km-scale drives. The fixture trajectories span "
        "~1.2–2.6 m, so cm-level ATE at 100% tracked is the comparable "
        "operating point.",
        "",
        "Fixtures: `scripts/make_fixture_dataset.py` (640x480, textured-"
        "room ray-cast orbit, true 8 cm stereo baseline, 16-bit depth at "
        "DepthMapFactor 5000, EuRoC fixture rendered through the radtan "
        "model and rectified online by `dataio/rectify.py`). Regenerate + "
        "re-measure with `python scripts/run_fixture_eval.py --frames "
        f"{args.frames}`.",
        "",
    ]
    with open(os.path.join(REPO, "RESULTS.md"), "w") as f:
        f.write("\n".join(lines))
    print("\n".join(lines))


if __name__ == "__main__":
    main()
