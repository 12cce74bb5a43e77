"""Headline benchmark: RGB-D tracking throughput on real hardware.

Runs the autonomous on-device tracking pipeline (ORB extraction ->
matching -> pose optimization -> on-device keyframe decision + keyframe
maintenance incl. fusion/culling/local BA) over a synthetic RGB-D sequence
and reports steady-state tracked frames/s. Baseline: the reference's
published real-time rate of ~30 fps on an i7 CPU (reference README.md:59,
TRO'17 timing tables; BASELINE.md).

Measurement protocol: pass 1 over the sequence builds the map and triggers
every one-time XLA compile (the counterpart of the reference's 10-20 s
vocabulary load + first-run warmup, which its timing tables also exclude);
then THREE timed passes re-track the same trajectory against the built map
and the reported rate is the MEDIAN pass. Since the
on-device map lifecycle landed, the steady-state passes are NOT
mapping-free: keyframe insertion + amortized maintenance keep running
whenever the NeedNewKeyFrame rules fire (slot recycling makes capacity a
non-issue), exactly as in a production revisit — so the steady-state and
map-building figures now bracket a narrower honest range.

The map-building figure (extra.map_building_fps) times a FRESH tracker
over one from-scratch pass including initialization and all keyframe
maintenance — the workload that actually is SLAM; it shares the compiled
step program (pipeline.auto._STEP_CACHE), so the number measures the
engine, not tracing overhead.

The tracker is pipeline.auto.AutoTracker: the entire per-frame state
machine (initialization gate, motion-model/reference-KF/local-map
tracking, NeedNewKeyFrame, keyframe maintenance, lost detection) runs on
device as ONE jitted step per frame; raw uint8 pixels + uint16 depth
(converted to meters on device via TrackerConfig.depth_factor, the
reference's DepthMapFactor semantics) stream in with no device->host
readback until the post-timing finalize — which is also how a production
driver runs it (pipeline/auto.py docstring).

After timing, the run is VALIDATED: finalize() must report an initialized,
never-lost run with every timed frame tracked and a sane keyframe count,
otherwise the script exits nonzero rather than print a number.

Prints ONE JSON line:
  {"metric": "tracking_fps", "value": N, "unit": "frames/s", "vs_baseline": N/30}
"""
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np  # noqa: E402
import jax  # noqa: E402

from orb_slam2_with_comment_tpu.runtime import enable_compilation_cache  # noqa: E402

enable_compilation_cache()

from orb_slam2_with_comment_tpu.dataio.synthetic import (  # noqa: E402
    SyntheticWorld, orbit_trajectory)
from orb_slam2_with_comment_tpu.mapstate.map import MapConfig  # noqa: E402
from orb_slam2_with_comment_tpu.pipeline import (  # noqa: E402
    AutoTracker, AutoTrackerConfig, TrackerConfig)

BASELINE_FPS = 30.0


def main():
    n_frames = int(os.environ.get("BENCH_FRAMES", "60"))
    world = SyntheticWorld(seed=1)
    poses = orbit_trajectory(n_frames=n_frames)
    cfg = TrackerConfig(
        n_features=1000, min_init_features=200,
        map_cfg=MapConfig(k_max=24, n_feat=1000, l_max=8000, d_max=8),
        fps=30, depth_factor=1.0 / 5000.0)
    frames = [(np.clip(img, 0, 255).astype(np.uint8),
               np.clip(depth * 5000.0, 0, 65535).astype(np.uint16))
              for img, depth in (world.render(R, t) for R, t in poses)]

    # batch_frames=4: four frames per scanned dispatch — amortizes
    # per-dispatch launch and transfer cost for 4 frames of pipeline
    # latency (133 ms at the 30 fps input rate; the reference's
    # LocalMapping/LoopClosing lag is of the same order)
    tracker = AutoTracker(cfg, AutoTrackerConfig(
        traj_capacity=8 * n_frames, batch_frames=4))

    # pass 1: build the map + compile everything (untimed warmup)
    for img, depth in frames:
        tracker.process_rgbd(img, depth)
    tracker.sync()

    # timed passes: steady-state re-tracking of the same trajectory
    rates = []
    for _ in range(3):
        t0 = time.perf_counter()
        for img, depth in frames:
            tracker.process_rgbd(img, depth)
        tracker.sync()
        dt = time.perf_counter() - t0
        rates.append(n_frames / dt)

    fps = float(np.median(rates))

    extra = {}
    # All validation readbacks happen together at the END, after every
    # timed figure.

    # --- map-BUILDING throughput (the steady-state number alone
    # flatters the bench): a FRESH tracker (same shapes -> cached
    # compiles) timed over ONE from-scratch pass including initialization
    # and every keyframe-maintenance step.
    tracker2 = AutoTracker(cfg, AutoTrackerConfig(
        traj_capacity=8 * n_frames, batch_frames=4))
    t0 = time.perf_counter()
    for img, depth in frames:
        tracker2.process_rgbd(img, depth)
    tracker2.sync()
    dt_build = time.perf_counter() - t0

    # --- stereo throughput: right view rendered at a true horizontal
    # baseline (bf=40, fx=500 -> 8 cm), joint L/R extraction + row-band
    # depth association per frame.
    baseline = cfg.bf / cfg.fx
    frames_st = []
    for (R, t), (img, _d) in zip(poses, frames):
        img_r, _ = world.render(np.asarray(R),
                                np.asarray(t) - np.array([baseline, 0, 0],
                                                         np.float32))
        frames_st.append((img, np.clip(img_r, 0, 255).astype(np.uint8)))
    cfg_st = TrackerConfig(
        sensor="stereo", n_features=1000, min_init_features=200,
        map_cfg=MapConfig(k_max=24, n_feat=1000, l_max=8000, d_max=8),
        fps=30)
    tracker_st = AutoTracker(cfg_st, AutoTrackerConfig(
        traj_capacity=8 * n_frames, batch_frames=4))
    for left, right in frames_st:  # warmup/compile + map build
        tracker_st.process_stereo(left, right)
    tracker_st.sync()
    st_rates = []
    for _ in range(2):
        t0 = time.perf_counter()
        for left, right in frames_st:
            tracker_st.process_stereo(left, right)
        tracker_st.sync()
        st_rates.append(n_frames / (time.perf_counter() - t0))

    # --- KITTI-geometry stereo: 1241x376, 2000 features,
    # the reference's KITTI 00-02 camera (Examples/Stereo/KITTI00-02.yaml:
    # fx=718.856, bf=386.14 -> 53.7 cm baseline). One build pass
    # (compile+map) then timed steady-state passes.
    KW, KH, KFX, KCX, KCY, KBF = 1241, 376, 718.856, 607.1928, 185.2157, 386.1448
    n_kitti = max(20, n_frames // 2)
    frames_kt = []
    for (R, t) in poses[:n_kitti]:
        left, _ = world.render(np.asarray(R), np.asarray(t),
                               fx=KFX, fy=KFX, cx=KCX, cy=KCY,
                               width=KW, height=KH)
        right, _ = world.render(
            np.asarray(R),
            np.asarray(t) - np.array([KBF / KFX, 0, 0], np.float32),
            fx=KFX, fy=KFX, cx=KCX, cy=KCY, width=KW, height=KH)
        frames_kt.append((np.clip(left, 0, 255).astype(np.uint8),
                          np.clip(right, 0, 255).astype(np.uint8)))
    cfg_kt = TrackerConfig(
        sensor="stereo", n_features=2000, min_init_features=200,
        fx=KFX, fy=KFX, cx=KCX, cy=KCY, bf=KBF,
        width=KW, height=KH,
        map_cfg=MapConfig(k_max=24, n_feat=2000, l_max=8000, d_max=8),
        fps=10)
    tracker_kt = AutoTracker(cfg_kt, AutoTrackerConfig(
        traj_capacity=8 * n_kitti, batch_frames=4))
    for left, right in frames_kt:
        tracker_kt.process_stereo(left, right)
    tracker_kt.sync()
    kt_rates = []
    for _ in range(2):
        t0 = time.perf_counter()
        for left, right in frames_kt:
            tracker_kt.process_stereo(left, right)
        tracker_kt.sync()
        kt_rates.append(n_kitti / (time.perf_counter() - t0))

    # --- monocular throughput: on-device H/F two-view
    # bootstrap + triangulation-only mapping, same orbit. Monocular
    # configs carry the reference's 2x extraction density
    # (mpIniORBextractor, Tracking.cc:126 — dataio.settings applies the
    # same doubling): at 1000 features the level-0 budget starves the
    # init window matcher below its >=100-match gate and the run never
    # initializes (the r4 missing-mono_fps failure).
    # min_init_matches=60: the synthetic-corner-density bootstrap gates
    # the fixture settings files already document (Init.minMatches — the
    # orbit's consecutive-frame init matching tops out at ~95 matches at
    # this motion, under the reference-strength 100 gate tuned for real
    # imagery's >400 corners; measured via OSLAM_INIT_DEBUG).
    cfg_mono = TrackerConfig(
        sensor="mono", n_features=2000, min_init_features=200,
        min_init_matches=60,
        map_cfg=MapConfig(k_max=24, n_feat=2000, l_max=8000, d_max=8),
        fps=30)
    tracker_mono = AutoTracker(cfg_mono, AutoTrackerConfig(
        traj_capacity=8 * n_frames, batch_frames=4))
    for img, _depth in frames:
        tracker_mono.process_mono(img)
    tracker_mono.sync()
    mono_rates = []
    for _ in range(2):
        t0 = time.perf_counter()
        for img, _depth in frames:
            tracker_mono.process_mono(img)
        tracker_mono.sync()
        mono_rates.append(n_frames / (time.perf_counter() - t0))

    # --- validation readbacks (first device->host transfers) ---
    out = tracker.finalize()
    ok = (out["initialized"] and out["lost_at"] < 0
          and int(out["valid"][n_frames:].sum()) == 3 * n_frames
          and out["n_keyframes"] >= 3)
    if not ok:
        print(json.dumps({
            "metric": "tracking_fps", "value": 0.0, "unit": "frames/s",
            "vs_baseline": 0.0,
            "error": {
                "initialized": bool(out["initialized"]),
                "lost_at": out["lost_at"],
                "valid_timed": int(out["valid"][n_frames:].sum()),
                "n_keyframes": out["n_keyframes"],
            }}))
        sys.exit(1)
    # sub-benchmark validation failures are LOUD: a
    # failed figure prints to stderr and lands in the JSON's "errors"
    # field instead of silently vanishing from "extra".
    errors = {}

    def check(name, tr, value):
        o = tr.finalize()
        if o["initialized"] and o["lost_at"] < 0:
            extra[name] = value
        else:
            errors[name] = {"initialized": bool(o["initialized"]),
                            "lost_at": int(o["lost_at"]),
                            "n_keyframes": int(o["n_keyframes"])}
            print(f"bench: {name} validation FAILED: {errors[name]}",
                  file=sys.stderr)

    check("map_building_fps", tracker2, round(n_frames / dt_build, 2))
    check("stereo_fps", tracker_st, round(float(np.median(st_rates)), 2))
    check("stereo_kitti_fps", tracker_kt,
          round(float(np.median(kt_rates)), 2))
    check("mono_fps", tracker_mono,
          round(float(np.median(mono_rates)), 2))

    result = {
        "metric": "tracking_fps",
        "value": round(fps, 2),
        "unit": "frames/s",
        "vs_baseline": round(fps / BASELINE_FPS, 3),
        "extra": extra,
    }
    if errors:
        result["errors"] = errors
    print(json.dumps(result))


if __name__ == "__main__":
    main()
