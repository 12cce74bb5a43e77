#!/usr/bin/env python
"""End-to-end smoke test of the tracking engine on one NVIDIA GPU.

Drives the main path once, through the entry points a user calls, at the
size of the deployments the engine targets, and checks what comes out:

  device   the JAX platform must be "gpu"; prints the card's name and
           power limit (nvidia-smi) and the JAX version.
  kernels  the card's results against a reference at real widths: the
           descriptor distance matrix against a numpy XOR/popcount, ORB
           extraction, motion-only pose optimisation and one local bundle
           adjustment against JAX's CPU backend in this process.
  rgbd     the TUM RGB-D deployment (640x480, 1000 features, 30 Hz, uint16
           depth at factor 5000) over the 500-frame two-lap revisit
           sequence, through AutoTracker.process_rgbd with loop closing;
           checks initialisation, losses, tracked fraction, loops closed
           and ATE against ground truth.
  stereo   60 frames of the KITTI stereo geometry (1241x376, 2000 features)
           through AutoTracker.process_stereo.
  mono     60 frames of monocular tracking (2000 features) through
           AutoTracker.process_mono.
  system   60 frames through System.track_rgbd and save_trajectory_tum.

With --four-cards it runs only the multi-card paths, each against its
one-card counterpart: four RGB-D sequences on a 4-card mesh
(MultiSeqTracker), landmark-sharded BA and the edge-sharded pose graph.

Every image is rendered in memory from --seed (numpy only). A failed
check exits nonzero and prints no ok line; exceptions are not caught.
The last line of standard output is one JSON object:

  {"ok": true, "device": {"platform": "gpu", "kind": "...", "count": N}}

Usage: python chip_smoke.py [--seed 1] [--four-cards]
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))

# ---- the deployments (sources in the phase docstrings) ----
TUM = dict(fx=500.0, fy=500.0, cx=320.0, cy=240.0, width=640, height=480)
KITTI = dict(fx=718.856, fy=718.856, cx=607.1928, cy=185.2157,
             width=1241, height=376)
KITTI_BF = 386.1448
TUM_DEPTH_FACTOR = 5000.0
# the revisit sequence's settings carry a 1.5% focal-length error against
# the render camera (scripts/make_fixture_dataset.py, cal_err=0.015)
CAL_ERR = 0.015

# ---- tolerances of the rgbd phase ----
# The bound on the 500-frame revisit run. An XLA:CPU run of this sequence
# gives 4.5 cm (3.3 cm through the PNG fixture, RESULTS.md); H100 runs
# gave 3.8 and 4.3 cm. A GPU sums in another order, so its trajectory is
# not bit-equal to the CPU's and its ATE moves by millimetres from run to
# run. A pipeline fault (a wrong sign, a lost scale, a dropped correction)
# costs decimetres. 8 cm keeps the two apart.
ATE_BOUND_M = 0.08
MIN_TRACKED_FRACTION = 0.99  # frame 0 initialises; every later frame tracks
MIN_LOOPS = 1  # the XLA:CPU run of this sequence closes one loop


def log(msg: str = "") -> None:
    print(msg, flush=True)


class Checks:
    """Collects named pass/fail checks; any failure fails the run."""

    def __init__(self):
        self.failed: list[str] = []

    def __call__(self, name: str, ok: bool, detail: str = "") -> bool:
        log(f"  [{'PASS' if ok else 'FAIL'}] {name}"
            + (f": {detail}" if detail else ""))
        if not ok:
            self.failed.append(name)
        return ok


# ---------------------------------------------------------------- helpers

def require_gpu(devices) -> None:
    """Refuse to run anywhere but a GPU: no CPU fallback."""
    platform = devices[0].platform if devices else "none"
    if platform != "gpu":
        raise SystemExit(
            f"chip_smoke: needs a GPU; JAX found platform {platform!r}")


def ok_line(devices) -> str:
    """The contract's last line, with the device as JAX reports it."""
    return json.dumps({"ok": True, "device": {
        "platform": devices[0].platform, "kind": devices[0].device_kind,
        "count": len(devices)}})


def card_name_and_power() -> str:
    """`name, power.limit` from nvidia-smi (a child process, off JAX)."""
    try:
        p = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable ({e})"
    return p.stdout.strip() or f"nvidia-smi rc={p.returncode}"


def popcount_distance_np(d1: np.ndarray, d2: np.ndarray) -> np.ndarray:
    """Reference Hamming matrix: XOR + per-byte popcount table, numpy."""
    table = np.array([bin(i).count("1") for i in range(256)], np.uint8)
    out = np.empty((d1.shape[0], d2.shape[0]), np.int32)
    for i in range(0, d1.shape[0], 256):
        x = d1[i:i + 256, None, :] ^ d2[None, :, :]
        out[i:i + 256] = table[x.view(np.uint8)].sum(-1, dtype=np.int32)
    return out


def validate_run(out: dict, gt_R: np.ndarray, gt_t: np.ndarray, *,
                 min_tracked: float, ate_bound: float | None = None,
                 min_loops: int = 0) -> tuple[dict, list[str]]:
    """Check an AutoTracker.finalize() result against ground truth.

    gt_R/gt_t are world->camera poses per frame. Returns (metrics,
    failures): initialised, never lost (every frame after the first
    tracked frame valid, none flagged lost), tracked fraction, loops
    closed and the ATE RMSE of the tracked camera centres.
    """
    from orb_slam2_with_comment_tpu.evaluation.ate import (
        ate_rmse, camera_centers)
    valid = np.asarray(out["valid"], bool)
    n = len(valid)
    first = int(np.argmax(valid)) if valid.any() else n
    m = {
        "initialized": bool(out["initialized"]),
        "lost_at": int(out["lost_at"]),
        "first_tracked": first,
        "tracked_fraction": float(valid.mean()) if n else 0.0,
        "loops_closed": int(out.get("n_loops_closed", 0)),
        "n_keyframes": int(out.get("n_keyframes", 0)),
    }
    m["never_lost"] = bool(m["lost_at"] < 0 and valid[first:].all())
    fails = []
    if not m["initialized"]:
        fails.append("not initialised")
    if not m["never_lost"]:
        fails.append("lost")
    if m["tracked_fraction"] < min_tracked:
        fails.append(f"tracked fraction {m['tracked_fraction']:.4f} "
                     f"< {min_tracked}")
    if m["loops_closed"] < min_loops:
        fails.append(f"{m['loops_closed']} loops < {min_loops}")
    if ate_bound is not None:
        if valid.sum() >= 3:
            est = camera_centers(np.asarray(out["R"])[valid],
                                 np.asarray(out["t"])[valid])
            gt = camera_centers(gt_R[:n][valid], gt_t[:n][valid])
            m["ate_rmse_m"] = ate_rmse(est, gt)
        else:
            m["ate_rmse_m"] = float("inf")
        if not m["ate_rmse_m"] <= ate_bound:
            fails.append(f"ATE {m['ate_rmse_m']:.4f} m > {ate_bound} m")
    return m, fails


def _render_chunk(args):
    seed, closed, poses, cam, stereo_b = args
    from orb_slam2_with_comment_tpu.dataio.synthetic import SyntheticWorld
    world = SyntheticWorld(seed=seed, closed=closed)
    out = []
    for R, t in poses:
        img, depth = world.render(R, t, **cam)
        img8 = np.clip(img, 0, 255).astype(np.uint8)
        if stereo_b:
            right, _ = world.render(
                R, np.asarray(t) - np.array([stereo_b, 0, 0], np.float32),
                **cam)
            out.append((img8, np.clip(right, 0, 255).astype(np.uint8)))
        else:
            d16 = np.clip(depth * TUM_DEPTH_FACTOR, 0, 65535)
            d16[depth <= 0] = 0  # invalid returns, TUM convention
            out.append((img8, d16.astype(np.uint16)))
    return out


def render_frames(seed, closed, poses, cam, stereo_b=0.0, workers=None):
    """Render (uint8 image, uint16 depth | uint8 right image) per pose in
    worker processes. The workers are spawned with JAX held to the CPU,
    so they never open the card, and with one BLAS thread each."""
    import multiprocessing as mp
    workers = workers or min(16, os.cpu_count() or 1)
    chunks = [poses[i::workers] for i in range(workers)]
    env = {"JAX_PLATFORMS": "cpu", "OMP_NUM_THREADS": "1",
           "OPENBLAS_NUM_THREADS": "1", "MKL_NUM_THREADS": "1"}
    old = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        with mp.get_context("spawn").Pool(workers) as pool:
            parts = pool.map(_render_chunk, [
                (seed, closed, c, cam, stereo_b) for c in chunks])
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    frames = [None] * len(poses)
    for i, part in enumerate(parts):
        frames[i::workers] = part
    return frames


def _timed(fn, *args):
    import jax
    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(*args))
    return out, time.perf_counter() - t0


# ----------------------------------------------------------------- phases

def phase_device():
    import jax
    devices = jax.devices()
    log("== device")
    require_gpu(devices)
    d = devices[0]
    log(f"  jax {jax.__version__}; platform={d.platform} "
        f"kind={d.device_kind!r} count={len(devices)}")
    log(f"  card: {card_name_and_power()}")
    return devices


def compare_features(g, c, tol_xy=1e-2):
    """Match GPU to CPU keypoints by (octave, position); return stats."""
    gv, cv = np.asarray(g.valid), np.asarray(c.valid)
    gxy, cxy = np.asarray(g.xy)[gv], np.asarray(c.xy)[cv]
    goct, coct = np.asarray(g.octave)[gv], np.asarray(c.octave)[cv]
    gang, cang = np.asarray(g.angle)[gv], np.asarray(c.angle)[cv]
    gdesc, cdesc = np.asarray(g.desc)[gv], np.asarray(c.desc)[cv]
    pairs = []
    for o in np.union1d(goct, coct):
        gi, ci = np.nonzero(goct == o)[0], np.nonzero(coct == o)[0]
        if len(gi) == 0 or len(ci) == 0:
            continue
        dist = np.abs(gxy[gi, None, :] - cxy[None, ci, :]).max(-1)
        j = dist.argmin(1)
        hit = dist[np.arange(len(gi)), j] <= tol_xy
        pairs += list(zip(gi[hit], ci[j[hit]]))
    n_max = max(int(gv.sum()), int(cv.sum()), 1)
    st = {"n_gpu": int(gv.sum()), "n_cpu": int(cv.sum()),
          "matched_frac": len(pairs) / n_max}
    if pairs:
        gi, ci = np.asarray(pairs).T
        da = np.abs(np.angle(np.exp(1j * (gang[gi] - cang[ci]))))
        bits = popcount_distance_np(gdesc[gi], cdesc[ci]).diagonal()
        st.update(angle_max_rad=float(da.max()),
                  angle_frac_gt_1e3=float((da > 1e-3).mean()),
                  desc_equal_frac=float((bits == 0).mean()),
                  desc_bits_mean=float(bits.mean()))
    return st


def ba_fixture(seed, P=24, L=8000, D=8, noise_px=0.5):
    """Numpy local-BA problem: P keyframes on a 2 m arc, L landmarks each
    seen by D consecutive keyframes (80% stereo), pose 0 fixed, perturbed
    starting point."""
    rng = np.random.default_rng(seed)
    fx = fy = 500.0
    cx, cy, bf = 320.0, 240.0, 40.0
    R = np.zeros((P, 3, 3), np.float32)
    t = np.zeros((P, 3), np.float32)
    for p in range(P):
        a = 0.4 * p / P
        c, s = np.cos(a), np.sin(a)
        R[p] = [[c, 0, s], [0, 1, 0], [-s, 0, c]]
        C = np.array([2.0 * p / P, 0.0, 0.0])
        t[p] = -R[p] @ C
    first = rng.integers(0, P - D + 1, L)
    obs_pose = (first[:, None] + np.arange(D)[None, :]).astype(np.int32)
    # landmarks in front of their first observer
    Rf, tf = R[first], t[first]
    Xc = np.stack([rng.uniform(-2, 2, L), rng.uniform(-1.5, 1.5, L),
                   rng.uniform(2, 6, L)], -1)
    X = np.einsum("lji,lj->li", Rf, Xc - tf).astype(np.float32)
    Xo = np.einsum("ldij,lj->ldi", R[obs_pose], X) + t[obs_pose]
    z = np.maximum(Xo[..., 2], 0.1)
    u = fx * Xo[..., 0] / z + cx
    v = fy * Xo[..., 1] / z + cy
    uvr = np.stack([u, v, u - bf / z], -1)
    uvr += rng.normal(0, noise_px, uvr.shape)
    mono = rng.random((L, D)) < 0.2
    uvr[..., 2] = np.where(mono, -1.0, uvr[..., 2])
    w = np.ones((L, D), np.float32)
    w[Xo[..., 2] < 0.2] = 0.0
    fixed = np.zeros(P, bool)
    fixed[0] = True
    t0 = t + rng.normal(0, 0.01, t.shape).astype(np.float32)
    t0[0] = t[0]
    X0 = X + rng.normal(0, 0.02, X.shape).astype(np.float32)
    cam = (fx, fy, cx, cy, bf)
    return cam, (R, t0, X0, obs_pose, uvr.astype(np.float32), w, fixed,
                 np.ones(L, bool))


def phase_kernels(devices, check: Checks, seed: int):
    import jax
    import jax.numpy as jnp
    from orb_slam2_with_comment_tpu.frontend import OrbExtractor
    from orb_slam2_with_comment_tpu.ops import hamming
    from orb_slam2_with_comment_tpu.optim import ba
    from orb_slam2_with_comment_tpu.optim.residuals import CamParams
    from orb_slam2_with_comment_tpu.dataio.synthetic import (
        SyntheticWorld, orbit_trajectory)
    cpu = jax.devices("cpu")[0]
    log("== kernels (card vs reference)")

    # -- descriptor distance: integer arithmetic, must be bit-exact
    rng = np.random.default_rng(seed)
    for n in (1000, 2000):
        d1 = rng.integers(0, 2**32, (n, 8), dtype=np.uint32)
        d2 = rng.integers(0, 2**32, (n, 8), dtype=np.uint32)
        d2[: n // 10] = d1[: n // 10]  # zero distances
        d2[n // 10] = ~d1[n // 10]     # distance 256
        out, dt = _timed(hamming.distance_matrix, d1, d2)
        ref = popcount_distance_np(d1, d2)
        check(f"hamming.distance_matrix {n}x{n}",
              np.array_equal(np.asarray(out), ref),
              f"bit-exact vs numpy popcount (integer); first call {dt:.2f}s")

    # -- ORB extraction at both deployment geometries. Integer FAST
    # scores and the one-hot patch GEMMs (HIGHEST) are exact; keypoint
    # positions must agree to 0.01 px, orientations to 1e-3 rad, and the
    # descriptor bits of a keypoint flip only where a rotated BRIEF offset
    # lands within float rounding of a pixel boundary.
    world = SyntheticWorld(seed=seed)
    R0, t0 = orbit_trajectory(2)[0]
    for cam, nf in ((TUM, 1000), (KITTI, 2000)):
        img = np.clip(world.render(R0, t0, **cam)[0], 0, 255).astype(
            np.uint8).astype(np.float32)
        ext = OrbExtractor(n_features=nf)
        fn = jax.jit(ext._extract)
        g, dt = _timed(fn, img)
        c = jax.jit(ext._extract)(jax.device_put(img, cpu))
        st = compare_features(g, c)
        ok = (st["matched_frac"] >= 0.99
              and st.get("angle_frac_gt_1e3", 1.0) <= 0.01
              and st.get("desc_equal_frac", 0.0) >= 0.99)
        check(f"OrbExtractor._extract {cam['width']}x{cam['height']}",
              ok, f"{st}; tol: matched>=0.99 (0.01 px), angle>1e-3 rad "
                  f"<=1%, identical descriptors>=99%; compile+run "
                  f"{dt:.1f}s")

    # -- motion-only pose optimisation on the graft-entry fixture
    sys.path.insert(0, REPO)
    import __graft_entry__
    fn, args = __graft_entry__.entry()
    fj = jax.jit(fn)
    g, dt = _timed(fj, *args)
    c = jax.jit(fn)(*jax.device_put(args, cpu))
    dR = float(np.abs(np.asarray(g[0]) - np.asarray(c[0])).max())
    dtr = float(np.abs(np.asarray(g[1]) - np.asarray(c[1])).max())
    ninl = (int(g[2]), int(c[2]))
    check("pose_opt.optimize_pose (entry fixture)",
          dR <= 1e-4 and dtr <= 1e-4 and abs(ninl[0] - ninl[1]) <= 1,
          f"max|dR|={dR:.2e} max|dt|={dtr:.2e} inliers gpu/cpu={ninl}; "
          f"tol 1e-4 (f32 solves summed in another order), inliers +-1; "
          f"compile+run {dt:.1f}s")

    # -- one local BA at L=8000, D=8, P=24
    cam_t, arrs = ba_fixture(seed)
    cam = CamParams(*[jnp.float32(v) for v in cam_t])
    solve = jax.jit(lambda *a: ba.ba_solve(cam, ba.BAProblem(*a), iters=10))
    g, dt = _timed(solve, *arrs)
    c = jax.jit(lambda *a: ba.ba_solve(cam, ba.BAProblem(*a), iters=10))(
        *jax.device_put(arrs, cpu))
    chi0 = float(jax.jit(lambda *a: ba._eval_chi2(
        cam, ba.BAProblem(*a), a[0], a[1], a[2]).sum())(
        *jax.device_put(arrs, cpu)))
    cg, cc = float(g.chi2), float(c.chi2)
    rel = abs(cg - cc) / cc
    dtr = float(np.abs(np.asarray(g.t) - np.asarray(c.t)).max())
    check("ba.ba_solve L=8000 D=8 P=24",
          rel <= 1e-3 and dtr <= 1e-3 and cg < 0.1 * chi0,
          f"chi2 start {chi0:.1f} gpu {cg:.3f} cpu {cc:.3f} (rel "
          f"{rel:.2e}, tol 1e-3) max|dt|={dtr:.2e} m (tol 1e-3); "
          f"compile+run {dt:.1f}s")


def tum_revisit_config():
    """TUM RGB-D deployment sized as dataio/settings.py sizes a TUM-length
    sequence (expected_frames ~600: k_max=256, l_max=131072, d_max=12),
    with the revisit fixture's settings (Init.minFeatures 150,
    Init.minMatches 60, ThDepth 40, bf 40, 1.5% focal error)."""
    from orb_slam2_with_comment_tpu.mapstate.map import MapConfig
    from orb_slam2_with_comment_tpu.pipeline import TrackerConfig
    f = TUM["fx"] * (1 + CAL_ERR)
    return TrackerConfig(
        sensor="rgbd", fx=f, fy=f, cx=TUM["cx"], cy=TUM["cy"], bf=40.0,
        width=TUM["width"], height=TUM["height"], n_features=1000,
        th_depth=40.0, fps=30.0, min_init_features=150, min_init_matches=60,
        map_cfg=MapConfig(k_max=256, n_feat=1000, l_max=131072, d_max=12),
        depth_factor=1.0 / TUM_DEPTH_FACTOR)


def clip_config(sensor):
    """The 60-frame clips: KITTI-geometry stereo, monocular and RGB-D at
    TUM geometry, map capacity as dataio/settings.py sizes a 60-frame
    clip (k_max=64, l_max=32768, d_max=12)."""
    from orb_slam2_with_comment_tpu.mapstate.map import MapConfig
    from orb_slam2_with_comment_tpu.pipeline import TrackerConfig
    if sensor == "stereo":
        return TrackerConfig(
            sensor="stereo", n_features=2000, min_init_features=200,
            bf=KITTI_BF, fps=10.0, **KITTI,
            map_cfg=MapConfig(k_max=64, n_feat=2000, l_max=32768, d_max=12))
    if sensor == "mono":
        # Init.minMatches 60: the synthetic scene's corner density, as in
        # the fixture settings files (the reference's default is 100)
        return TrackerConfig(
            sensor="mono", n_features=2000, min_init_features=200,
            min_init_matches=60, fps=30.0, **TUM,
            map_cfg=MapConfig(k_max=64, n_feat=2000, l_max=32768, d_max=12))
    return TrackerConfig(
        n_features=1000, min_init_features=200, fps=30.0,
        depth_factor=1.0 / TUM_DEPTH_FACTOR, **TUM,
        map_cfg=MapConfig(k_max=64, n_feat=1000, l_max=32768, d_max=12))


def compile_auto_step(cfg, auto_cfg=None):
    """Trace and compile the AutoTracker step of cfg.sensor ahead of its
    first frame (the phases run this on worker threads, so the big
    programs compile side by side). A later tracker of the same
    configuration reuses the program (pipeline.auto's per-process step
    cache, then the persistent compilation cache). Returns (seconds,
    compiled)."""
    import jax
    from orb_slam2_with_comment_tpu.pipeline import AutoTracker
    t0 = time.perf_counter()
    tr = AutoTracker(cfg, auto_cfg)
    img = jax.ShapeDtypeStruct((cfg.height, cfg.width), np.uint8)
    fn, specs = {
        "rgbd": (tr._step, (img, jax.ShapeDtypeStruct(img.shape, np.uint16))),
        "stereo": (tr._step.stereo, (img, img)),
        "mono": (tr._step.mono, (img,)),
    }[cfg.sensor]
    compiled = fn.lower(tr.state, *specs).compile()
    return time.perf_counter() - t0, compiled


def render_sequences(seed, n_revisit=500, n_clip=60):
    """Every sequence of the one-card phases, rendered from the seed."""
    from orb_slam2_with_comment_tpu.dataio.synthetic import (
        lookout_trajectory, orbit_trajectory)
    t0 = time.perf_counter()
    revisit = lookout_trajectory(n_revisit, laps=2.0)
    orbit = orbit_trajectory(n_clip)
    seqs = {
        "revisit": render_frames(seed, True, revisit, TUM),
        "revisit_gt": (np.stack([p[0] for p in revisit]),
                       np.stack([p[1] for p in revisit])),
        "orbit": render_frames(seed, False, orbit, TUM),
        "stereo": render_frames(seed, False, orbit, KITTI,
                                stereo_b=KITTI_BF / KITTI["fx"]),
    }
    log(f"  rendered {n_revisit} + 2x{n_clip} frames in "
        f"{time.perf_counter() - t0:.1f}s")
    return seqs


def run_rgbd(cfg, frames, auto_cfg=None):
    """One pass of AutoTracker.process_rgbd over frames. Returns
    (finalize() result, seconds of the pass, seconds of the first frame)."""
    from orb_slam2_with_comment_tpu.pipeline import AutoTracker
    tr = AutoTracker(cfg, auto_cfg)
    t0 = time.perf_counter()
    tr.process_rgbd(*frames[0])
    tr.sync()
    t_first = time.perf_counter() - t0
    for img, depth in frames[1:]:
        tr.process_rgbd(img, depth)
    tr.sync()
    return tr.finalize(), time.perf_counter() - t0, t_first


def phase_rgbd(devices, check: Checks, seqs, compiled, wait_all):
    log("== rgbd (TUM RGB-D, 500-frame two-lap revisit, loop closing on)")
    t_compile, exe = compiled.result()
    mem = exe.memory_analysis()
    log(f"  rgbd step compiled in {t_compile:.1f}s (worker thread); "
        f"memory_analysis: args {mem.argument_size_in_bytes} B, outputs "
        f"{mem.output_size_in_bytes} B, temps {mem.temp_size_in_bytes} B, "
        f"code {mem.generated_code_size_in_bytes} B")
    frames, (gt_R, gt_t) = seqs["revisit"], seqs["revisit_gt"]
    cfg = tum_revisit_config()
    out, dt1, t_first = run_rgbd(cfg, frames)
    log(f"  first pass {dt1:.1f}s (first frame {t_first:.2f}s)")
    m, fails = validate_run(out, gt_R, gt_t,
                            min_tracked=MIN_TRACKED_FRACTION,
                            ate_bound=ATE_BOUND_M, min_loops=MIN_LOOPS)
    check("rgbd revisit run", not fails,
          f"{m}; bounds: tracked>={MIN_TRACKED_FRACTION}, loops>="
          f"{MIN_LOOPS}, ATE<={ATE_BOUND_M} m" + (f"; {fails}" if fails
                                                   else ""))
    wait_all()  # no compilation beside the timed pass
    out2, dt2, _ = run_rgbd(cfg, frames)
    m2, _ = validate_run(out2, gt_R, gt_t, min_tracked=0.0, ate_bound=1e9)
    stats = devices[0].memory_stats() or {}
    log(f"  second pass (fresh tracker, compiled step): "
        f"{len(frames) / dt2:.2f} frames/s on {card_name_and_power()}; "
        f"ATE {m2['ate_rmse_m']:.4f} m, loops {m2['loops_closed']} "
        f"(information, not a claim)")
    log(f"  peak_bytes_in_use {stats.get('peak_bytes_in_use')}")


def phase_clip(name, check: Checks, frames, compiled):
    """A 60-frame clip through AutoTracker.process_<name>: it must
    initialise and never be lost."""
    from orb_slam2_with_comment_tpu.pipeline import AutoTracker
    log(f"== {name}")
    t_compile, _ = compiled.result()
    tr = AutoTracker(clip_config(name))
    step = getattr(tr, f"process_{name}")
    t0 = time.perf_counter()
    for fr in frames:
        step(*fr)
    tr.sync()
    dt = time.perf_counter() - t0
    m, fails = validate_run(tr.finalize(), None, None, min_tracked=0.0)
    check(f"{name}: initialised and never lost", not fails,
          f"{m}; compiled in {t_compile:.1f}s (worker thread), then "
          f"{len(frames) / dt:.2f} frames/s incl. the first frame")


def phase_system(check: Checks, frames):
    from orb_slam2_with_comment_tpu import Sensor, System
    log("== system (README Quickstart: System.track_rgbd)")
    slam = System(clip_config("rgbd"), sensor=Sensor.RGBD)
    t0 = time.perf_counter()
    poses = []
    for k, (img, depth) in enumerate(frames):
        poses.append(slam.track_rgbd(img, depth, k / 30.0))
    slam.shutdown()
    dt = time.perf_counter() - t0
    got = [p is not None for p in poses]
    first = got.index(True) if any(got) else len(got)
    finite = all(np.isfinite(np.asarray(p)).all() for p in poses[first:]
                 if p is not None)
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "CameraTrajectory.txt")
        slam.save_trajectory_tum(path)
        lines = [ln for ln in open(path) if ln.strip()]
    check("System.track_rgbd: a pose for every frame after initialisation",
          first < len(got) and all(got[first:]) and finite,
          f"initialised at frame {first}, {sum(got)}/{len(got)} poses; "
          f"{dt:.1f}s incl. compilation")
    check("System.save_trajectory_tum", len(lines) >= len(got) - first,
          f"{len(lines)} lines")


# --------------------------------------------------------- four cards

def phase_four_cards(devices, check: Checks, seed: int, n_frames=120):
    """Multi-card paths on a flat 4-card mesh (NVLink joins all cards)."""
    if len(devices) < 4:
        raise SystemExit(f"--four-cards needs 4 GPUs, found {len(devices)}")
    multi_seq_vs_solo(devices[:4], check, seed, n_frames)
    dist_ba_vs_single(devices[:4], check, seed)
    pose_graph_vs_single(devices[:4], check, seed)


def multi_seq_vs_solo(devices, check: Checks, seed: int, n_frames: int):
    import jax
    from jax.sharding import Mesh
    from concurrent.futures import ThreadPoolExecutor
    from orb_slam2_with_comment_tpu.dataio.synthetic import orbit_trajectory
    from orb_slam2_with_comment_tpu.parallel.multi_seq import MultiSeqTracker
    from orb_slam2_with_comment_tpu.pipeline import (
        AutoTracker, AutoTrackerConfig)
    log(f"== multi_seq ({len(devices)} RGB-D sequences, one per card, vs "
        f"solo runs)")
    cfg = clip_config("rgbd")
    # 120-frame orbits close no loop: the loop-closing branch is left out
    # of both programs, which halves what the mesh path compiles
    auto_cfg = AutoTrackerConfig(traj_capacity=256, loop_closing=False)
    pool = ThreadPoolExecutor(1)
    solo_compiled = pool.submit(compile_auto_step, cfg, auto_cfg)
    seqs = []
    for i in range(len(devices)):
        poses = orbit_trajectory(n_frames, x_amp=0.25 + 0.05 * i)
        seqs.append((render_frames(seed + i, False, poses, TUM),
                     np.stack([p[0] for p in poses]),
                     np.stack([p[1] for p in poses])))
    mt = MultiSeqTracker(cfg, n_seq=len(devices),
                         mesh=Mesh(np.array(devices), ("seq",)),
                         auto_cfg=auto_cfg)
    t0 = time.perf_counter()
    for k in range(n_frames):
        mt.process_rgbd(np.stack([s[0][k][0] for s in seqs]),
                        np.stack([s[0][k][1] for s in seqs]))
    mt.sync()
    dt = time.perf_counter() - t0
    outs = mt.finalize()
    log(f"  {len(devices)} sequences x {n_frames} frames in {dt:.1f}s incl. "
        f"compilation")
    log(f"  solo step compiled in {solo_compiled.result()[0]:.1f}s "
        f"(worker thread)")
    pool.shutdown()
    for i, (frames, gt_R, gt_t) in enumerate(seqs):
        with jax.default_device(devices[0]):
            solo = AutoTracker(cfg, auto_cfg)
            for img, depth in frames:
                solo.process_rgbd(img, depth)
            o1 = solo.finalize()
        m4, f4 = validate_run(outs[i], gt_R, gt_t, min_tracked=0.99,
                              ate_bound=0.05)
        m1, _ = validate_run(o1, gt_R, gt_t, min_tracked=0.0, ate_bound=1e9)
        v = outs[i]["valid"] & o1["valid"]
        dpos = float(np.abs(outs[i]["t"][v] - o1["t"][v]).max()) \
            if v.any() else float("inf")
        check(f"multi_seq sequence {i} vs solo", not f4 and dpos <= 0.02,
              f"mesh ATE {m4.get('ate_rmse_m'):.4f} m, solo ATE "
              f"{m1['ate_rmse_m']:.4f} m, max|t_mesh - t_solo|={dpos:.2e} m "
              f"(tol 0.02 m: same program, sums in another order); {f4}")


def dist_ba_vs_single(devices, check: Checks, seed: int):
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh
    from orb_slam2_with_comment_tpu.optim import ba
    from orb_slam2_with_comment_tpu.optim.residuals import CamParams
    from orb_slam2_with_comment_tpu.parallel import dist_ba
    log(f"== dist_ba (landmark-sharded over {len(devices)} cards, P=64 "
        f"L=50000 D=8, vs one card)")
    cam_t, arrs = ba_fixture(seed, P=64, L=50000, D=8)
    cam = CamParams(*[jnp.float32(v) for v in cam_t])
    prob = ba.BAProblem(*[jnp.asarray(a) for a in arrs])
    with jax.default_device(devices[0]):
        single = jax.jit(lambda p: ba.ba_solve(cam, p, iters=5))(
            jax.device_put(prob, devices[0]))
    mesh = Mesh(np.array(devices), ("lm",))
    t0 = time.perf_counter()
    R4, t4, X4, _ = dist_ba.ba_solve_sharded(cam, prob, mesh, iters=5)
    chi4 = float(ba._eval_chi2(cam, prob, R4, t4, X4).sum())
    dt = time.perf_counter() - t0
    chi1 = float(single.chi2)
    chi0 = float(ba._eval_chi2(cam, prob, prob.R, prob.t, prob.X).sum())
    rel = abs(chi4 - chi1) / chi1
    dtr = float(np.abs(np.asarray(t4) - np.asarray(single.t)).max())
    # tol 1e-3: both take the same five damped steps (the one-card solve
    # rejects none of them on this fixture), summed in another order
    check("dist_ba.ba_solve_sharded vs ba.ba_solve", rel <= 1e-3
          and dtr <= 5e-3 and chi4 < 0.1 * chi0,
          f"chi2 start {chi0:.1f} sharded {chi4:.2f} single {chi1:.2f} "
          f"(rel {rel:.2e}, tol 1e-3) max|dt|={dtr:.2e} m (tol 5e-3); "
          f"{dt:.1f}s incl. compilation")


def pose_graph_vs_single(devices, check: Checks, seed: int):
    import jax
    from jax.sharding import Mesh
    from orb_slam2_with_comment_tpu.optim import pose_graph
    from orb_slam2_with_comment_tpu.parallel import dist_pose_graph
    log(f"== dist_pose_graph (edge-sharded over {len(devices)} cards, vs "
        f"one card)")
    pg = pose_graph_fixture(seed, N=256)
    mesh_e = Mesh(np.array(devices), ("edge",))
    t0 = time.perf_counter()
    r4 = dist_pose_graph.optimize_pose_graph_sharded(pg, mesh_e, iters=20)
    jax.block_until_ready(r4.t)
    dt = time.perf_counter() - t0
    with jax.default_device(devices[0]):
        r1 = jax.jit(lambda p: pose_graph.optimize_pose_graph(p, iters=20))(
            jax.device_put(pg, devices[0]))
    dtr = float(np.abs(np.asarray(r4.t) - np.asarray(r1.t)).max())
    # tol 1e-2 m: both solve the same Gauss-Newton steps, summed in
    # another order (default-precision products may run in TF32 on a
    # GPU); an unconverged or mis-sharded solve keeps the injected chain
    # drift, ~0.1 m
    check("optimize_pose_graph_sharded vs optimize_pose_graph",
          dtr <= 1e-2 and np.isfinite(float(r4.chi2)),
          f"max|dt|={dtr:.2e} m (tol 1e-2); chi2 sharded {float(r4.chi2):.3e}"
          f" single {float(r1.chi2):.3e}; {dt:.1f}s incl. compilation")


def pose_graph_fixture(seed, N=256):
    """Sim3 pose graph: a drifting chain of N keyframes with a loop edge
    every 8th vertex back to vertex 0's neighbourhood; edges padded to a
    multiple of 8 (the mesh shards them)."""
    import jax.numpy as jnp
    from orb_slam2_with_comment_tpu.geometry import se3, sim3
    from orb_slam2_with_comment_tpu.optim.pose_graph import PoseGraphProblem
    rng = np.random.default_rng(seed)
    xi = np.zeros((N, 6), np.float32)
    ang = 2 * np.pi * np.arange(N) / N
    xi[:, 0] = 3 * np.sin(ang)
    xi[:, 2] = 3 * np.cos(ang)
    xi[:, 4] = ang
    R_gt, t_gt = [np.asarray(a) for a in se3.exp_se3(jnp.asarray(xi))]
    e_i = list(range(N - 1)) + list(range(8, N, 8))
    e_j = list(range(1, N)) + [0] * len(range(8, N, 8))
    e_i, e_j = np.asarray(e_i, np.int32), np.asarray(e_j, np.int32)
    mR, mt, ms = sim3.compose(
        jnp.asarray(R_gt[e_j]), jnp.asarray(t_gt[e_j]), jnp.ones(len(e_i)),
        *sim3.inverse(jnp.asarray(R_gt[e_i]), jnp.asarray(t_gt[e_i]),
                      jnp.ones(len(e_i))))
    E = len(e_i)
    pad = (-E) % 8
    drift = np.cumsum(rng.normal(0, 0.01, (N, 3)), 0).astype(np.float32)
    drift -= drift[0]
    fixed = np.zeros(N, bool)
    fixed[0] = True
    cat = np.concatenate
    return PoseGraphProblem(
        jnp.asarray(R_gt), jnp.asarray(t_gt + drift), jnp.ones(N),
        jnp.asarray(cat([e_i, np.zeros(pad, np.int32)])),
        jnp.asarray(cat([e_j, np.zeros(pad, np.int32)])),
        jnp.asarray(cat([np.asarray(mR),
                         np.tile(np.eye(3, dtype=np.float32), (pad, 1, 1))])),
        jnp.asarray(cat([np.asarray(mt), np.zeros((pad, 3), np.float32)])),
        jnp.asarray(cat([np.asarray(ms), np.ones(pad, np.float32)])),
        jnp.asarray(cat([np.ones(E, bool), np.zeros(pad, bool)])),
        jnp.asarray(fixed))


# ------------------------------------------------------------------ main

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the 4-card mesh paths and their "
                         "one-card comparisons")
    args = ap.parse_args(argv)
    t_start = time.perf_counter()
    devices = phase_device()
    sys.path.insert(0, REPO)
    from orb_slam2_with_comment_tpu.runtime import enable_compilation_cache
    enable_compilation_cache()
    check = Checks()
    if args.four_cards:
        phase_four_cards(devices, check, args.seed)
    else:
        from concurrent.futures import ThreadPoolExecutor, wait
        with ThreadPoolExecutor(3) as pool:
            compiled = {
                "rgbd": pool.submit(compile_auto_step, tum_revisit_config()),
                "stereo": pool.submit(compile_auto_step, clip_config("stereo")),
                "mono": pool.submit(compile_auto_step, clip_config("mono")),
            }
            seqs = timed("render", render_sequences, args.seed)
            timed("kernels", phase_kernels, devices, check, args.seed)
            timed("system", phase_system, check, seqs["orbit"])
            timed("rgbd", phase_rgbd, devices, check, seqs,
                  compiled["rgbd"], lambda: wait(compiled.values()))
            timed("stereo", phase_clip, "stereo", check, seqs["stereo"],
                  compiled["stereo"])
            timed("mono", phase_clip, "mono", check,
                  [(img,) for img, _ in seqs["orbit"]], compiled["mono"])
    log(f"total {time.perf_counter() - t_start:.1f}s")
    if check.failed:
        log(f"FAILED: {check.failed}")
        return 1
    log(f"card: {card_name_and_power()}")
    print(ok_line(devices), flush=True)
    return 0


def timed(name, fn, *args):
    t0 = time.perf_counter()
    out = fn(*args)
    log(f"  phase {name}: {time.perf_counter() - t0:.1f}s")
    return out


if __name__ == "__main__":
    sys.exit(main())
