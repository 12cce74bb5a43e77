#!/usr/bin/env python
"""Distributed BA scaling measurement (SURVEY §2.5 P7, BASELINE.md >=70%
scaling-efficiency target).

Runs the landmark-sharded Schur BA (parallel.dist_ba) at realistic shapes
(default P=64 poses, L=50k landmarks, D=8 observation slots) over meshes of
1/2/4/8 devices and reports BA iterations/s per mesh size plus scaling
efficiency vs the 1-device rate.

On the default virtual CPU mesh (--xla_force_host_platform_device_count)
all "devices" share the same host cores, so the numbers reflect the
sharding/collective OVERHEAD (partitioning, psum scheduling), not a
speedup: the per-device work shrinks as 1/N while the total core budget
is constant. Run it with JAX_PLATFORMS=cuda on a multi-GPU host to time
a real mesh.

Usage:
  JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \
      python scripts/bench_dist_ba.py [--poses 64] [--landmarks 50000]

Prints one line per mesh size and a JSON summary line.
"""
import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import numpy as np  # noqa: E402
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import Mesh  # noqa: E402


def build_problem(P, L, D, seed=0):
    from orb_slam2_with_comment_tpu.geometry import se3
    from orb_slam2_with_comment_tpu.optim.ba import BAProblem
    rng = np.random.default_rng(seed)
    X = rng.uniform([-5, -5, 3], [5, 5, 15], size=(L, 3)).astype(np.float32)
    R = np.stack([np.asarray(se3.exp_so3(jnp.asarray(
        rng.normal(size=3) * 0.05).astype(jnp.float32))) for _ in range(P)])
    t = (rng.normal(size=(P, 3)) * 0.3).astype(np.float32)
    obs_pose = rng.integers(0, P, size=(L, D)).astype(np.int32)
    Rp = R[obs_pose]
    tp = t[obs_pose]
    Xc = np.einsum("ldij,lj->ldi", Rp, X) + tp
    u = 500 * Xc[..., 0] / Xc[..., 2] + 320
    v = 500 * Xc[..., 1] / Xc[..., 2] + 240
    ur = u - 40.0 / Xc[..., 2]
    uvr = np.stack([u, v, ur], axis=-1).astype(np.float32)
    uvr[..., :2] += rng.normal(size=(L, D, 2)) * 0.5
    mono = rng.random((L, D)) < 0.5
    uvr[..., 2] = np.where(mono, -1.0, uvr[..., 2])
    fixed = np.zeros(P, bool)
    fixed[0] = True
    # noisy initialization
    Xn = X + rng.normal(size=(L, 3)).astype(np.float32) * 0.05
    tn = t + rng.normal(size=(P, 3)).astype(np.float32) * 0.03
    return BAProblem(
        jnp.asarray(R), jnp.asarray(tn), jnp.asarray(Xn),
        jnp.asarray(obs_pose), jnp.asarray(uvr),
        jnp.ones((L, D), jnp.float32), jnp.asarray(fixed),
        jnp.ones(L, bool))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--poses", type=int, default=64)
    ap.add_argument("--landmarks", type=int, default=50_000)
    ap.add_argument("--slots", type=int, default=8)
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()

    from orb_slam2_with_comment_tpu.optim.residuals import CamParams
    from orb_slam2_with_comment_tpu.parallel import dist_ba

    cam = CamParams(*[jnp.float32(x) for x in
                      (500.0, 500.0, 320.0, 240.0, 40.0)])
    prob = build_problem(args.poses, args.landmarks, args.slots)
    devs = jax.devices()
    rows = []
    t1 = None
    for n in (1, 2, 4, 8):
        if n > len(devs):
            break
        mesh = Mesh(np.array(devs[:n]), ("lm",))
        # warmup: compile + one step
        R, t, X, chi2 = dist_ba.ba_solve_sharded(
            cam, prob, mesh, iters=1)
        jax.block_until_ready(t)
        best = float("inf")
        for _ in range(args.reps):
            t0 = time.perf_counter()
            R, t, X, chi2 = dist_ba.ba_solve_sharded(
                cam, prob, mesh, iters=args.iters)
            jax.block_until_ready(t)
            best = min(best, (time.perf_counter() - t0) / args.iters)
        ips = 1.0 / best
        if t1 is None:
            t1 = best
        eff = t1 / best
        rows.append((n, best * 1e3, ips, eff))
        print(f"devices={n}: {best * 1e3:.1f} ms/iter, {ips:.2f} iters/s, "
              f"t(1)/t(N)={eff:.2f}")

    print(json.dumps({
        "metric": "dist_ba_iters_per_s",
        "device": {"platform": devs[0].platform,
                   "kind": devs[0].device_kind},
        "per_devices": {str(n): ips for n, _, ips, _ in rows},
    }))


if __name__ == "__main__":
    main()
