"""Multi-process jax.distributed launch (SURVEY §2.5 P7 / §4d).

Validates the real multi-process plumbing — jax.distributed.initialize,
cross-process device visibility, Gloo collectives, and the
landmark-sharded distributed BA running over the GLOBAL mesh — by
spawning scripts/launch_distributed.py with 2 processes x 2 CPU devices.
This is the runnable counterpart of BASELINE.md's N>=2-hosts axis (same
code, coordinator pointed at a real host 0 instead of localhost).
"""
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_two_process_distributed_ba():
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    # the launcher spawns its own children; drop this pytest process's
    # forced 8-device flag so the child count is what the launcher sets
    env["XLA_FLAGS"] = ""
    p = subprocess.run(
        [sys.executable, os.path.join(REPO, "scripts/launch_distributed.py"),
         "--nprocs", "2", "--devices-per-proc", "2"],
        capture_output=True, text=True, timeout=540, env=env)
    out = p.stdout + p.stderr
    assert p.returncode == 0, out[-2000:]
    assert out.count("DISTRIBUTED OK") == 2, out[-2000:]
