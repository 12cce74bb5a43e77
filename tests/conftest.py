"""Test config: the suite runs on the CPU with an 8-device virtual mesh so
sharding tests run without accelerators (SURVEY.md §4d).

An explicitly set JAX_PLATFORMS is kept, which is how the tests marked
``chip`` run on a GPU (``JAX_PLATFORMS=cuda,cpu pytest -m chip tests/``);
they skip, from inside the ``gpu`` fixture, wherever JAX finds no GPU.
Collection is the same either way.
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

# the environment alone is not enough once jax has been imported
jax.config.update("jax_platforms", os.environ["JAX_PLATFORMS"])

# Persistent compilation cache: the suite compiles the same pipeline
# programs in several files (and reruns of the suite reuse them), so
# cache XLA executables across processes.
from orb_slam2_with_comment_tpu.runtime import enable_compilation_cache  # noqa: E402

enable_compilation_cache()
# NOTE: x64 is intentionally NOT enabled: tests run at the float32
# precision the device path uses, so numerical robustness issues surface
# in CI.

import gc  # noqa: E402

import pytest  # noqa: E402


@pytest.fixture
def gpu():
    """The first GPU; skips the test where JAX finds none."""
    devs = [d for d in jax.devices() if d.platform == "gpu"]
    if not devs:
        pytest.skip("needs a GPU (run with JAX_PLATFORMS=cuda,cpu on a card)")
    return devs[0]


@pytest.fixture(autouse=True, scope="module")
def _drop_compiled_executables_between_modules():
    """The suite compiles hundreds of distinct XLA CPU executables; kept
    alive in one process they accumulate until the compiler segfaults
    (observed at ~44% of the suite, round 2 and 3). Dropping the
    in-memory jit caches after each module bounds resident executables;
    re-used programs reload cheaply from the persistent compilation
    cache enabled above."""
    yield
    jax.clear_caches()
    gc.collect()


def pytest_collection_modifyitems(config, items):
    """Tier the suite: files that drive full pipelines (renders + many
    XLA compiles) are marked slow; the fast tier (-m 'not slow') is the
    per-commit gate. The FULL suite remains the default run."""
    slow_files = {
        "test_auto.py", "test_auto_loop.py", "test_lifecycle.py",
        "test_loop_host.py", "test_loop_scale.py",
        "test_mono_scale_loop.py", "test_multi_seq.py", "test_mono.py",
        "test_pipeline_e2e.py", "test_reloc.py",
        "test_distributed_launch.py", "test_stereo.py",
        "test_checkpoint_viz.py", "test_solvers.py",
    }
    for item in items:
        if item.fspath.basename in slow_files:
            item.add_marker(pytest.mark.slow)
