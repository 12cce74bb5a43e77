"""Compile-cache placement and the pure helpers of chip_smoke.py (the GPU
smoke test): its device gate, its last line, its trajectory validation."""
import json
import os

import jax
import numpy as np
import pytest

import chip_smoke
from orb_slam2_with_comment_tpu import runtime
from orb_slam2_with_comment_tpu.dataio.synthetic import lookout_trajectory

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def cache_config():
    """Restore the process-wide cache settings the test changes."""
    old = (jax.config.jax_compilation_cache_dir,
           jax.config.jax_persistent_cache_min_compile_time_secs)
    yield
    jax.config.update("jax_compilation_cache_dir", old[0])
    jax.config.update("jax_persistent_cache_min_compile_time_secs", old[1])


class TestCompilationCache:
    def test_env_var_is_honoured(self, cache_config, monkeypatch, tmp_path):
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
        jax.config.update("jax_compilation_cache_dir", str(tmp_path))
        assert runtime.enable_compilation_cache() == str(tmp_path)
        # nothing is set in code: JAX's own reading of the variable stands
        assert jax.config.jax_compilation_cache_dir == str(tmp_path)

    def test_default_is_fixed_in_checkout(self, cache_config, monkeypatch):
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        a = runtime.enable_compilation_cache()
        b = runtime.enable_compilation_cache()
        assert a == b == os.path.join(REPO, ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == a
        assert os.path.isdir(a)
        # listed in .gitignore, so no checkout ever commits it
        with open(os.path.join(REPO, ".gitignore")) as f:
            assert ".jax_cache/" in f.read().split()


class _Dev:
    def __init__(self, platform, kind="NVIDIA H100 80GB HBM3"):
        self.platform = platform
        self.device_kind = kind


class TestChipSmokeHelpers:
    def test_device_gate_refuses_cpu(self):
        with pytest.raises(SystemExit) as e:
            chip_smoke.require_gpu(jax.devices("cpu"))
        assert e.value.code not in (0, None)
        with pytest.raises(SystemExit):
            chip_smoke.require_gpu([])
        chip_smoke.require_gpu([_Dev("gpu")])  # a GPU passes

    def test_ok_line_is_the_contract(self):
        line = chip_smoke.ok_line([_Dev("gpu")] * 4)
        assert json.loads(line) == {"ok": True, "device": {
            "platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 4}}
        assert "\n" not in line

    @staticmethod
    def _run(n=60, drift=0.0, lost_from=None, loops=1):
        poses = lookout_trajectory(n, laps=0.5)
        R = np.stack([p[0] for p in poses])
        t = np.stack([p[1] for p in poses])
        est_t = t + drift * np.arange(n)[:, None] * np.array([1.0, 0, 0])
        valid = np.ones(n, bool)
        if lost_from is not None:
            valid[lost_from:] = False
        out = {"R": R, "t": est_t, "valid": valid, "initialized": True,
               "lost_at": -1 if lost_from is None else lost_from,
               "n_loops_closed": loops, "n_keyframes": 9}
        return out, R, t

    def test_validate_run_accepts_exact_trajectory(self):
        out, R, t = self._run()
        m, fails = chip_smoke.validate_run(out, R, t, min_tracked=0.99,
                                           ate_bound=1e-4, min_loops=1)
        assert fails == []
        assert m["ate_rmse_m"] < 1e-5
        assert m["never_lost"] and m["tracked_fraction"] == 1.0

    @pytest.mark.parametrize("case,kw,expect", [
        ("drift", dict(drift=0.01), "ATE"),
        ("lost", dict(lost_from=30), "lost"),
        ("loops", dict(loops=0), "loops"),
    ])
    def test_validate_run_rejects(self, case, kw, expect):
        out, R, t = self._run(**kw)
        _, fails = chip_smoke.validate_run(out, R, t, min_tracked=0.9,
                                           ate_bound=0.01, min_loops=1)
        assert any(expect in f for f in fails), fails

    def test_popcount_reference(self):
        d1 = np.array([[0] * 8, [0xFFFFFFFF] * 8, [1, 0, 0, 0, 0, 0, 0, 3]],
                      np.uint32)
        got = chip_smoke.popcount_distance_np(d1, d1)
        np.testing.assert_array_equal(
            got, [[0, 256, 3], [256, 0, 253], [3, 253, 0]])
