"""Kernels on the GPU against their references (numpy, or JAX's CPU backend
in the same process). Marked ``chip``: each skips, from inside the ``gpu``
fixture, where JAX finds no GPU. Run on a card with
``JAX_PLATFORMS=cuda,cpu python -m pytest tests/ -q -m chip``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

import chip_smoke
from orb_slam2_with_comment_tpu.ops import hamming

pytestmark = pytest.mark.chip


def test_distance_matrix_bit_exact_on_card(gpu):
    rng = np.random.default_rng(0)
    a = rng.integers(0, 2**32, (1000, 8), dtype=np.uint32)
    b = rng.integers(0, 2**32, (1000, 8), dtype=np.uint32)
    got = hamming.distance_matrix(jax.device_put(a, gpu),
                                  jax.device_put(b, gpu))
    np.testing.assert_array_equal(np.asarray(got),
                                  chip_smoke.popcount_distance_np(a, b))


def test_extractor_on_card_matches_cpu(gpu):
    from orb_slam2_with_comment_tpu.dataio.synthetic import (
        SyntheticWorld, orbit_trajectory)
    from orb_slam2_with_comment_tpu.frontend import OrbExtractor
    R, t = orbit_trajectory(2)[0]
    img = np.clip(SyntheticWorld(seed=1).render(R, t)[0], 0, 255).astype(
        np.uint8).astype(np.float32)
    ext = OrbExtractor(n_features=1000)
    g = jax.jit(ext._extract)(jax.device_put(img, gpu))
    c = jax.jit(ext._extract)(jax.device_put(img, jax.devices("cpu")[0]))
    st = chip_smoke.compare_features(g, c)
    assert st["matched_frac"] >= 0.99
    assert st["angle_frac_gt_1e3"] <= 0.01
    assert st["desc_equal_frac"] >= 0.99


def test_local_ba_on_card_matches_cpu(gpu):
    from orb_slam2_with_comment_tpu.optim import ba
    from orb_slam2_with_comment_tpu.optim.residuals import CamParams
    cam_t, arrs = chip_smoke.ba_fixture(1)
    cam = CamParams(*[jnp.float32(v) for v in cam_t])

    def solve(*a):
        return ba.ba_solve(cam, ba.BAProblem(*a), iters=10)

    g = jax.jit(solve)(*jax.device_put(arrs, gpu))
    c = jax.jit(solve)(*jax.device_put(arrs, jax.devices("cpu")[0]))
    assert abs(float(g.chi2) - float(c.chi2)) <= 1e-3 * float(c.chi2)
    np.testing.assert_allclose(np.asarray(g.t), np.asarray(c.t), atol=1e-3)
