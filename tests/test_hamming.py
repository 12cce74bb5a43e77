"""Descriptor distance matrix (ops.hamming) against a numpy XOR/popcount
reference, across shapes and the extreme bit patterns."""
import numpy as np
import jax.numpy as jnp
import pytest

from chip_smoke import popcount_distance_np
from orb_slam2_with_comment_tpu.ops import hamming


def _case(name):
    rng = np.random.default_rng(7)

    def rand(n):
        return rng.integers(0, 2**32, (n, 8), dtype=np.uint32)

    if name == "extremes":
        zeros = np.zeros((1, 8), np.uint32)
        ones = np.full((1, 8), 0xFFFFFFFF, np.uint32)
        bit = zeros.copy()
        bit[0, 3] = 1 << 17
        d = np.concatenate([zeros, ones, bit])
        return d, d
    n1, n2 = map(int, name.split("x"))
    a, b = rand(n1), rand(n2)
    k = min(n1, n2) // 10
    b[:k] = a[:k]  # some zero distances
    return a, b


@pytest.mark.parametrize("name", ["1x1", "157x203", "1000x1000",
                                  "2000x1000", "extremes"])
def test_distance_matrix_matches_numpy_popcount(name):
    a, b = _case(name)
    got = np.asarray(hamming.distance_matrix(jnp.asarray(a), jnp.asarray(b)))
    assert got.dtype == np.int32 and got.shape == (len(a), len(b))
    np.testing.assert_array_equal(got, popcount_distance_np(a, b))


def test_extremes_values():
    a, b = _case("extremes")
    got = np.asarray(hamming.distance_matrix(jnp.asarray(a), jnp.asarray(b)))
    np.testing.assert_array_equal(
        got, [[0, 256, 1], [256, 0, 255], [1, 255, 0]])
