"""Checks that need a GPU: the same computation on the GPU and on the host
CPU in one process.  Skipped where JAX has no GPU; run them on one with
``FRIES_TEST_ON_DEVICE=1 python -m pytest -m gpu tests/``."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from test_merge_reference import _rand_case
from fries_tpu.runtime import arena as arena_mod

pytestmark = pytest.mark.gpu


def test_f32_matmul_is_not_tf32(gpu_device):
    """The package pins HIGHEST matmul precision: a one-hot f32 product
    must select table entries bit-exactly on the GPU."""
    rng = np.random.default_rng(0)
    table = rng.standard_normal((26, 64)).astype(np.float32)
    idx = rng.integers(0, 26, 4096)
    onehot = jax.device_put(
        jax.nn.one_hot(jnp.asarray(idx), 26, dtype=jnp.float32), gpu_device)
    got = jnp.matmul(onehot, jax.device_put(table, gpu_device))
    np.testing.assert_array_equal(np.asarray(got), table[idx])


def test_accumulate_gpu_matches_cpu(gpu_device):
    rng = np.random.default_rng(1)
    case = _rand_case(rng, 2, 1 << 14, n_occ=6000, n_spawn=12000,
                      n_universe=16000)
    cpu = jax.devices("cpu")[0]
    g, gs = arena_mod.accumulate(*jax.device_put(case, gpu_device))
    c, cs = arena_mod.accumulate(*jax.device_put(case, cpu))
    np.testing.assert_array_equal(np.asarray(g.keys), np.asarray(c.keys))
    assert int(gs["nonini_occ_add"]) == int(cs["nonini_occ_add"])
    np.testing.assert_allclose(np.asarray(g.vals), np.asarray(c.vals),
                               rtol=1e-12, atol=1e-12)
