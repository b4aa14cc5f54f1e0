"""``kernels.py`` helpers against plain numpy, including the convention the
samplers rely on: an index outside [0, size) - negative ones included -
reads 0 (``rank_place``: slots past the last True get the fill)."""

import numpy as np
import jax.numpy as jnp
import pytest

from fries_tpu import kernels


def _fill_gather(table, *idx):
    """numpy ``table[idx...]`` reading 0 wherever an index is out of range."""
    ok = np.ones(np.broadcast_shapes(*(i.shape for i in idx)), bool)
    safe = []
    for ax, i in enumerate(idx):
        ok &= (i >= 0) & (i < table.shape[ax])
        safe.append(np.clip(i, 0, table.shape[ax] - 1))
    out = table[tuple(safe)]
    return np.where(ok.reshape(ok.shape + (1,) * (out.ndim - ok.ndim)),
                    out, 0)


def _case_take_small(rng):
    t = rng.standard_normal(9)
    i = rng.integers(-3, 12, (50, 7))
    return kernels.take_small(jnp.asarray(t), jnp.asarray(i)), \
        _fill_gather(t, i)


def _case_take2_small(rng):
    t = rng.standard_normal((9, 6))
    i = rng.integers(-1, 10, (50,))
    j = rng.integers(-1, 7, (50, 4))
    # i indexes j's leading dim when j has more dims
    return kernels.take2_small(jnp.asarray(t), jnp.asarray(i),
                               jnp.asarray(j)), \
        _fill_gather(t, i[:, None], j)


def _case_take_rows_small(rng):
    t = rng.standard_normal((9, 5))
    i = rng.integers(-2, 11, (40, 3))
    return kernels.take_rows_small(jnp.asarray(t), jnp.asarray(i)), \
        _fill_gather(t, i)


def _case_take_along_small(rng):
    rows = rng.standard_normal((30, 1, 8))
    j = rng.integers(-2, 10, (30, 6))
    want = np.where((j >= 0) & (j < 8),
                    np.take_along_axis(np.broadcast_to(rows, (30, 6, 8)),
                                       np.clip(j, 0, 7)[..., None],
                                       axis=-1)[..., 0], 0)
    return kernels.take_along_small(jnp.asarray(rows), jnp.asarray(j)), want


def _case_count_matmul_f64(rng):
    c = rng.integers(0, 3, (40, 12)).astype(np.float64)
    t = rng.standard_normal((12, 12))
    got = np.asarray(kernels.count_matmul_f64(jnp.asarray(c), jnp.asarray(t)))
    # f64 matmul: rounding only, relative to the sum of absolute terms
    want = c @ t
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-14 * (np.abs(c) @ np.abs(t)).max())
    return got, got


def _case_row_cumsum(rng):
    mask = rng.random((40, 30)) < 0.4
    got = kernels.row_cumsum(jnp.asarray(mask))
    assert got.dtype == jnp.float32
    w = rng.random((40, 30)).astype(np.float32)
    np.testing.assert_allclose(np.asarray(kernels.row_cumsum(jnp.asarray(w))),
                               np.cumsum(w.astype(np.float64), axis=1),
                               rtol=1e-6)
    return got, np.cumsum(mask, axis=1).astype(np.float32)


def _case_rank_place(rng):
    mask = rng.random((40, 30)) < 0.3
    vals = rng.integers(0, 100, (40, 30)).astype(np.int32)
    want = np.full((40, 8), -1, np.int32)
    for r in range(40):
        hit = vals[r][mask[r]][:8]
        want[r, : len(hit)] = hit
    return kernels.rank_place(jnp.asarray(vals), jnp.asarray(mask), 8,
                              jnp.int32(-1)), want


@pytest.mark.parametrize("case", [
    _case_take_small, _case_take2_small, _case_take_rows_small,
    _case_take_along_small, _case_count_matmul_f64, _case_row_cumsum,
    _case_rank_place,
], ids=lambda f: f.__name__[len("_case_"):])
def test_helper_matches_plain_form(case):
    got, want = case(np.random.default_rng(0))
    got = np.asarray(got)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)
