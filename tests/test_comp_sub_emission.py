"""Properties of ``compress.comp_sub``'s emission (the output-slot
inversion), over the regimes a spawner level meets: weighted parents only,
uniform and weighted parents mixed, sparse live parents, heavy parents
beside light ones, an output buffer smaller than the budget, a zero
vector, and unbiasedness over repetitions.

Every case checks: each emission is either a kept sub-element carrying its
exact mass or a grid hit carrying the common grid unit; kept masses sit at
or above that unit; the emitted mass equals the input mass; the number of
valid slots is ``min(total, out_size)``; and overflow is flagged exactly when
the budget exceeds ``out_size``.
"""

import numpy as np
import jax
import jax.numpy as jnp

from fries_tpu import compress


def _run(values, ndiv, w, mask, n_samp, rn, out_size):
    out = compress.comp_sub(
        jnp.asarray(values), jnp.asarray(ndiv, jnp.int32),
        jnp.asarray(w, jnp.float32), jnp.asarray(mask), n_samp,
        jnp.asarray(rn, jnp.float64), out_size)
    return [np.asarray(x) for x in out]


def _masses(values, ndiv, w, mask):
    """Per-(parent, sub) masses as comp_sub forms them: f32 products for
    weighted parents, values / ndiv for uniform ones."""
    values = np.asarray(values, np.float64)
    wm = np.where(mask, np.float32(values)[:, None] * np.float32(w), 0.0)
    wm = wm.astype(np.float32).astype(np.float64)
    wm[ndiv > 0] = 0.0
    return wm, np.where(ndiv > 0, values / np.maximum(ndiv, 1), 0.0)


def _check(values, ndiv, w, mask, n_samp, rn, out_size):
    ndiv = np.asarray(ndiv, np.int32)
    vals, parent, sub, n_out, overflow = _run(values, ndiv, w, mask, n_samp,
                                              rn, out_size)
    w_mass, u_mass = _masses(values, ndiv, w, mask)
    n_subs = int((w_mass > 1e-14 * (w_mass.sum() + (u_mass * ndiv).sum()))
                 .sum() + ndiv[np.asarray(values) > 0].sum())
    total = min(n_samp, n_subs)
    assert bool(overflow) == (total > out_size)
    assert int(n_out) == min(total, out_size)
    valid = parent >= 0
    assert valid.sum() == int(n_out)
    assert np.all(valid[: int(n_out)]) and not valid[int(n_out):].any()
    if int(n_out) == 0:
        assert np.all(vals == 0)
        return vals, parent, sub
    p, s, v = parent[valid], sub[valid], vals[valid]
    mass = np.where(ndiv[p] > 0, u_mass[p],
                    w_mass[p, np.minimum(s, w.shape[1] - 1)])
    # grid hits share one unit value; everything else is a kept emission
    uq, cnt = np.unique(v, return_counts=True)
    unit = uq[np.argmax(cnt)]
    kept = v != unit
    np.testing.assert_array_equal(v[kept], mass[kept])
    assert np.all(mass[kept] >= unit * (1 - 1e-12))
    assert len(set(zip(p[kept & (ndiv[p] == 0)].tolist(),
                       s[kept & (ndiv[p] == 0)].tolist()))) == int(
        (kept & (ndiv[p] == 0)).sum())
    if not overflow:
        np.testing.assert_allclose(
            v.sum(), w_mass.sum() + (u_mass * ndiv).sum(), rtol=1e-12)
    return vals, parent, sub


def _weighted(rng, n, k):
    w = rng.random((n, k)) + 1e-6
    return w / w.sum(1, keepdims=True)


def test_weighted_only():
    rng = np.random.default_rng(0)
    n, k = 3000, 14
    values = np.where(rng.random(n) < 0.7, rng.gamma(1.0, 1.0, n), 0.0)
    _check(values, np.zeros(n), _weighted(rng, n, k), np.ones((n, k), bool),
           1500, 0.3711, 2048)


def test_mixed_uniform_weighted():
    rng = np.random.default_rng(1)
    n, k = 2500, 9
    values = np.where(rng.random(n) < 0.8, rng.gamma(1.2, 1.0, n), 0.0)
    w = rng.random((n, k)) + 1e-6
    mask = rng.random((n, k)) < 0.8
    mask[:, 0] = True
    w = np.where(mask, w, 0.0)
    w /= w.sum(1, keepdims=True)
    ndiv = np.where(rng.random(n) < 0.4, rng.integers(1, 17, n), 0)
    _check(values, ndiv, w, mask, 3000, 0.0377, 4096)


def test_sparse_parents():
    """Few live parents far apart: the budget exceeds the live sub-elements,
    so every one of them is kept exactly."""
    rng = np.random.default_rng(2)
    n, k = 40_000, 5
    values = np.zeros(n)
    live = rng.choice(n, size=60, replace=False)
    values[live] = rng.gamma(2.0, 1.0, live.size) + 5.0
    vals, parent, _ = _check(values, np.zeros(n), _weighted(rng, n, k),
                             np.ones((n, k), bool), 700, 0.9113, 1024)
    assert set(parent[parent >= 0].tolist()) == set(live.tolist())


def test_heavy_parents_kept_light_parents_on_grid():
    """Two dominant parents: all their sub-elements are kept exactly, and
    the light parents share the rest of the budget as grid hits."""
    rng = np.random.default_rng(3)
    n, k = 512, 7
    values = rng.random(n) * 1e-3
    values[17] = 50.0
    values[400] = 30.0
    vals, parent, _ = _check(values, np.zeros(n), _weighted(rng, n, k),
                             np.ones((n, k), bool), 1800, 0.5521, 2048)
    hits = np.bincount(parent[parent >= 0], minlength=n)
    assert hits[17] == k and hits[400] == k
    light = (parent >= 0) & (parent != 17) & (parent != 400)
    assert light.sum() == 1800 - 2 * k
    uq, cnt = np.unique(vals[light], return_counts=True)
    assert cnt.max() > 1000  # grid hits at the common unit


def test_overflow_tail():
    """Budget above out_size: overflow flagged, the valid prefix fills the
    buffer and still obeys the kept/grid structure."""
    rng = np.random.default_rng(4)
    n, k = 600, 6
    _check(rng.gamma(1.0, 1.0, n), np.zeros(n), _weighted(rng, n, k),
           np.ones((n, k), bool), 900, 0.123, 256)


def test_zero_budget():
    rng = np.random.default_rng(5)
    n, k = 300, 4
    vals, parent, sub = _check(np.zeros(n), np.zeros(n), _weighted(rng, n, k),
                               np.ones((n, k), bool), 100, 0.7, 512)
    assert np.all(parent == -1) and np.all(sub == -1)


def test_unbiasedness_mapped_back():
    """E[mapped-back output] == input masses (CLT bound)."""
    rng = np.random.default_rng(6)
    n, k = 400, 8
    values = rng.gamma(1.0, 1.0, n) * (rng.random(n) < 0.9)
    w = _weighted(rng, n, k)
    mass = values[:, None] * w
    m = 1024
    n_rep = 64

    @jax.jit
    def one(rn):
        v, p, s, _, _ = compress.comp_sub(
            jnp.asarray(values), jnp.zeros(n, jnp.int32),
            jnp.asarray(w, jnp.float32), jnp.ones((n, k), bool),
            500, rn, m,
        )
        acc = jnp.zeros((n, k))
        ok = p >= 0
        return acc.at[jnp.where(ok, p, 0), jnp.where(ok, s, 0)].add(
            jnp.where(ok, v, 0.0))

    rns = jax.random.uniform(jax.random.PRNGKey(0), (n_rep,),
                             dtype=jnp.float64)
    tot = np.zeros((n, k))
    for i in range(n_rep):
        tot += np.asarray(one(rns[i]))
    resid = tot / n_rep - mass
    # systematic sampling at 500 samples over ~unit masses: the per-cell
    # spread is bounded by the grid unit; 5 sigma CLT envelope
    unit = mass.sum() / 500
    tol = 5 * unit / np.sqrt(n_rep)
    assert np.abs(resid).max() < max(tol, 1e-12), np.abs(resid).max()
