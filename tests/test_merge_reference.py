"""Arena merge (``arena.accumulate`` / ``accumulate_multi`` / ``compact``)
against the independent dict reference in ``merge_ref.py``.

Randomized spawn streams cover duplicates, initiator gating on zero and
nonzero targets, sentinel (invalid) spawns, empty spawn sets, an empty
arena, overflow, the power step's two-row layout (gate row 0, destination
row 1, dead rows compacted first) and the subspace layout (per-spawn
destination rows).
"""

import numpy as np
import jax.numpy as jnp
import pytest

import merge_ref
from fries_tpu import dets
from fries_tpu.runtime import arena as arena_mod


def _mk_arena(capacity, n_words, keys_np, vals_np):
    a = arena_mod.make(capacity, n_words, 1)
    n = keys_np.shape[0]
    keys = a.keys.at[:n].set(jnp.asarray(keys_np, jnp.uint32))
    vals = a.vals.at[0, :n].set(jnp.asarray(vals_np))
    return arena_mod.Arena(keys=keys, vals=vals,
                           n_used=jnp.asarray([n], jnp.int32))


def _rand_case(rng, n_words, capacity, n_occ, n_spawn, n_universe,
               ini_frac=0.6, invalid_frac=0.1):
    # universe of unique dets as random non-sentinel words
    uni = rng.integers(0, 2**20, size=(n_universe, n_words), dtype=np.uint32)
    uni[:, -1] &= np.uint32(0x0FFFFFFF)  # never sentinel
    pk = np.asarray(dets.pack_key(jnp.asarray(uni))).astype(np.int64)
    _, uniq_idx = np.unique(pk, return_index=True)
    uni = uni[uniq_idx]
    occ_idx = rng.choice(uni.shape[0], size=min(n_occ, uni.shape[0]),
                         replace=False)
    okeys = uni[np.sort(occ_idx)]
    order = np.argsort(
        np.asarray(dets.pack_key(jnp.asarray(okeys))).astype(np.int64),
        kind="stable")
    okeys = okeys[order]
    ovals = rng.standard_normal(okeys.shape[0])
    ovals[rng.random(okeys.shape[0]) < 0.2] = 0.0  # some zero-val rows
    a = _mk_arena(capacity, n_words, okeys, ovals)

    sidx = rng.integers(0, uni.shape[0], n_spawn)
    skeys = uni[sidx].copy()
    inval = rng.random(n_spawn) < invalid_frac
    skeys[inval] = np.iinfo(np.uint32).max
    svals = rng.standard_normal(n_spawn) * 0.3
    sini = rng.random(n_spawn) < ini_frac
    return a, jnp.asarray(skeys), jnp.asarray(svals), jnp.asarray(sini)


def _with_rows(a, vals):
    return arena_mod.Arena(keys=a.keys, vals=jnp.asarray(vals),
                           n_used=a.n_used)


def _check(got, stats, ref, ref_overflow, ref_nonini):
    assert bool(stats["overflow"]) == ref_overflow
    assert int(stats["nonini_occ_add"]) == ref_nonini
    if ref_overflow:
        return
    dgot = merge_ref.arena_entries(got.keys, got.vals)
    assert set(dgot) == set(ref)
    for k, v in ref.items():
        np.testing.assert_allclose(dgot[k], v, rtol=1e-12, atol=1e-12,
                                   err_msg=str(k))
    assert int(got.n_used[0]) == len(ref)
    # valid rows form a sorted prefix (direct compare: np.diff would
    # overflow int64 across the valid/sentinel boundary)
    pk = np.asarray(dets.pack_key(got.keys)).astype(np.int64)
    assert np.all(pk[1:] >= pk[:-1])
    assert not np.asarray(dets.is_invalid(got.keys))[: len(ref)].any()


def _reference(a, sk, sv, si, **kw):
    entries = merge_ref.arena_entries(a.keys, a.vals)
    return merge_ref.merge(entries, a.n_vecs, a.capacity, np.asarray(sk),
                           np.asarray(sv), np.asarray(si), **kw)


@pytest.mark.parametrize("n_words", [1, 2])
@pytest.mark.parametrize("trial", range(3))
def test_accumulate_matches_reference(n_words, trial):
    rng = np.random.default_rng(100 * n_words + trial)
    a, sk, sv, si = _rand_case(
        rng, n_words, 1024, n_occ=400, n_spawn=700, n_universe=800)
    got, stats = arena_mod.accumulate(a, sk, sv, si)
    _check(got, stats, *_reference(a, sk, sv, si))


def test_empty_spawns():
    rng = np.random.default_rng(7)
    a, sk, sv, si = _rand_case(rng, 2, 128, n_occ=40, n_spawn=32,
                               n_universe=64, invalid_frac=1.0)
    got, stats = arena_mod.accumulate(a, sk, sv, si)
    ref, ovf, nonini = _reference(a, sk, sv, si)
    assert ref == pytest.approx(merge_ref.arena_entries(a.keys, a.vals))
    _check(got, stats, ref, ovf, nonini)


def test_empty_arena():
    rng = np.random.default_rng(8)
    a = arena_mod.make(128, 2, 1)
    sk = jnp.asarray(rng.integers(0, 2**16, size=(64, 2), dtype=np.uint32))
    sv = jnp.asarray(rng.standard_normal(64))
    si = jnp.ones((64,), bool)
    got, stats = arena_mod.accumulate(a, sk, sv, si)
    _check(got, stats, *_reference(a, sk, sv, si))


def test_overflow_flagged():
    rng = np.random.default_rng(9)
    a, sk, sv, si = _rand_case(rng, 2, 64, n_occ=60, n_spawn=200,
                               n_universe=400, ini_frac=1.0,
                               invalid_frac=0.0)
    _, stats = arena_mod.accumulate(a, sk, sv, si)
    _, ovf, _ = _reference(a, sk, sv, si)
    assert ovf
    assert bool(stats["overflow"])


@pytest.mark.parametrize("trial", range(2))
def test_two_row_power_layout(trial):
    """origin_row=0 gate / dest_row=1 accumulate - the power-step layout."""
    rng = np.random.default_rng(40 + trial)
    a1, sk, sv, si = _rand_case(
        rng, 2, 1024, n_occ=400, n_spawn=700, n_universe=800)
    a = _with_rows(a1, jnp.concatenate([a1.vals, jnp.zeros_like(a1.vals)]))
    got, stats = arena_mod.accumulate(a, sk, sv, si, origin_row=0,
                                      dest_row=1)
    _check(got, stats,
           *_reference(a, sk, sv, si, gate_row=0, dest_row=1))


@pytest.mark.parametrize("n_rows", [2, 3])
@pytest.mark.parametrize("trial", range(2))
def test_multi_row_matches_reference(n_rows, trial):
    """Per-spawn destination rows (subspace layout), each gated on its own
    row."""
    rng = np.random.default_rng(60 + 10 * n_rows + trial)
    capacity = 1024
    a1, sk, sv, si = _rand_case(
        rng, 2, capacity, n_occ=400, n_spawn=700, n_universe=800)
    n = int(np.asarray(a1.n_used)[0])
    vals = rng.standard_normal((n_rows, capacity))
    vals[rng.random((n_rows, capacity)) < 0.25] = 0.0
    vals[:, n:] = 0.0
    a = _with_rows(a1, vals)
    srows = jnp.asarray(rng.integers(0, n_rows, size=sv.shape[0]), jnp.int32)
    got, stats = arena_mod.accumulate_multi(a, sk, sv, srows, si)
    _check(got, stats,
           *_reference(a, sk, sv, si, spawn_rows=np.asarray(srows)))


@pytest.mark.parametrize("trial", range(2))
def test_compact_then_accumulate_matches_reference(trial):
    """The power step's merge: drop dead rows (zero gate value, not
    protected), then accumulate onto row 1."""
    rng = np.random.default_rng(80 + trial)
    capacity = 1024
    a1, sk, sv, si = _rand_case(
        rng, 2, capacity, n_occ=400, n_spawn=700, n_universe=800)
    a = _with_rows(a1, jnp.concatenate([a1.vals, jnp.zeros_like(a1.vals)]))
    keep = rng.random(capacity) < 0.05
    protected = {
        tuple(int(w) for w in np.asarray(a.keys)[i])
        for i in np.nonzero(keep)[0]}
    live = arena_mod.compact(a, (a.vals[0] != 0) | jnp.asarray(keep))
    got, stats = arena_mod.accumulate(live, sk, sv, si, origin_row=0,
                                      dest_row=1)

    entries = merge_ref.compact(
        merge_ref.arena_entries(a.keys, a.vals),
        lambda k, v: v[0] != 0 or k in protected)
    assert int(live.n_used[0]) == len(entries)
    ref = merge_ref.merge(entries, 2, capacity, np.asarray(sk),
                          np.asarray(sv), np.asarray(si), gate_row=0,
                          dest_row=1)
    _check(got, stats, *ref)
