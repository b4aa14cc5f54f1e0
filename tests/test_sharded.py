"""Multi-chip sharding equivalence: with budgets large enough that
compression is the identity, the hash-sharded n-device run must produce
EXACTLY the same projected-energy trajectory as the single-chip run
(deterministic power iterations; collectives only reorder float sums, so
tolerances are float-roundoff level)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

import dense_fci
from fries_tpu import parallel
from fries_tpu.drivers import frifull, frisys, power
from fries_tpu.ops import molecule as mol


@pytest.fixture(scope="module")
def ham():
    rng = np.random.default_rng(41)
    n_orb, n_elec = 5, 4
    h, eris = dense_fci.random_integrals(rng, n_orb)
    return mol.MolecularHamiltonian(
        hcore=jnp.asarray(h), eris=jnp.asarray(eris),
        symm=jnp.zeros(n_orb, jnp.int32), n_orb=n_orb, n_elec=n_elec,
    )


def test_sharded_exact_run_matches_single(ham):
    n_iter = 30
    # single chip
    cfg1 = power.PowerConfig(eps=0.05, target_nonz=256, capacity=128)
    step1, run1, st1, aux1 = frifull.build(ham, cfg1, seed=0)
    st1, tr1 = run1(
        st1, aux1["num_keys"], aux1["num_vals"], aux1["den_keys"],
        aux1["den_vals"], aux1["ref_key"], n_iter,
    )

    # 8 virtual devices, capacity per shard smaller
    n_dev = 8
    mesh = parallel.make_mesh(n_dev)
    cfg8 = power.PowerConfig(
        eps=0.05, target_nonz=256, capacity=64,
        axis_name=parallel.AXIS, n_shards=n_dev, exchange_cap=512,
    )
    step8, run8, st8, aux8 = frifull.build_sharded(ham, cfg8, seed=0, mesh=mesh)
    st8, tr8 = run8(
        st8, aux8["num_keys"], aux8["num_vals"], aux8["den_keys"],
        aux8["den_vals"], aux8["ref_key"], n_iter,
    )

    assert not bool(np.asarray(tr1["overflow"]).any())
    assert not bool(np.asarray(tr8["overflow"]).any())
    e1 = np.asarray(tr1["proj_num"]) / np.asarray(tr1["proj_den"])
    e8 = np.asarray(tr8["proj_num"]) / np.asarray(tr8["proj_den"])
    np.testing.assert_allclose(e8, e1, rtol=1e-9, atol=1e-11)
    np.testing.assert_allclose(
        np.asarray(tr8["norm"]), np.asarray(tr1["norm"]), rtol=1e-9
    )
    np.testing.assert_array_equal(
        np.asarray(tr8["n_dets"]).reshape(-1), np.asarray(tr1["n_dets"]).reshape(-1)
    )


def test_sharded_frisys_runs_and_converges(ham):
    """Stochastic sharded frisys: sanity (finite, no overflow) + energy in the
    right region after a short run."""
    n_dev = 8
    mesh = parallel.make_mesh(n_dev)
    cfg = frisys.FrisysConfig(
        eps=0.05, vec_nonz=64, matr_samp=128, capacity=64, spawn_cap=256,
        target_norm=300.0, axis_name=parallel.AXIS, n_shards=n_dev,
        exchange_cap=128,
    )
    step, run, state, aux = frisys.build_sharded(ham, cfg, seed=1, mesh=mesh)
    state, traj = run(
        state, aux["num_keys"], aux["num_vals"], aux["den_keys"],
        aux["den_vals"], aux["ref_key"], 400,
    )
    assert not bool(np.asarray(traj["overflow"]).any())
    num = np.asarray(traj["proj_num"])[100:]
    den = np.asarray(traj["proj_den"])[100:]
    e_corr = num.sum() / den.sum()
    assert np.isfinite(e_corr)
    assert -2.0 < e_corr < 0.0  # correlation energy of this synthetic system


def test_sharded_subspace_matches_single(ham):
    """Hash-sharded subspace iteration (BASELINE.md required config): with
    exact H and identity-level budgets, the 8-shard run reproduces the
    single-chip h/d trajectories to roundoff."""
    from fries_tpu.drivers import subspace
    import dense_fci as dfci
    from scipy.linalg import eigh

    h = np.asarray(ham.hcore)
    eris = np.asarray(ham.eris)
    dense_h, basis = dfci.build_hamiltonian(h, eris, ham.n_orb, 2, 2)
    evals, evecs = eigh(dense_h)
    t_keys, t_vals = [], []
    for j in range(2):
        top = np.argsort(-np.abs(evecs[:, j]))[:10]
        t_keys.append(
            np.stack([dfci.mask_to_words(basis[i], ham.n_bits) for i in top])
        )
        t_vals.append(evecs[top, j])
    t_keys = jnp.asarray(np.stack(t_keys))
    t_vals = jnp.asarray(np.stack(t_vals))

    common = dict(
        eps=0.05, n_trial=2, vec_nonz=4096, matr_samp=4096, capacity=256,
        spawn_cap=4096, restart_int=10, exact_h=True, compress_mode="sys",
    )
    cfg1 = subspace.SubspaceConfig(**common)
    _, run1, st1, _ = subspace.build(ham, cfg1, t_keys, t_vals, seed=0)
    st1, tr1 = run1(st1, 15)

    n_dev = 8
    mesh = parallel.make_mesh(n_dev)
    cfg8 = subspace.SubspaceConfig(
        **{**common, "capacity": 96},
        axis_name=parallel.AXIS, n_shards=n_dev, exchange_cap=4096,
    )
    _, run8, st8, _ = subspace.build_sharded(
        ham, cfg8, t_keys, t_vals, seed=0, mesh=mesh
    )
    st8, tr8 = run8(st8, 15)

    assert not bool(np.asarray(tr1["overflow"]).any())
    assert not bool(np.asarray(tr8["overflow"]).any())
    np.testing.assert_allclose(
        np.asarray(tr8["h_mat"]), np.asarray(tr1["h_mat"]),
        rtol=1e-9, atol=1e-11,
    )
    np.testing.assert_allclose(
        np.asarray(tr8["d_mat"]), np.asarray(tr1["d_mat"]),
        rtol=1e-9, atol=1e-11,
    )


def test_sharded_fciqmc_runs(ham):
    """Hash-sharded FCIQMC: finite trajectory, no overflow, energy in range."""
    from fries_tpu.drivers import fciqmc

    n_dev = 8
    mesh = parallel.make_mesh(n_dev)
    cfg = fciqmc.FciqmcConfig(
        eps=0.02, target_walkers=400.0, capacity=64, attempt_cap=512,
        distribution="NU", axis_name=parallel.AXIS, n_shards=n_dev,
        exchange_cap=256,
    )
    step, run, state, aux = fciqmc.build_sharded(
        ham, cfg, seed=2, mesh=mesh, init_walkers=80.0
    )
    state, traj = run(
        state, aux["num_keys"], aux["num_vals"], aux["den_keys"],
        aux["den_vals"], aux["ref_key"], 300,
    )
    assert not bool(np.asarray(traj["overflow"]).any())
    num = np.asarray(traj["proj_num"])[100:]
    den = np.asarray(traj["proj_den"])[100:]
    e = num.sum() / den.sum()
    assert np.isfinite(e) and -2.0 < e < 0.0


def test_sharded_observables_matches_single(ham):
    """Hash-sharded replica observable estimator: exact evolution, so the
    8-shard trajectory must match single-chip to roundoff."""
    from fries_tpu.drivers import observables

    common = dict(
        eps=0.05, target_nonz=4096, obs_des=0, obs_cre=3,
        burn_in=3, n_obs=4, btw_obs=4, replica=True,
    )
    cfg1 = observables.ObservablesConfig(capacity=256, **common)
    _, run1, st1, _ = observables.build(ham, cfg1, seed=0)
    st1, tr1 = run1(st1, 12)

    n_dev = 8
    mesh = parallel.make_mesh(n_dev)
    cfg8 = observables.ObservablesConfig(
        capacity=96, axis_name=parallel.AXIS, n_shards=n_dev,
        exchange_cap=4096, **common,
    )
    _, run8, st8, _ = observables.build_sharded(ham, cfg8, seed=0, mesh=mesh)
    st8, tr8 = run8(st8, 12)

    assert not bool(np.asarray(tr1["overflow"]).any())
    assert not bool(np.asarray(tr8["overflow"]).any())
    np.testing.assert_allclose(
        np.asarray(tr8["obs_num"]), np.asarray(tr1["obs_num"]),
        rtol=1e-9, atol=1e-11,
    )
    np.testing.assert_allclose(
        np.asarray(tr8["obs_den"]), np.asarray(tr1["obs_den"]),
        rtol=1e-9, atol=1e-11,
    )


# ---------------------------------------------------------------------------
# exchange-path tests: the bucketed all-to-all against a host reference,
# repeated executions of one compiled exchange, the overflow flag, and a
# production-shape accumulate equivalence
# ---------------------------------------------------------------------------


def _compiled_exchange(n_shards, per_pair_cap):
    """shard.exchange inside shard_map on the virtual mesh, jitted once;
    rows are pre-bucketed per source shard as (n_shards, S_local, ...)."""
    from jax.sharding import PartitionSpec as P
    from fries_tpu.runtime import shard as sh

    mesh = parallel.make_mesh(n_shards)

    def body(k, a):
        k, a = k[0], a[0]
        tgt = sh.shard_of_words(k, n_shards)
        rec, ovf = sh.exchange({"keys": k, "amps": a}, tgt, n_shards,
                               per_pair_cap, parallel.AXIS)
        return (rec["keys"][None], rec["amps"][None],
                ovf.astype(jnp.int32)[None])

    smapped = jax.jit(jax.shard_map(
        body, mesh=mesh, in_specs=(P(parallel.AXIS), P(parallel.AXIS)),
        out_specs=(P(parallel.AXIS), P(parallel.AXIS), P(parallel.AXIS))))

    def run(keys, amps):
        rk, ra, ovf = smapped(keys, amps)
        return np.asarray(rk), np.asarray(ra), bool(np.asarray(ovf).any())
    return run


def _run_exchange(keys, amps, n_shards, per_pair_cap):
    return _compiled_exchange(n_shards, per_pair_cap)(keys, amps)


def _reference_exchange(keys, amps, n_shards):
    """Host reference: every live row summed into the shard its hash owns,
    as {shard: {key tuple: amp sum}}."""
    from fries_tpu import dets as d

    flat_k = keys.reshape(-1, keys.shape[-1])
    flat_a = amps.reshape(-1)
    live = ~np.asarray(d.is_invalid(jnp.asarray(flat_k)))
    owner = np.asarray(sh_targets(jnp.asarray(flat_k), n_shards))
    out = {s: {} for s in range(n_shards)}
    for row in np.where(live)[0]:
        key = tuple(int(x) for x in flat_k[row])
        bucket = out[int(owner[row])]
        bucket[key] = bucket.get(key, 0.0) + float(flat_a[row])
    return {s: {k: v for k, v in b.items() if v != 0.0}
            for s, b in out.items()}


def _merge_received(rk, ra, n_orb=12):
    """Aggregate (shard, rows, W) received spawns into a dict det->sum."""
    from fries_tpu import dets as d

    out = {}
    for s in range(rk.shape[0]):
        valid = ~np.asarray(d.is_invalid(jnp.asarray(rk[s])))
        for row in np.where(valid)[0]:
            key = tuple(int(x) for x in rk[s, row])
            out[key] = out.get(key, 0.0) + float(ra[s, row])
    return {k: v for k, v in out.items() if v != 0.0}


def _sparse_exchange_case(seed, n_shards=8, s_local=256, w=2):
    """Random 2-word keys with ~20% sentinel rows, (n_shards, s_local)."""
    from fries_tpu import dets as d

    rng = np.random.default_rng(seed)
    keys = rng.integers(0, 1 << 20, size=(n_shards, s_local, w)).astype(
        np.uint32)
    inv = rng.random((n_shards, s_local)) < 0.2
    keys[inv] = np.asarray(d.invalid_det(w))
    amps = rng.standard_normal((n_shards, s_local))
    amps[inv] = 0.0
    return keys, amps


def _per_shard(rk, ra):
    return {s: _merge_received(rk[s:s + 1], ra[s:s + 1])
            for s in range(rk.shape[0])}


def test_exchange_matches_reference():
    n_shards = 8
    keys, amps = _sparse_exchange_case(7, n_shards)
    rk, ra, ovf = _run_exchange(jnp.asarray(keys), jnp.asarray(amps),
                                n_shards, 128)
    assert not ovf
    want = _reference_exchange(keys, amps, n_shards)
    got = _per_shard(rk, ra)
    for s in range(n_shards):
        assert set(got[s]) == set(want[s])
        for k, v in want[s].items():
            assert abs(got[s][k] - v) <= 1e-12 * max(1.0, abs(v))


def test_exchange_repeated_execution():
    """One compiled exchange run several times on fresh inputs: every run
    must deliver the rows of its own input (a collective that is right only
    on its first execution fails here)."""
    n_shards = 8
    run = _compiled_exchange(n_shards, 128)
    for seed in (11, 12, 13):
        keys, amps = _sparse_exchange_case(seed, n_shards)
        rk, ra, ovf = run(jnp.asarray(keys), jnp.asarray(amps))
        assert not ovf
        assert _per_shard(rk, ra) == {
            s: {k: pytest.approx(v, rel=1e-12) for k, v in b.items()}
            for s, b in _reference_exchange(keys, amps, n_shards).items()}


def test_exchange_flags_bucket_overflow():
    """A (src, dst) bucket above per_pair_cap raises the psum'd flag on
    every shard."""
    n_shards = 8
    keys, amps = _sparse_exchange_case(7, n_shards)
    # 256 rows per source spread over 8 owners: ~26 live rows a bucket
    _, _, ovf = _run_exchange(jnp.asarray(keys), jnp.asarray(amps),
                              n_shards, 8)
    assert ovf


def test_exchange_production_shape():
    """~100k rows/shard through the bucketed all-to-all on the 8-device
    mesh, validated against a single-arena accumulate of the same rows
    (the bucket build and exchange actually stride at this size)."""
    from fries_tpu import dets as d
    from fries_tpu.runtime import arena as ar_

    rng = np.random.default_rng(3)
    n_shards, s_local, w = 8, 100_000, 2
    nbits = 24
    keys = rng.integers(0, 1 << nbits, size=(n_shards * s_local,)).astype(
        np.uint64)
    words = np.zeros((n_shards * s_local, w), np.uint32)
    words[:, 0] = keys & 0xFFFFFFFF
    amps = rng.standard_normal(n_shards * s_local)

    rk, ra, ovf = _run_exchange(
        jnp.asarray(words.reshape(n_shards, s_local, w)),
        jnp.asarray(amps.reshape(n_shards, s_local)), n_shards, 40_000)
    assert not ovf

    # every row must land on the shard its hash owns, exactly once
    total_received = 0
    for s in range(n_shards):
        valid = ~np.asarray(d.is_invalid(jnp.asarray(rk[s])))
        total_received += int(valid.sum())
        tgt = np.asarray(sh_targets(jnp.asarray(rk[s][valid])))
        assert (tgt == s).all()
    assert total_received == n_shards * s_local

    # accumulate per shard and compare against one global arena
    merged = {}
    for s in range(n_shards):
        valid = ~np.asarray(d.is_invalid(jnp.asarray(rk[s])))
        k = np.asarray(rk[s][valid])
        a = np.asarray(ra[s][valid])
        packed = k[:, 0].astype(np.int64)
        uq, inv_ = np.unique(packed, return_inverse=True)
        sums = np.bincount(inv_, weights=a)
        for key, v in zip(uq, sums):
            assert key not in merged  # shards own disjoint key sets
            merged[key] = v
    ref_uq, ref_inv = np.unique(words[:, 0].astype(np.int64),
                                return_inverse=True)
    ref_sums = np.bincount(ref_inv, weights=amps)
    assert set(merged) == set(ref_uq.tolist())
    got = np.asarray([merged[k] for k in ref_uq.tolist()])
    np.testing.assert_allclose(got, ref_sums, rtol=1e-12, atol=1e-12)


def sh_targets(k, n_shards=8):
    from fries_tpu.runtime import shard as sh
    return sh.shard_of_words(k, n_shards)
