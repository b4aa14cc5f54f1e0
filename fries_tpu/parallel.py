"""Device-mesh orchestration: shard_map wiring for the hash-distributed
solution vector.

The reference's MPI runtime (SURVEY.md section 2's "1-D data parallelism over
vector indices via hash sharding") maps to a 1-D ``jax.sharding.Mesh``:

  * arena rows are sharded over the mesh axis (each chip holds a sorted,
    capacity-padded sub-arena of the determinants it owns by hash);
  * all collectives (psum reductions, the all-to-all spawn exchange, shard-
    prefix norms for the shared systematic grid) happen inside one
    ``shard_map``-wrapped jitted step;
  * scalar state (shift, PRNG key, iteration counter) is replicated - every
    shard computes identical updates from psum'd quantities, replacing the
    reference's rank-0 broadcasts.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from fries_tpu import dets
from fries_tpu.drivers import power
from fries_tpu.runtime import arena as ar
from fries_tpu.runtime import shard as sh

AXIS = "shards"


def make_mesh(n_devices: int | None = None) -> Mesh:
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.asarray(devs), (AXIS,))


def arena_spec(axis: str = AXIS) -> ar.Arena:
    return ar.Arena(keys=P(axis), vals=P(None, axis), n_used=P(axis))


def state_spec(axis: str = AXIS) -> power.PowerState:
    return power.PowerState(
        arena=arena_spec(axis), en_shift=P(), last_norm=P(), key=P(), iterat=P()
    )


def metrics_spec():
    return {
        "proj_num": P(),
        "proj_den": P(),
        "norm": P(),
        "shift": P(),
        "n_dets": P(),
        "n_ini": P(),
        "nkept": P(),
        "nnonz": P(),
        "sgn_coh": P(),
        "overflow": P(),
    }


def distribute_rows(keys, vals, n_shards: int, capacity: int):
    """Host-side: route initial rows to their owning shards and build the
    stacked global arena arrays ((n*C, W), vals (R, n*C)).

    Each shard block is sorted and sentinel-padded, matching the layout the
    sharded step maintains.
    """
    keys = np.asarray(keys)
    vals = np.asarray(vals)
    w = keys.shape[1]
    r = vals.shape[0]
    shard_ids = np.asarray(sh.shard_of_words(jnp.asarray(keys), n_shards))

    g_keys = np.tile(np.asarray(dets.invalid_det(w)), (n_shards * capacity, 1))
    g_vals = np.zeros((r, n_shards * capacity), vals.dtype)
    g_nused = np.zeros((n_shards,), np.int32)

    for s in range(n_shards):
        rows = np.where(shard_ids == s)[0]
        assert len(rows) <= capacity, "initial rows exceed shard capacity"
        # sort rows lexicographically by key words (most significant last word)
        if len(rows):
            order = np.lexsort(tuple(keys[rows][:, wi] for wi in range(w)))
            rows = rows[order]
        base = s * capacity
        for j, ri in enumerate(rows):
            g_keys[base + j] = keys[ri]
            g_vals[:, base + j] = vals[:, ri]
        g_nused[s] = len(rows)

    return jnp.asarray(g_keys), jnp.asarray(g_vals), jnp.asarray(g_nused)


def sharded_state(keys, vals, n_shards, capacity, seed) -> power.PowerState:
    gk, gv, gn = distribute_rows(keys, vals, n_shards, capacity)
    a = ar.Arena(keys=gk, vals=gv, n_used=gn)
    return power.PowerState(
        arena=a,
        en_shift=jnp.float64(0.0),
        last_norm=jnp.float64(0.0),
        key=jax.random.key(seed),
        iterat=jnp.int32(0),
    )


def _placer(mesh: Mesh, spec):
    """Puts a state on the mesh with the layout the sharded step returns it
    in, so that the first call compiles the same program as every later one
    (a state built on one device would otherwise compile twice)."""
    shardings = jax.tree.map(lambda p: NamedSharding(mesh, p), spec,
                             is_leaf=lambda x: isinstance(x, P))
    return lambda state: jax.device_put(state, shardings)


def shard_stepper(step, run_steps, mesh: Mesh, axis: str = AXIS):
    """Wrap the jitted (step, run_steps) in shard_map over the mesh."""
    sspec = state_spec(axis)
    place = _placer(mesh, sspec)
    repl = P()
    est_specs = (repl, repl, repl, repl, repl)  # num/den keys+vals, ref_key

    step_fn = jax.jit(
        jax.shard_map(
            step,
            mesh=mesh,
            in_specs=(sspec,) + est_specs,
            out_specs=(sspec, metrics_spec()),
            check_vma=False,
        )
    )

    def sharded_step(state, *args):
        return step_fn(place(state), *args)

    # cache the jitted scan wrappers by (n_iter, protected?): rebuilding the
    # shard_map closure per call defeats jax.jit's cache (a fresh lambda is a
    # new cache key) and recompiled the WHOLE program on every invocation -
    # the bench_matrix subsp rung measured 67 s/iter that was ~99% recompile
    _cache: dict = {}

    def _get(n_iter: int, with_prot: bool):
        key = (n_iter, with_prot)
        if key not in _cache:
            if with_prot:
                _cache[key] = jax.jit(
                    jax.shard_map(
                        lambda s, nk, nv, dk, dv, rk, pk: run_steps(
                            s, nk, nv, dk, dv, rk, n_iter, pk
                        ),
                        mesh=mesh,
                        in_specs=(sspec,) + est_specs + (repl,),
                        out_specs=(sspec, metrics_spec()),
                        check_vma=False,
                    )
                )
            else:
                _cache[key] = jax.jit(
                    jax.shard_map(
                        lambda s, nk, nv, dk, dv, rk: run_steps(
                            s, nk, nv, dk, dv, rk, n_iter
                        ),
                        mesh=mesh,
                        in_specs=(sspec,) + est_specs,
                        out_specs=(sspec, metrics_spec()),
                        check_vma=False,
                    )
                )
        return _cache[key]

    def sharded_run(state, num_keys, num_vals, den_keys, den_vals, ref_key,
                    n_iter: int, protected=None):
        state = place(state)
        if protected is not None:
            # semistochastic: the dense subspace is replicated; each shard
            # protects the members it owns (frisys_mol.cpp:347-401 runs the
            # same block on every MPI rank)
            return _get(n_iter, True)(
                state, num_keys, num_vals, den_keys, den_vals, ref_key,
                protected)
        return _get(n_iter, False)(
            state, num_keys, num_vals, den_keys, den_vals, ref_key)

    return sharded_step, sharded_run


def shard_subspace(step, run_steps, mesh: Mesh, axis: str = AXIS):
    """shard_map wiring for the multi-state subspace driver (BASELINE.md:
    hash-sharded subsp_mol)."""
    from fries_tpu.drivers import subspace as ss

    sspec = ss.SubspaceState(
        arena=arena_spec(axis), norm_factors=P(), last_norms=P(),
        key=P(), iterat=P(),
    )
    mspec = {
        "h_mat": P(), "d_mat": P(), "norms": P(), "norm_factors": P(),
        "n_ini": P(), "n_dets": P(), "overflow": P(),
    }
    place = _placer(mesh, sspec)
    step_fn = jax.jit(
        jax.shard_map(
            step, mesh=mesh, in_specs=(sspec,), out_specs=(sspec, mspec),
            check_vma=False,
        )
    )

    def sharded_step(state):
        return step_fn(place(state))

    _cache: dict = {}

    def sharded_run(state, n_iter: int):
        # cached per n_iter - a fresh shard_map lambda per call is a new
        # jit cache key, i.e. a full recompile every invocation
        if n_iter not in _cache:
            _cache[n_iter] = jax.jit(
                jax.shard_map(
                    lambda s: run_steps(s, n_iter),
                    mesh=mesh, in_specs=(sspec,), out_specs=(sspec, mspec),
                    check_vma=False,
                )
            )
        return _cache[n_iter](place(state))

    return sharded_step, sharded_run
