"""Generic FRI power-iteration core shared by all single-vector drivers
(frifull_mol / frifull_hh exact multiplication, frisys stochastic
multiplication, and the FCIQMC walker dynamics reuse pieces).

One jit-compiled step of  v <- (1 - eps (H - e_ref - S)) v  with

  * model-provided off-diagonal spawning (exact or stochastically compressed),
  * sort-merge accumulation with initiator masking (runtime.arena),
  * death/cloning on the cached diagonal (frisys_mol.cpp:487-495),
  * projected-energy estimators: either the before/after-multiply trick
    (frifull_mol.cpp:289-301) or direct trial / H-trial dots
    (frisys_mol.cpp:517-520),
  * norm-control shift updates (compress_utils.cpp:684-693),
  * find_preserve + systematic vector compression + compaction.

A model is a ``spawn_fn(keys, vals, h_fac, key) -> (flat_words,
flat_amps, flat_ini)`` plus a ``diag_fn(keys) -> (C,)`` diagonal closure
(already e_ref-relative).  The arena carries no occ/diag caches (see
runtime/arena.py) - drivers recompute both from keys, which profiling showed
beats scattering cached payload columns through every merge/compact.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial

import jax
import jax.numpy as jnp
from jax import lax

from fries_tpu import compress, dets
from fries_tpu.runtime import arena as ar
from fries_tpu.runtime import shard as sh


@dataclass(frozen=True)
class PowerConfig:
    eps: float
    target_nonz: int        # vector compression budget (global across shards)
    capacity: int           # max determinants held (per shard)
    init_thresh: float = 0.0
    target_norm: float = 0.0
    shift_interval: int = 10
    shift_damping: float = 0.05
    shift_tracking: float = 0.0   # extra deviation-control term: once the
                                  # controller is active, each update also
                                  # subtracts tracking/(interval*eps) *
                                  # ln(norm/target), pinning the stationary
                                  # one-norm AT target_norm.  The reference's
                                  # controller (adjust_shift) is rate-only
                                  # (0.0): it freezes the norm WHEREVER the
                                  # first crossing + transient left it, which
                                  # matches the published protocol only when
                                  # the approach is the slow ~40k-iteration
                                  # natural growth.  Runs that start near the
                                  # target need the tracking term so the
                                  # absolute-walker-unit initiator threshold
                                  # keeps its published calibration.
    batch: int = 0          # chunk size for spawning (0 = whole arena)
    spawn_rows: int = 0     # spawn only from the first spawn_rows arena
                            # slots (valid entries are a sorted prefix, so
                            # this is exact while n_used <= spawn_rows -
                            # enforced via the overflow flag). Bounds the
                            # candidate buffer of exact-H spawners at
                            # capacity >> kept sizes (0 = whole arena).
    dedup_cap: int = 0      # collapse duplicate spawn targets to <= this
                            # many (key, ini) rows before each chunk merge
                            # (arena.dedup_spawns).  Exact-H candidate
                            # streams repeat each target once per connected
                            # source, so the merge shrinks from
                            # batch*n_excitations rows to ~|reachable
                            # space|.  0 = off.
    # multi-chip: set axis_name/n_shards when running under shard_map over a
    # 1-D mesh; exchange_cap is the per-destination bucket capacity of the
    # all-to-all spawn exchange (0 = auto)
    axis_name: str | None = None
    n_shards: int = 1
    exchange_cap: int = 0


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class PowerState:
    arena: ar.Arena
    en_shift: jax.Array
    last_norm: jax.Array
    key: jax.Array
    iterat: jax.Array


def fresh_state(a: ar.Arena, seed: int) -> PowerState:
    return PowerState(
        arena=a,
        en_shift=jnp.float64(0.0),
        last_norm=jnp.float64(0.0),
        key=jax.random.key(seed),
        iterat=jnp.int32(0),
    )


def make_stepper(spawn_fn, diag_fn, cfg: PowerConfig,
                 estimator: str = "before_after", spawn_chunk_fn=None):
    """Build (step, run_steps) jitted for one model.

    step(state, num_keys, num_vals, den_keys, den_vals, ref_key):
      estimator="before_after": proj_num from <den|v> before/after the
        multiply; num_* ignored (pass den_* again).
      estimator="direct": proj_num = <num|v_new>, proj_den = <den|v_new>
        evaluated on the post-death uncompressed vector (frisys timing,
        frisys_mol.cpp:517-520).

    ``spawn_chunk_fn`` (optional, exact-H drivers): a per-chunk spawner with
    the same signature as spawn_fn.  When given (and the run is not
    sharded), the step spawns AND merges chunk by chunk inside one scan -
    the flow-controlled "fill the Adder, flush, repeat" of the reference
    (molecule.cpp:602-608) - so the full H*v candidate stream (kept_dets x
    n_excitations rows, gigabytes at production sizes) never materializes.
    Chunk-by-chunk merging is exact: the initiator rule gates against the
    pass-through origin row, which no chunk modifies.
    """
    assert estimator in ("before_after", "direct")
    axis = cfg.axis_name

    def gsum(x):
        return lax.psum(x, axis) if axis else x

    @jax.jit
    def step(state: PowerState, num_keys, num_vals, den_keys, den_vals, ref_key,
             protected_keys=None):
        """``protected_keys`` (P, W): determinants exempt from stochastic
        compression and deletion - the semistochastic deterministic subspace
        (frisys_mol.cpp:501-539: find_preserve/sys_comp skip the dense
        prefix; glob_norm += dense_norm)."""
        a = state.arena
        eps = cfg.eps
        key_iter = jax.random.fold_in(state.key, state.iterat)
        # independent streams for the spawner and the vector-compression grid:
        # reusing key_iter for both makes the systematic grid bit-identical to
        # the spawner's level-A draw, correlating the compression rn with its
        # input (the reference draws fresh MT samples, compress_utils.cpp:291)
        key_spawn, key_vec = jax.random.split(key_iter)
        vals0 = jnp.where(a.valid, a.vals[0], 0.0)

        spawn_over = jnp.bool_(False)
        if cfg.spawn_rows and cfg.spawn_rows < a.capacity:
            r = cfg.spawn_rows
            spawn_over = a.n_used[0] > r
            s_keys, s_vals = a.keys[:r], vals0[:r]
        else:
            r = a.capacity
            s_keys, s_vals = a.keys, vals0

        if spawn_chunk_fn is not None and not (axis and cfg.n_shards > 1):
            # fused spawn+merge flow control (exact-H drivers)
            batch = cfg.batch or r
            n_chunks = -(-r // batch)
            pad = n_chunks * batch - r
            if pad:
                s_keys = jnp.concatenate(
                    [s_keys, jnp.tile(dets.invalid_det(a.n_words), (pad, 1))]
                )
                s_vals = jnp.concatenate(
                    [s_vals, jnp.zeros((pad,), s_vals.dtype)]
                )
            keys_c = s_keys.reshape(n_chunks, batch, -1)
            vals_c = s_vals.reshape(n_chunks, batch)

            def merge_chunk(carry, xs):
                a_c, ovf, nonini = carry
                i, kc, vc = xs
                w, amp, ini = spawn_chunk_fn(
                    kc, vc, -eps, jax.random.fold_in(key_spawn, i)
                )
                w = jnp.where(
                    (amp != 0)[:, None], w,
                    jnp.asarray(dets.invalid_det(a.n_words)),
                )
                if cfg.dedup_cap:
                    w, amp, ini, dovf = ar.dedup_spawns(
                        w, amp, ini, cfg.dedup_cap)
                    ovf = ovf | dovf
                a_c, st = ar.accumulate(
                    a_c, w, amp, ini, origin_row=0, dest_row=1
                )
                return (
                    a_c, ovf | st["overflow"],
                    nonini + st["nonini_occ_add"],
                ), None

            (a2, m_over, m_nonini), _ = lax.scan(
                merge_chunk,
                (a, jnp.bool_(False), jnp.int32(0)),
                (jnp.arange(n_chunks, dtype=jnp.int32), keys_c, vals_c),
            )
            stats = {"overflow": m_over, "nonini_occ_add": m_nonini}
            exch_overflow = jnp.bool_(False)
            flat_words = None
        else:
            # keep bits: the previous step leaves dead rows (zero
            # compressed value, not ref/protected) in place, and the merge
            # below compacts them away first (the end-of-step cleanup of
            # vec_utils.hpp:466-478)
            keep_in = dets.det_eq(a.keys, ref_key[None, :])
            if protected_keys is not None:
                ppos_in, pfound_in = ar.lookup(a, protected_keys)
                keep_in = keep_in | jnp.zeros((a.capacity,), jnp.bool_).at[
                    jnp.where(pfound_in, ppos_in, a.capacity)
                ].set(True, mode="drop")
            flat_words, flat_amps, flat_ini = spawn_fn(
                s_keys, s_vals, -eps, key_spawn
            )
        if flat_words is not None:
            flat_words = jnp.where(
                (flat_amps != 0)[:, None],
                flat_words,
                jnp.asarray(dets.invalid_det(a.n_words)),
            )

            exch_overflow = jnp.bool_(False)
            if axis and cfg.n_shards > 1:
                # route spawns to their owning shards
                # (replaces Adder::perform_add, vec_utils.hpp:991-1019)
                cap = cfg.exchange_cap or max(
                    1, 2 * flat_amps.shape[0] // cfg.n_shards
                )
                target = sh.shard_of_words(flat_words, cfg.n_shards)
                received, exch_overflow = sh.exchange(
                    {
                        "keys": flat_words,
                        "amps": flat_amps,
                        "ini": flat_ini,
                    },
                    target, cfg.n_shards, cap, axis,
                )
                flat_words = received["keys"]
                flat_amps = jnp.where(
                    ~dets.is_invalid(flat_words), received["amps"], 0.0
                )
                flat_ini = received["ini"]

            a_live = ar.compact(a, (a.vals[0] != 0) | keep_in)
            a2, stats = ar.accumulate(
                a_live, flat_words, flat_amps, flat_ini, origin_row=0,
                dest_row=1,
            )

        # death / cloning + combine (frisys_mol.cpp:487-496); the diagonal is
        # recomputed from the merged keys (no cached matr_el_ column)
        diag2 = diag_fn(a2.keys)
        new_v = a2.vals[0] * (1 - eps * (diag2 - state.en_shift)) + a2.vals[1]
        new_v = jnp.where(a2.valid, new_v, 0.0)

        a2v = ar.set_row(a2, 0, new_v)
        # one fused lookup serves the estimator dots AND the protected-subspace
        # mask: the static query sets are concatenated so the merged arena is
        # searched once per step instead of once per query set
        n_num = num_keys.shape[0]
        n_den = den_keys.shape[0]
        if protected_keys is not None:
            queries = jnp.concatenate([num_keys, den_keys, protected_keys])
        else:
            queries = jnp.concatenate([num_keys, den_keys])
        qpos, qfound = ar.lookup(a2, queries)
        gathered = jnp.where(qfound, new_v[qpos], 0.0)
        den_after = gsum(
            jnp.sum(gathered[n_num : n_num + n_den] * den_vals.astype(jnp.float64))
        )
        # pre-multiply trial overlap from the SAME fused lookup: accumulate
        # passes the origin row through untouched, so a2.vals[0] at merged
        # positions is exactly the pre-multiply vals0 - no separate
        # sort-based ar.dot against the old arena needed
        gathered0 = jnp.where(qfound, a2.vals[0][qpos], 0.0)
        den_before = gsum(
            jnp.sum(
                gathered0[n_num : n_num + n_den] * den_vals.astype(jnp.float64)
            )
        )
        if estimator == "before_after":
            proj_num = ((1 + eps * state.en_shift) * den_before - den_after) / eps
            proj_den = den_before
        else:
            proj_num = gsum(
                jnp.sum(gathered[:n_num] * num_vals.astype(jnp.float64))
            )
            proj_den = den_after

        if protected_keys is not None:
            ppos = qpos[n_num + n_den :]
            pfound = qfound[n_num + n_den :]
            prot = jnp.zeros((a2.capacity,), jnp.bool_).at[
                jnp.where(pfound, ppos, a2.capacity)
            ].set(True, mode="drop")
        else:
            prot = jnp.zeros((a2.capacity,), jnp.bool_)
        stoch_v = jnp.where(prot, 0.0, new_v)

        keep, n_left, loc_norm = compress.find_preserve(
            jnp.abs(stoch_v), cfg.target_nonz, axis_name=axis
        )
        glob_norm = gsum(
            loc_norm
            + jnp.sum(jnp.where(keep, jnp.abs(stoch_v), 0.0))
            + jnp.sum(jnp.where(prot, jnp.abs(new_v), 0.0))
        )

        do_shift = (state.iterat + 1) % cfg.shift_interval == 0
        new_shift, new_last = compress.adjust_shift(
            state.en_shift, glob_norm, state.last_norm, cfg.target_norm,
            cfg.shift_damping / cfg.shift_interval / eps,
        )
        if cfg.shift_tracking:
            active = state.last_norm != 0
            new_shift = jnp.where(
                active,
                new_shift
                - (cfg.shift_tracking / cfg.shift_interval / eps)
                * jnp.log(glob_norm / cfg.target_norm),
                new_shift,
            )
        en_shift = jnp.where(do_shift, new_shift, state.en_shift)
        last_norm = jnp.where(do_shift, new_last, state.last_norm)

        rn = jax.random.uniform(key_vec, dtype=jnp.float64)
        comp_v = compress.sys_comp(stoch_v, keep, n_left, rn, loc_norm, axis_name=axis)
        comp_v = jnp.where(prot, new_v, comp_v)

        a3 = ar.set_row(ar.set_row(a2, 0, comp_v), 1, jnp.zeros_like(comp_v))
        is_ref = dets.det_eq(a3.keys, ref_key[None, :])
        live = (comp_v != 0) | is_ref | prot
        if spawn_chunk_fn is not None and not (axis and cfg.n_shards > 1):
            # the chunked exact-H path merges in place without the fused
            # keep mask (row positions shift per chunk), so it compacts here
            a3 = ar.compact(a3, live)
            n_dets_live = gsum(a3.n_used)
        else:
            # dead rows stay until the next step's fused merge drops them;
            # report live determinants directly
            n_dets_live = gsum(jnp.sum(live, dtype=jnp.int32))

        metrics = {
            "proj_num": proj_num,
            "proj_den": proj_den,
            "norm": glob_norm,
            "shift": en_shift,
            "n_dets": n_dets_live,
            # exactly-preserved count (reference nkept.txt, frisys_mol.cpp:506)
            "nkept": jnp.asarray(cfg.target_nonz, jnp.int32) - n_left,
            "n_ini": gsum(
                jnp.sum(
                    (jnp.abs(comp_v) >= cfg.init_thresh) & (comp_v != 0),
                    dtype=jnp.int32,
                )
            ),
            # nonzero count after compression (reference nnonz.txt,
            # DistVec::n_nonz, vec_utils.hpp:533-535)
            "nnonz": gsum(jnp.sum(comp_v != 0, dtype=jnp.int32)),
            # signed-coherence counter: non-initiator adds to occupied
            # targets (tot_sgn_coh, vec_utils.hpp:537-543)
            "sgn_coh": gsum(stats["nonini_occ_add"]),
            "overflow": (
                (gsum((stats["overflow"] | spawn_over).astype(jnp.int32)) > 0)
                | exch_overflow
                if axis
                else stats["overflow"] | spawn_over | exch_overflow
            ),
        }
        return (
            PowerState(a3, en_shift, last_norm, state.key, state.iterat + 1),
            metrics,
        )

    @partial(jax.jit, static_argnames=("n_iter",))
    def run_steps(state, num_keys, num_vals, den_keys, den_vals, ref_key,
                  n_iter: int, protected_keys=None):
        def body(s, _):
            return step(s, num_keys, num_vals, den_keys, den_vals, ref_key,
                        protected_keys)

        return lax.scan(body, state, None, length=n_iter)

    return step, run_steps


def per_parent_ini(vals, init_thresh, n_per):
    """Initiator flags for spawners that emit n_per candidates per parent
    (|v_parent| >= threshold, frisys_mol.cpp:438)."""
    return jnp.repeat(jnp.abs(vals) >= init_thresh, n_per)


def chunked(spawn_one, capacity: int, batch: int, n_words: int):
    """Wrap a whole-batch spawn function with fixed-size chunking via lax.map
    (bounds the candidate-buffer memory for exact H application).

    ``spawn_one`` must return *flat* arrays of size B * NC for a B-row input.
    """
    if not batch or batch >= capacity:
        return spawn_one

    def spawn(keys, vals, h_fac, key):
        c = keys.shape[0]
        n_chunks = -(-c // batch)
        pad = n_chunks * batch - c
        if pad:
            keys = jnp.concatenate(
                [keys, jnp.tile(dets.invalid_det(n_words), (pad, 1))]
            )
            vals = jnp.concatenate([vals, jnp.zeros((pad,), vals.dtype)])

        def one(args):
            # fold the chunk index into the key so a stochastic spawn_one
            # draws independent randoms per chunk
            i, k, v = args
            return spawn_one(k, v, h_fac, jax.random.fold_in(key, i))

        w, amp, ini = lax.map(
            one,
            (
                jnp.arange(n_chunks, dtype=jnp.int32),
                keys.reshape(n_chunks, batch, -1),
                vals.reshape(n_chunks, batch),
            ),
        )
        take = c * (amp.shape[1] // batch)
        return (
            w.reshape(-1, n_words)[:take],
            amp.reshape(-1)[:take],
            ini.reshape(-1)[:take],
        )

    return spawn
