"""Initiator FCIQMC for molecules: integer walkers (fciqmc_mol.cpp, Booth et
al. 2009) and the floating-point variant (fciqmc_fp_mol.cpp, Blunt et al.
2015), with near-uniform or heat-bath Power-Pitzer excitation generation.

Batched redesign of the per-walker loops (fciqmc_mol.cpp:331-412): the dynamic
total walker count becomes a statically-capped *attempt buffer* - attempt
slot k is mapped to its parent determinant by searchsorted on the exclusive
cumulative walker counts (the same output-slot inversion used by comp_sub) -
and every attempt samples one excitation via the batched generators in
ops.near_uniform.  Spawn counts use unbiased binomial rounding
(round_binomially, compress_utils.cpp:19-27); death/cloning applies
round_binomially((1 - eps (H_ii - S)) sign, n_walk) per determinant
(fciqmc_mol.cpp:404-411).
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax

from fries_tpu import compress, dets
from fries_tpu.drivers import power
from fries_tpu.ops import heat_bath as hb
from fries_tpu.ops import molecule as mol
from fries_tpu.ops import near_uniform as nu
from fries_tpu.runtime import arena as ar


@dataclass(frozen=True)
class FciqmcConfig:
    eps: float
    target_walkers: float   # target 1-norm for shift control
    capacity: int
    attempt_cap: int        # static spawn-attempt buffer (>= max total walkers)
    init_thresh: float = 0.0
    shift_interval: int = 10
    shift_damping: float = 0.05
    distribution: str = "NU"   # "NU" | "HB"
    integer_walkers: bool = True
    attempt_chunk: int = 0  # chunk the per-attempt sampling pipeline via
                            # lax.map (bounds the (attempt_cap, n_elec/
                            # n_orb)-shaped sampler temporaries, which
                            # grow with attempt_cap; 0 = one pass). Statistics are identical; the RNG
                            # stream layout differs from the unchunked path.
    spawn_cap: int = 0      # compact the (mostly zero) attempt outputs into
                            # this many rows before exchange/merge - the
                            # analogue of the reference's bounded spawn
                            # buffer (fciqmc_mol.cpp:374-386 adds into a
                            # fixed-size Adder, not one slot per attempt).
                            # One key sort moves live spawns to a prefix;
                            # overflow is flagged if they exceed the cap.
                            # Keeps the merge at spawn_cap rows instead of
                            # attempt_cap (0 = no compaction).
    # multi-chip: hash-sharded walker populations under shard_map
    axis_name: str | None = None
    n_shards: int = 1
    exchange_cap: int = 0


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class FciqmcState:
    arena: ar.Arena
    en_shift: jax.Array
    last_norm: jax.Array
    key: jax.Array
    iterat: jax.Array


def _attempt_parents(n_walk, attempt_cap):
    """Map attempt slots to parent determinant indices.

    offsets = exclusive cumsum of per-determinant walker counts; slot k
    belongs to the determinant whose interval contains k.
    """
    offsets = jnp.cumsum(n_walk, dtype=n_walk.dtype) - n_walk
    total = jnp.sum(n_walk)
    slot = jnp.arange(attempt_cap, dtype=n_walk.dtype)
    parent = jnp.searchsorted(offsets, slot, side="right").astype(jnp.int32) - 1
    parent = jnp.clip(parent, 0, n_walk.shape[0] - 1)
    valid = slot < total
    return parent, valid, total


def build(ham: mol.MolecularHamiltonian, cfg: FciqmcConfig, seed: int,
          init_walkers: float = 100.0):
    """Returns (step, run_steps, state, aux)."""
    syminfo = mol.SymmInfo.build(np.asarray(ham.symm))
    lookup = jnp.asarray(syminfo.lookup)
    symm = jnp.asarray(syminfo.symm)
    symm_counts = jnp.asarray(syminfo.counts)
    tens = hb.setup(ham) if cfg.distribution == "HB" else None
    from fries_tpu.drivers import frisys as _frisys

    p_doub = _frisys.hf_p_doub(ham, syminfo)
    hf_words, hf_occ, hf_en = mol.hf_reference(ham)
    n_orb, n_elec = ham.n_orb, ham.n_elec
    a_cap = cfg.attempt_cap
    eps = cfg.eps
    axis = cfg.axis_name

    def gsum(x):
        return lax.psum(x, axis) if axis else x

    @jax.jit
    def step(state: FciqmcState, num_keys, num_vals, den_keys, den_vals,
             ref_key):
        a = state.arena
        key_iter = jax.random.fold_in(state.key, state.iterat)
        if axis:
            # independent walker streams per shard (the reference seeds each
            # MPI rank separately, fciqmc_mol.cpp:104-105)
            key_iter = jax.random.fold_in(key_iter, lax.axis_index(axis))
        k_split, k_spawn, k_death, k_round = jax.random.split(key_iter, 4)

        vals0 = jnp.where(a.valid, a.vals[0], 0.0)
        # occ / diag recomputed from keys (arena caches neither)
        arena_occ = dets.occ_list(a.keys, 2 * n_orb, n_elec)
        arena_diag = mol.diag_matrel_chunked(ham, arena_occ) - hf_en
        n_walk = jnp.abs(vals0)
        if cfg.integer_walkers:
            n_walk_int = jnp.round(n_walk).astype(jnp.int64)
        else:
            # fp variant: stochastic attempt count round_binomially(|v|, 1)
            # with unit per-attempt weight (fciqmc_fp_mol.cpp:342)
            k_att = jax.random.fold_in(key_iter, 31)
            n_walk_int = compress.round_binomially(
                k_att, n_walk, jnp.ones(n_walk.shape, jnp.int32)
            ).astype(jnp.int64)
        walk_sign = jnp.sign(vals0)

        parent, valid, total = _attempt_parents(n_walk_int, a_cap)
        overflow = total > a_cap

        kd, ks = jax.random.split(k_spawn)

        def attempt_block(par, vald, ksp_c, kd_c, ks_c, kr_c):
            """Sample + weight one block of spawn attempts (the per-walker
            loop body, fciqmc_mol.cpp:331-402, batched)."""
            n_att = par.shape[0]
            p_occ = arena_occ[par]
            p_keys = a.keys[par]
            p_bits = dets.unpack_bits(p_keys, 2 * n_orb)
            counts = hb.unocc_symm_counts(
                n_orb, n_elec, symm, symm_counts, p_occ
            )

            u = jax.random.uniform(ksp_c, (n_att,), dtype=jnp.float64)
            is_doub = u < p_doub

            if cfg.distribution == "HB":
                d = nu.sample_doubles_heat_bath(
                    kd_c, tens, n_orb, n_elec, symm, lookup, p_occ, p_bits
                )
            else:
                d = nu.sample_doubles(
                    kd_c, n_orb, n_elec, symm, lookup, p_occ, p_bits, counts
                )
            s = nu.sample_singles(
                ks_c, n_orb, n_elec, symm, lookup, p_occ, p_bits, counts
            )

            # per-walker weight is 1 in both variants: the attempt count is
            # the stochastically rounded population (fciqmc_mol.cpp:346,
            # fciqmc_fp_mol.cpp:342)
            per_attempt = jnp.where(vald, 1.0, 0.0)

            dmel = mol.doub_matr_el(ham, d["o1"], d["o2"], d["u1"], d["u2"])
            damp_mag = eps * dmel / d["prob"] / p_doub * per_attempt
            dwords, dsign = dets.double_parity(
                p_keys, d["o1"], d["o2"], d["u1"], d["u2"]
            )
            dmask = vald & is_doub & d["valid"]

            smel = mol.sing_matr_el(ham, s["o"], s["u"], p_occ)
            samp_mag = eps * smel / s["prob"] / (1 - p_doub) * per_attempt
            swords, ssign = dets.single_parity(p_keys, s["o"], s["u"])
            smask = vald & ~is_doub & s["valid"]

            mag = jnp.where(dmask, damp_mag, jnp.where(smask, samp_mag, 0.0))
            sign_f = jnp.where(dmask, dsign, ssign).astype(jnp.float64)
            spawn_val = -mag * sign_f * walk_sign[par]
            if cfg.integer_walkers:
                # unbiased integer rounding of each spawn (fciqmc_mol.cpp:377)
                rounded = compress.round_binomially(
                    kr_c, jnp.abs(spawn_val), jnp.ones((n_att,), jnp.int32)
                ).astype(jnp.float64)
                spawn_val = jnp.sign(spawn_val) * rounded
            else:
                # fp variant: spawns below 0.01 are stochastically rounded to
                # integers, larger spawns keep their float value
                # (fciqmc_fp_mol.cpp:383-387)
                small = jnp.abs(spawn_val) < 0.01
                rounded = compress.round_binomially(
                    kr_c, jnp.abs(spawn_val), jnp.ones((n_att,), jnp.int32)
                ).astype(jnp.float64)
                spawn_val = jnp.where(
                    small, jnp.sign(spawn_val) * rounded, spawn_val
                )

            new_words = jnp.where(dmask[:, None], dwords, swords)
            new_words = jnp.where(
                (spawn_val != 0)[:, None],
                new_words,
                jnp.asarray(dets.invalid_det(ham.n_words)),
            )
            ini = n_walk[par] > cfg.init_thresh
            return new_words, spawn_val, ini

        att_chunk = cfg.attempt_chunk
        if att_chunk and att_chunk < a_cap:
            n_ac = -(-a_cap // att_chunk)
            assert n_ac * att_chunk == a_cap, \
                "attempt_chunk must divide attempt_cap"

            def one(args):
                i, par, vald = args
                return attempt_block(
                    par, vald,
                    jax.random.fold_in(k_split, i),
                    jax.random.fold_in(kd, i),
                    jax.random.fold_in(ks, i),
                    jax.random.fold_in(k_round, i),
                )

            new_words, spawn_val, ini = lax.map(
                one,
                (
                    jnp.arange(n_ac, dtype=jnp.int32),
                    parent.reshape(n_ac, att_chunk),
                    valid.reshape(n_ac, att_chunk),
                ),
            )
            new_words = new_words.reshape(a_cap, -1)
            spawn_val = spawn_val.reshape(a_cap)
            ini = ini.reshape(a_cap)
        else:
            new_words, spawn_val, ini = attempt_block(
                parent, valid, k_split, kd, ks, k_round
            )

        if cfg.spawn_cap and cfg.spawn_cap < a_cap:
            # compact live spawns to a bounded buffer: zero-valued attempts
            # already carry the all-ones sentinel key, so one ascending key
            # sort moves every live spawn into the prefix; truncation beyond
            # spawn_cap is flagged (the driver aborts on overflow, matching
            # the reference's hard Adder capacity)
            n_w = new_words.shape[1]
            if dets.packable(n_w):
                sort_keys = [dets.pack_key(new_words)]
            else:  # wide dets: lexicographic most-significant-word first
                sort_keys = dets.sort_key_columns(new_words)
            srt = lax.sort(
                sort_keys + [spawn_val]
                + [new_words[:, i] for i in range(n_w)]
                + [ini.astype(jnp.int32)],
                num_keys=len(sort_keys), is_stable=False,
            )
            nk = len(sort_keys)
            n_live = jnp.sum(
                (~dets.is_invalid(new_words)).astype(jnp.int32)
            )
            overflow |= n_live > cfg.spawn_cap
            spawn_val = srt[nk][: cfg.spawn_cap]
            new_words = jnp.stack(
                [srt[nk + 1 + i][: cfg.spawn_cap] for i in range(n_w)],
                axis=1,
            )
            ini = srt[nk + 1 + n_w][: cfg.spawn_cap] > 0

        # death/cloning BEFORE merging spawns (fciqmc_mol.cpp:404-411):
        # spawned walkers land on the post-death populations
        death_p = (1 - eps * (arena_diag - state.en_shift)) * walk_sign
        if cfg.integer_walkers:
            k_death2 = jax.random.fold_in(k_death, 1)
            new_v = jnp.sign(death_p) * compress.round_binomially(
                k_death2, jnp.abs(death_p), n_walk_int.astype(jnp.int32)
            ).astype(jnp.float64)
        else:
            new_v = death_p * n_walk
        new_v = jnp.where(a.valid, new_v, 0.0)

        if axis and cfg.n_shards > 1:
            from fries_tpu.runtime import shard as sh

            cap = cfg.exchange_cap or max(1, 2 * a_cap // cfg.n_shards)
            tgt = sh.shard_of_words(new_words, cfg.n_shards)
            received, exch_ovf = sh.exchange(
                {"keys": new_words, "amps": spawn_val, "ini": ini},
                tgt, cfg.n_shards, cap, axis,
            )
            new_words = received["keys"]
            spawn_val = jnp.where(
                ~dets.is_invalid(new_words), received["amps"], 0.0
            )
            ini = received["ini"]
            overflow |= exch_ovf

        a1 = ar.set_row(a, 0, new_v)
        a2, stats = ar.accumulate(
            a1, new_words, spawn_val, ini, origin_row=0, dest_row=0,
        )

        final_v = jnp.where(a2.valid, a2.vals[0], 0.0)
        if not cfg.integer_walkers:
            # Blunt-2015 vector compression: stochastically round elements
            # below 1 to 0/+-1 after the merge (fciqmc_fp_mol.cpp:428-440)
            k_vr = jax.random.fold_in(key_iter, 37)
            small_v = (jnp.abs(final_v) < 1.0) & (final_v != 0)
            rv = compress.stochastic_round(k_vr, jnp.abs(final_v))
            final_v = jnp.where(small_v, jnp.sign(final_v) * rv, final_v)

        a2v = ar.set_row(a2, 0, final_v)
        proj_num = gsum(ar.dot(a2v, num_keys, num_vals, row=0))
        proj_den = gsum(ar.dot(a2v, den_keys, den_vals, row=0))

        glob_norm = gsum(jnp.sum(jnp.abs(final_v)))
        do_shift = (state.iterat + 1) % cfg.shift_interval == 0
        new_shift, new_last = compress.adjust_shift(
            state.en_shift, glob_norm, state.last_norm, cfg.target_walkers,
            cfg.shift_damping / cfg.shift_interval / eps,
        )
        en_shift = jnp.where(do_shift, new_shift, state.en_shift)
        last_norm = jnp.where(do_shift, new_last, state.last_norm)

        is_ref = dets.det_eq(a2v.keys, ref_key[None, :])
        a3 = ar.compact(a2v, (final_v != 0) | is_ref)

        metrics = {
            "proj_num": proj_num,
            "proj_den": proj_den,
            "norm": glob_norm,
            "shift": en_shift,
            "n_dets": gsum(a3.n_used),
            "nnonz": gsum(ar.n_nonzero(a3)),
            "sgn_coh": gsum(stats["nonini_occ_add"]),
            "overflow": (
                gsum((stats["overflow"] | overflow).astype(jnp.int32)) > 0
                if axis else stats["overflow"] | overflow
            ),
        }
        return (
            FciqmcState(a3, en_shift, last_norm, state.key, state.iterat + 1),
            metrics,
        )

    @partial(jax.jit, static_argnames=("n_iter",))
    def run_steps(state, num_keys, num_vals, den_keys, den_vals, ref_key,
                  n_iter: int):
        def body(st, _):
            return step(st, num_keys, num_vals, den_keys, den_vals, ref_key)

        return lax.scan(body, state, None, length=n_iter)

    # trial = HF, htrial = (H - hf_en)|HF> (fciqmc_mol.cpp:180-214)
    tmpl = mol.ExcitationTemplate.build(n_orb, n_elec)
    tw, ta, _ = mol.exact_offdiag_batch(
        ham, tmpl, hf_words[None], hf_occ[None], jnp.ones((1,)), 1.0
    )
    tw = np.asarray(tw[0])
    ta = np.asarray(ta[0])
    keep = ta != 0
    htrial_keys = np.concatenate([np.asarray(hf_words)[None], tw[keep]])
    htrial_vals = np.concatenate([[0.0], ta[keep]])

    a = ar.make(cfg.capacity, ham.n_words, 1)
    a = ar.from_unsorted(a, hf_words[None], jnp.asarray([[init_walkers]]))
    state = FciqmcState(
        arena=a,
        en_shift=jnp.float64(0.0),
        last_norm=jnp.float64(0.0),
        key=jax.random.key(seed),
        iterat=jnp.int32(0),
    )
    aux = {
        "e_ref": hf_en,
        "num_keys": jnp.asarray(htrial_keys),
        "num_vals": jnp.asarray(htrial_vals),
        "den_keys": hf_words[None],
        "den_vals": jnp.ones((1,)),
        "ref_key": hf_words,
        "p_doub": p_doub,
    }
    return step, run_steps, state, aux


def build_sharded(ham: mol.MolecularHamiltonian, cfg: FciqmcConfig, seed: int,
                  mesh, init_walkers: float = 100.0):
    """Hash-sharded FCIQMC over a 1-D mesh: walkers distributed by
    determinant hash with all-to-all spawn exchange (the device-mesh analogue
    of the reference's MPI rank layout).  ``cfg.capacity``/``attempt_cap`` are per
    shard."""
    from fries_tpu import parallel
    from jax.sharding import PartitionSpec as P

    assert cfg.axis_name and cfg.n_shards == mesh.devices.size
    step, run_steps, state0, aux = build(ham, cfg, seed, init_walkers)
    a = state0.arena
    live = np.asarray(a.valid)
    gk, gv, gn = parallel.distribute_rows(
        np.asarray(a.keys)[live], np.asarray(a.vals)[:, live],
        cfg.n_shards, cfg.capacity,
    )
    st = FciqmcState(
        arena=ar.Arena(keys=gk, vals=gv, n_used=gn),
        en_shift=state0.en_shift, last_norm=state0.last_norm,
        key=state0.key, iterat=state0.iterat,
    )
    sspec = FciqmcState(
        arena=parallel.arena_spec(cfg.axis_name), en_shift=P(), last_norm=P(),
        key=P(), iterat=P(),
    )
    mspec = {
        "proj_num": P(), "proj_den": P(), "norm": P(), "shift": P(),
        "n_dets": P(), "nnonz": P(), "sgn_coh": P(), "overflow": P(),
    }
    repl = (P(), P(), P(), P(), P())
    sharded_step = jax.jit(
        jax.shard_map(
            step, mesh=mesh, in_specs=(sspec,) + repl,
            out_specs=(sspec, mspec), check_vma=False,
        )
    )

    _cache: dict = {}

    def sharded_run(state, nk, nv, dk, dv, rk, n_iter: int):
        # cached per n_iter - a fresh shard_map lambda per call is a new
        # jit cache key, i.e. a full recompile every invocation
        if n_iter not in _cache:
            _cache[n_iter] = jax.jit(
                jax.shard_map(
                    lambda s, a1, a2, a3, a4, a5: run_steps(
                        s, a1, a2, a3, a4, a5, n_iter
                    ),
                    mesh=mesh, in_specs=(sspec,) + repl,
                    out_specs=(sspec, mspec), check_vma=False,
                )
            )
        return _cache[n_iter](state, nk, nv, dk, dv, rk)

    return sharded_step, sharded_run, st, aux
