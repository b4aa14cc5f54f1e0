"""Multi-state subspace iteration (FRIES_bin/subsp_mol.cpp): simultaneous
stochastic power iteration of n_trial vectors sharing one determinant index
set, with per-iteration trial-projected h/d matrices and periodic
QR-orthonormalization restarts.

Per iteration (subsp_mol.cpp:398-640):
  1. normalize each vector by its norm factor (adjust_shift2 controller,
     compress_utils.cpp:695-700);
  2. h_mat[i,j] = <trial_i |(H - e_ref)| v_j>, d_mat[i,j] = <trial_i | v_j>
     (recorded every iteration; energies come from the generalized
     eigenproblem of the averaged matrices, linalg.subspace_energies);
  3. every restart_int iterations recombine v_new = v_old @ R^-1 where
     QR(d - eps h) = Q R, then restore the per-vector norms (:480-510);
  4. per-row vector compression (find_preserve + systematic resampling; the
     reference's compress_vecs uses the pivotal variant - both unbiased);
     entries zero in every row are deleted;
  5. per-vector stochastically-compressed multiplication by
     1 - eps (H - e_ref) with the unnormalized HB-PP factorization and a
     norm-relative initiator threshold (:520-618).
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax

from fries_tpu import compress, dets, linalg
from fries_tpu.drivers import frisys
from fries_tpu.ops import heat_bath as hb
from fries_tpu.ops import molecule as mol
from fries_tpu.runtime import arena as ar


@dataclass(frozen=True)
class SubspaceConfig:
    eps: float
    n_trial: int
    vec_nonz: int           # per-vector compression budget
    matr_samp: int          # per-vector Hamiltonian budget
    capacity: int
    spawn_cap: int
    restart_int: int = 10
    init_thresh: float = 0.0
    shift_interval: int = 10
    shift_damping: float = 0.05
    unnorm: bool = True
    exact_h: bool = False   # exact H application (subspfull_mol.cpp)
    compress_mode: str = "piv"  # vector compression: "piv" (reference
                                # compress_vecs, vec_utils.cpp:10-71), "sys",
                                # or "multi" (compress_vecs_multi, :73-127)
    pivotal_h: bool = True      # apply_HBPP_piv per-stage pivotal sampling
    lowmem: bool = False        # subsp_mol_lowmem: compute <trial|H|v> on
                                # the fly instead of storing the H*trial rows
                                # (calc_h_dot, molecule.cpp:667-885)
    spin_parity: int = 0        # time-reversal sector (subsp_mol.cpp
                                # --time_reversal: trial folding :207-224,
                                # folded diagonal :115-147)
    # multi-chip (BASELINE.md: hash-sharded subsp_mol): set under shard_map
    axis_name: str | None = None
    n_shards: int = 1
    exchange_cap: int = 0


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class SubspaceState:
    arena: ar.Arena
    norm_factors: jax.Array   # (T,)
    last_norms: jax.Array     # (T,)
    key: jax.Array
    iterat: jax.Array


def build(ham: mol.MolecularHamiltonian, cfg: SubspaceConfig,
          trial_keys, trial_vals, seed: int, e_ref=None):
    """trial_keys: (T, Nt, W) determinants of each trial vector (sentinel-
    padded); trial_vals: (T, Nt).  The iterates start as the trial vectors
    (subsp_mol.cpp:197-235).  ``e_ref`` overrides the HF diagonal shift
    (--ham_shift, subsp_mol.cpp:36 + 96-99)."""
    t = cfg.n_trial
    if cfg.spin_parity:
        # fold each trial vector onto canonical spin-flip representatives
        # (subsp_mol.cpp:207-224)
        from fries_tpu.ops import time_reversal as tr_mod

        folded = [
            tr_mod.fold_vector_host(
                ham, trial_keys[j], trial_vals[j], cfg.spin_parity
            )
            for j in range(cfg.n_trial)
        ]
        nmax = max(1, max(len(v) for _, v in folded))
        fk = np.tile(
            np.asarray(dets.invalid_det(ham.n_words)), (cfg.n_trial, nmax, 1)
        )
        fv = np.zeros((cfg.n_trial, nmax))
        for j, (k_j, v_j) in enumerate(folded):
            fk[j, : len(v_j)] = k_j
            fv[j, : len(v_j)] = v_j
        trial_keys = jnp.asarray(fk)
        trial_vals = jnp.asarray(fv)
    syminfo = mol.SymmInfo.build(np.asarray(ham.symm))
    tens = hb.setup(ham)
    p_doub = frisys.hf_p_doub(ham, syminfo)
    hf_words, hf_occ, hf_en = mol.hf_reference(ham)
    if e_ref is not None:
        hf_en = float(e_ref)
    n_orb, n_elec = ham.n_orb, ham.n_elec

    fcfg = frisys.FrisysConfig(
        eps=cfg.eps, vec_nonz=cfg.vec_nonz, matr_samp=cfg.matr_samp,
        capacity=cfg.capacity, spawn_cap=cfg.spawn_cap, unnorm=cfg.unnorm,
        pivotal=cfg.pivotal_h, spin_parity=cfg.spin_parity,
        axis_name=cfg.axis_name, n_shards=cfg.n_shards,
    )
    if cfg.exact_h:
        # subspfull_mol: exact (uncompressed) H application per vector
        tmpl_x = mol.ExcitationTemplate.build(ham.n_orb, ham.n_elec)

        def spawn(keys, vals, h_fac, key, thresh=None):
            occ = dets.occ_list(keys, ham.n_bits, ham.n_elec)
            w, amp, _ = mol.exact_offdiag_batch(
                ham, tmpl_x, keys, occ, vals, h_fac
            )
            fw = w.reshape(-1, ham.n_words)
            fa = amp.reshape(-1)
            fi = jnp.ones(fa.shape, jnp.bool_)
            return fw, fa, fi
    else:
        spawn = frisys.make_hbpp_spawner(ham, tens, syminfo, p_doub, fcfg, hf_en)

    # H * trial (exact) for the h_mat projections (subsp_mol.cpp:258-270).
    # lowmem (subsp_mol_lowmem.cpp:439) skips the stored rows entirely and
    # re-enumerates H|trial_i> inside each step - the batched re-design keeps the
    # reference's memory profile but enumerates on the (small, fixed) trial
    # side instead of walking the full iterate (calc_h_dot walks the iterate,
    # molecule.cpp:667-885; the projection is identical by symmetry of H)
    tmpl = mol.ExcitationTemplate.build(n_orb, n_elec)
    htrial_keys = []
    htrial_vals = []
    for j in range(t if not cfg.lowmem else 0):
        tk = np.asarray(trial_keys[j])
        tv = np.asarray(trial_vals[j])
        live = tv != 0
        tk = tk[live]
        tv = tv[live]
        occ_j = dets.occ_list(jnp.asarray(tk), ham.n_bits, n_elec)
        w, amp, _ = mol.exact_offdiag_batch(
            ham, tmpl, jnp.asarray(tk), occ_j, jnp.asarray(tv), 1.0
        )
        nc_j = amp.shape[1]
        wflat = w.reshape(-1, ham.n_words)
        aflat = amp.reshape(-1)
        diag_j = np.asarray(mol.diag_matrel(ham, occ_j)) - float(hf_en)
        if cfg.spin_parity:
            from fries_tpu.ops import time_reversal as tr_mod

            parents = jnp.repeat(jnp.asarray(tk), nc_j, axis=0)
            pocc = jnp.repeat(occ_j, nc_j, axis=0)
            scale = jnp.repeat(jnp.asarray(tv), nc_j)
            wflat, aflat = tr_mod.adjust_exact(
                ham, parents, pocc, wflat, aflat, cfg.spin_parity, scale=scale
            )
            delta_j, forbid_j = tr_mod.tr_diag(
                ham, jnp.asarray(tk), occ_j, cfg.spin_parity
            )
            diag_j = diag_j + np.asarray(delta_j)
            diag_j = np.where(np.asarray(forbid_j), 0.0, diag_j)
        w = wflat
        amp = np.asarray(aflat)
        w = np.asarray(w)
        keys_all = np.concatenate([tk, w[amp != 0]])
        vals_all = np.concatenate([tv * diag_j, amp[amp != 0]])
        # merge duplicates
        merged = {}
        for kk, vv in zip(map(tuple, keys_all), vals_all):
            merged[kk] = merged.get(kk, 0.0) + vv
        htrial_keys.append(np.asarray(list(merged.keys()), np.uint32))
        htrial_vals.append(np.asarray(list(merged.values())))

    if cfg.lowmem:
        h_keys = h_vals = None
    else:
        nh = max(len(v) for v in htrial_vals)
        h_keys = np.tile(np.asarray(dets.invalid_det(ham.n_words)), (t, nh, 1))
        h_vals = np.zeros((t, nh))
        for j in range(t):
            h_keys[j, : len(htrial_vals[j])] = htrial_keys[j]
            h_vals[j, : len(htrial_vals[j])] = htrial_vals[j]
        h_keys = jnp.asarray(h_keys)
        h_vals = jnp.asarray(h_vals)
    t_keys = jnp.asarray(trial_keys)
    t_vals = jnp.asarray(trial_vals)
    t_occ = dets.occ_list(t_keys, ham.n_bits, n_elec)
    t_valid = ~dets.is_invalid(t_keys)
    t_diag_rel = jnp.where(
        t_valid,
        mol.diag_matrel(ham, t_occ) - hf_en,
        0.0,
    )
    if cfg.spin_parity:
        # folded-basis diagonal for the lowmem on-the-fly <trial|H|v>
        # (subsp_mol_lowmem supports --time_reversal; same MyArgs struct)
        from fries_tpu.ops import time_reversal as tr_mod

        delta_t, forbid_t = tr_mod.tr_diag(ham, t_keys, t_occ, cfg.spin_parity)
        t_diag_rel = jnp.where(
            forbid_t | ~t_valid, 0.0, t_diag_rel + delta_t
        )

    # initial arena: union of trial dets with each row = trial vector
    all_keys = np.asarray(trial_keys).reshape(-1, ham.n_words)
    uniq = {}
    for row in range(all_keys.shape[0]):
        kk = tuple(all_keys[row])
        if kk not in uniq and not all(x == 0xFFFFFFFF for x in kk):
            uniq[kk] = len(uniq)
    init_keys = np.asarray(list(uniq.keys()), np.uint32)
    init_vals = np.zeros((t, len(uniq)))
    for j in range(t):
        tk = np.asarray(trial_keys[j])
        tv = np.asarray(trial_vals[j])
        for r in range(tk.shape[0]):
            kk = tuple(tk[r])
            if kk in uniq:
                init_vals[j, uniq[kk]] += tv[r]
    a = ar.make(cfg.capacity, ham.n_words, t)
    a = ar.from_unsorted(a, jnp.asarray(init_keys), jnp.asarray(init_vals))

    state = SubspaceState(
        arena=a,
        norm_factors=jnp.ones((t,)),
        last_norms=jnp.sum(jnp.abs(jnp.asarray(init_vals)), axis=1),
        key=jax.random.key(seed),
        iterat=jnp.int32(0),
    )

    axis = cfg.axis_name

    def gsum(x):
        return lax.psum(x, axis) if axis else x

    @jax.jit
    def step(state: SubspaceState):
        a = state.arena
        key_iter = jax.random.fold_in(state.key, state.iterat)

        # ---- 1. normalize by the norm-factor controller ----
        norms = gsum(
            jnp.sum(jnp.abs(jnp.where(a.valid[None, :], a.vals, 0.0)), axis=1)
        )
        do_shift = (state.iterat + 1) % cfg.shift_interval == 0
        nf_new, ln_new = compress.adjust_shift2(
            state.norm_factors, norms, state.last_norms, cfg.shift_damping
        )
        norm_factors = jnp.where(do_shift, nf_new, state.norm_factors)
        last_norms = jnp.where(do_shift, ln_new, state.last_norms)
        vals = a.vals / norm_factors[:, None]
        a = ar.Arena(a.keys, vals, a.n_used)

        # ---- 2. h/d projection matrices ----
        def dots(qkeys, qvals):
            pos, found = dets.lookup_dets(a.keys, qkeys.reshape(-1, ham.n_words))
            # one (t, Q*K) row gather for all vector rows at once
            g = jnp.where(found[None, :], a.vals[:, pos], 0.0).reshape(
                t, qkeys.shape[0], -1
            )
            return gsum(jnp.einsum("jqk,qk->qj", g, qvals))  # (T_query, T_vec)

        d_mat = dots(t_keys, t_vals)
        if cfg.lowmem:
            # <trial_i|(H - e_ref)|v_j> on the fly: enumerate H|trial_i> per
            # trial vector (small, fixed) and dot the spawns against the
            # arena rows; no stored H*trial.  vmapped over trial rows.
            def h_row(tk_i, to_i, tv_raw, tvalid_i, td_i):
                tv_i = jnp.where(tvalid_i, tv_raw, 0.0)
                tw, ta, _ = mol.exact_offdiag_batch(
                    ham, tmpl, tk_i, to_i, tv_i, 1.0
                )
                fw = tw.reshape(-1, ham.n_words)
                fa = ta.reshape(-1)
                if cfg.spin_parity:
                    # fold the enumerated spawns exactly as the stored
                    # H*trial path does (adjust_tr, molecule.cpp:298-378)
                    from fries_tpu.ops import time_reversal as tr_mod

                    nc_i = ta.shape[1]
                    parents_i = jnp.repeat(tk_i, nc_i, axis=0)
                    pocc_i = jnp.repeat(to_i, nc_i, axis=0)
                    scale_i = jnp.repeat(tv_i, nc_i)
                    fw, fa = tr_mod.adjust_exact(
                        ham, parents_i, pocc_i, fw, fa, cfg.spin_parity,
                        scale=scale_i,
                    )
                pos_o, found_o = dets.lookup_dets(a.keys, fw)
                pos_t, found_t = dets.lookup_dets(a.keys, tk_i)
                off = jnp.sum(
                    jnp.where(found_o[None, :], a.vals[:, pos_o], 0.0)
                    * fa[None, :], axis=1,
                )
                dia = jnp.sum(
                    jnp.where(found_t[None, :], a.vals[:, pos_t], 0.0)
                    * (tv_raw * td_i)[None, :], axis=1,
                )
                return off + dia   # (T_vec,)

            h_mat = jax.vmap(h_row)(
                t_keys, t_occ, t_vals, t_valid, t_diag_rel
            )
        else:
            h_mat = dots(h_keys, h_vals)

        # ---- 3. restart recombination ----
        do_restart = (state.iterat + 1) % cfg.restart_int == 0

        def restarted(vals):
            m = d_mat - cfg.eps * h_mat
            # R^-1 by explicit back-substitution (invr_inplace,
            # lapack_wrappers.cpp:90-179)
            rinv = linalg.inv_r_factor(m)
            new_vals = jnp.einsum("kj,kc->jc", rinv, vals)
            old_norms = gsum(jnp.sum(jnp.abs(vals), axis=1))
            new_norms = gsum(jnp.sum(jnp.abs(new_vals), axis=1))
            scale = old_norms / jnp.maximum(new_norms, 1e-300)
            return new_vals * scale[:, None]

        vals = jnp.where(do_restart, restarted(a.vals), a.vals)
        a = ar.Arena(a.keys, vals, a.n_used)

        # ---- 4. per-row compression (reference compress_vecs pivotal
        # default, vec_utils.cpp:10-71; sys and two-level multinomial
        # variants selectable).  vmapped over the trial rows: one traced
        # pipeline regardless of n_trial (the unrolled loop made compile
        # time grow superlinearly with T) ----
        vrows = jnp.where(a.valid[None, :], a.vals, 0.0)
        krows = jax.vmap(lambda j: jax.random.fold_in(key_iter, 100 + j))(
            jnp.arange(t)
        )
        if cfg.compress_mode == "piv":
            vals = jax.vmap(
                lambda kj, vj: compress.piv_comp(
                    kj, vj, cfg.vec_nonz, axis_name=axis
                )
            )(krows, vrows)
        elif cfg.compress_mode == "multi":
            def _multi(kj, vj):
                keep, n_left, loc_norm = compress.find_preserve(
                    jnp.abs(vj), cfg.vec_nonz, axis_name=axis
                )
                return compress.multi_comp(
                    kj, vj, keep, n_left, loc_norm, axis_name=axis
                )

            vals = jax.vmap(_multi)(krows, vrows)
        else:
            def _sys(kj, vj):
                keep, n_left, loc_norm = compress.find_preserve(
                    jnp.abs(vj), cfg.vec_nonz, axis_name=axis
                )
                rn = jax.random.uniform(kj, dtype=jnp.float64)
                return compress.sys_comp(
                    vj, keep, n_left, rn, loc_norm, axis_name=axis
                )

            vals = jax.vmap(_sys)(krows, vrows)
        a = ar.Arena(a.keys, vals, a.n_used)
        any_nonzero = jnp.any(vals != 0, axis=0)
        a = ar.compact(a, any_nonzero)

        # ---- 5. per-vector stochastic multiplication, vmapped over rows
        # (one HB-PP pipeline trace for any n_trial; buffers are (T, S)) ----
        norms_now = gsum(
            jnp.sum(jnp.abs(jnp.where(a.valid[None, :], a.vals, 0.0)), axis=1)
        )
        overflow = jnp.bool_(False)
        vrows2 = jnp.where(a.valid[None, :], a.vals, 0.0)
        krows2 = jax.vmap(lambda j: jax.random.fold_in(key_iter, 200 + j))(
            jnp.arange(t)
        )
        # norm-relative initiator threshold (subsp_mol.cpp:522-523):
        # init_thresh * ||v_j||_1 / matr_samp, recomputed per vector per
        # iteration (init_thresh=0 keeps every parent an initiator)
        thr_rows = cfg.init_thresh * norms_now / cfg.matr_samp
        n_ini_rows = jnp.sum(
            ((jnp.abs(vrows2) >= thr_rows[:, None]) & (vrows2 != 0)).astype(
                jnp.int32
            ),
            axis=1,
        )
        w_b, amp_b, ini_b = jax.vmap(
            lambda vj, kj, tj: spawn(a.keys, vj, -cfg.eps, kj, thresh=tj)
        )(vrows2, krows2, thr_rows)
        row_b = jnp.broadcast_to(
            jnp.arange(t, dtype=jnp.int32)[:, None], amp_b.shape
        )
        sw = w_b.reshape(-1, ham.n_words)
        sa = amp_b.reshape(-1)
        si = ini_b.reshape(-1)
        sr = row_b.reshape(-1)

        if axis and cfg.n_shards > 1:
            # route spawns to their owning shards (Adder::perform_add)
            from fries_tpu.runtime import shard as sh

            cap = cfg.exchange_cap or max(1, 2 * sa.shape[0] // cfg.n_shards)
            target = sh.shard_of_words(sw, cfg.n_shards)
            received, exch_ovf = sh.exchange(
                {"keys": sw, "amps": sa, "ini": si, "rows": sr},
                target, cfg.n_shards, cap, axis,
            )
            sw = received["keys"]
            sa = jnp.where(~dets.is_invalid(sw), received["amps"], 0.0)
            si = received["ini"]
            sr = received["rows"]
            overflow |= exch_ovf

        # death on every row, then merge spawns (diagonal recomputed from
        # keys - the arena carries no matr_el_ cache)
        arena_occ = dets.occ_list(a.keys, ham.n_bits, n_elec)
        arena_diag = mol.diag_matrel_chunked(ham, arena_occ) - hf_en
        if cfg.spin_parity:
            from fries_tpu.ops import time_reversal as tr_mod

            tr_delta, tr_forbid = tr_mod.tr_diag(
                ham, a.keys, arena_occ, cfg.spin_parity
            )
            arena_diag = jnp.where(tr_forbid, arena_diag, arena_diag + tr_delta)
        death = 1 - cfg.eps * arena_diag
        dvals = jnp.where(a.valid[None, :], a.vals * death[None, :], 0.0)
        a = ar.Arena(a.keys, dvals, a.n_used)
        a2, stats = ar.accumulate_multi(a, sw, sa, sr, si)
        overflow |= stats["overflow"]

        metrics = {
            "h_mat": h_mat,
            "d_mat": d_mat,
            "norms": norms,
            "norm_factors": norm_factors,
            # per-vector initiator counts (subsp_mol.cpp:610-624 -> n_ini.txt)
            "n_ini": gsum(n_ini_rows),
            "n_dets": gsum(a2.n_used),
            "overflow": (
                gsum(overflow.astype(jnp.int32)) > 0 if axis else overflow
            ),
        }
        return (
            SubspaceState(a2, norm_factors, last_norms, state.key, state.iterat + 1),
            metrics,
        )

    @partial(jax.jit, static_argnames=("n_iter",))
    def run_steps(state, n_iter: int):
        def body(s, _):
            return step(s)

        return lax.scan(body, state, None, length=n_iter)

    aux = {
        "e_ref": hf_en,
        "trial_keys": t_keys,
        "trial_vals": t_vals,
        "htrial_keys": h_keys,
        "htrial_vals": h_vals,
    }
    return step, run_steps, state, aux


def build_sharded(ham: mol.MolecularHamiltonian, cfg: SubspaceConfig,
                  trial_keys, trial_vals, seed: int, mesh, e_ref=None):
    """Hash-sharded subspace iteration over a 1-D mesh (BASELINE.md requires
    subsp_mol sharded; the device-mesh analogue of the reference's MPI
    layout).
    ``cfg.capacity`` is per shard; budgets are global."""
    from fries_tpu import parallel

    assert cfg.axis_name and cfg.n_shards == mesh.devices.size
    step, run_steps, state0, aux = build(ham, cfg, trial_keys, trial_vals, seed,
                                         e_ref=e_ref)
    a = state0.arena
    live = np.asarray(a.valid)
    keys = np.asarray(a.keys)[live]
    vals = np.asarray(a.vals)[:, live]
    gk, gv, gn = parallel.distribute_rows(
        keys, vals, cfg.n_shards, cfg.capacity
    )
    st = SubspaceState(
        arena=ar.Arena(keys=gk, vals=gv, n_used=gn),
        norm_factors=state0.norm_factors,
        last_norms=state0.last_norms,
        key=state0.key,
        iterat=state0.iterat,
    )
    sstep, srun = parallel.shard_subspace(step, run_steps, mesh, cfg.axis_name)
    return sstep, srun, st, aux
