"""Command-line drivers mirroring the reference's FRIES_bin executables.

Each subcommand reproduces one reference workload's flags and output files
(SURVEY.md section 2.7): append-mode per-iteration text streams projnum.txt /
projden.txt / S.txt / norm.txt / nkept.txt / nini.txt (+ params.txt with the
run configuration, frisys_mol.cpp:288-333), h_mat/d_mat trajectories for the
subspace drivers (subsp_mol.cpp:454-477), and .npz checkpoints every
``save_interval`` iterations with resume via --load_dir.

Usage:  python -m fries_tpu.cli <workload> [flags]
        python -m fries_tpu.cli frisys_mol --fcidump_path FCIDUMP \
            --distribution HB --epsilon 1e-3 --vec_nonz 100000 \
            --mat_nonz 100000 --max_dets 1000000 --max_iter 10000
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np


def _out(result_dir, name):
    os.makedirs(result_dir, exist_ok=True)
    return open(os.path.join(result_dir, name), "a")


def _plain(x):
    """Unwrap numpy/jax scalars (arbitrarily nested in object arrays) to a
    plain Python number so streamed files parse with ``np.loadtxt``."""
    while hasattr(x, "item"):
        y = x.item()
        if y is x:
            break
        x = y
    return x


def _write_params(result_dir, args):
    os.makedirs(result_dir, exist_ok=True)
    with open(os.path.join(result_dir, "params.txt"), "w") as f:
        for k, v in sorted(vars(args).items()):
            f.write(f"{k}: {v}\n")


def _run_power_driver(args, step, run_steps, state, aux, protected=None):
    """Common iteration loop for the single-vector drivers: run in blocks,
    stream metrics to the reference's output files, checkpoint periodically."""
    import dataclasses

    import jax
    from fries_tpu.runtime import checkpoint

    result_dir = args.result_dir
    _write_params(result_dir, args)

    if getattr(args, "load_dir", None):
        # resume: arena + scalars + RNG from the snapshot (reference
        # frisys_mol.cpp:257-263 + DistVec::load, vec_utils.hpp:761-848)
        ckpt = os.path.join(args.load_dir, "checkpoint.npz")
        scal = checkpoint.load_scalars(ckpt)
        fields = {"arena": checkpoint.load_arena(ckpt),
                  "key": checkpoint.restore_key(ckpt)}
        import jax.numpy as jnp
        for name in ("en_shift", "last_norm", "iterat"):
            if name in scal and hasattr(state, name):
                fields[name] = jnp.asarray(scal[name])
        state = dataclasses.replace(state, **fields)
        print(f"resumed from {ckpt} at iteration {int(scal['iterat'])}")
    files = {
        "proj_num": _out(result_dir, "projnum.txt"),
        "proj_den": _out(result_dir, "projden.txt"),
        "shift": _out(result_dir, "S.txt"),
        "norm": _out(result_dir, "norm.txt"),
        "n_dets": _out(result_dir, "N.txt"),
        "n_ini": _out(result_dir, "nini.txt"),
        "nkept": _out(result_dir, "nkept.txt"),
        "nnonz": _out(result_dir, "nnonz.txt"),
        "sgn_coh": _out(result_dir, "sgn_coh.txt"),
    }
    est_args = (
        aux["num_keys"], aux["num_vals"], aux["den_keys"], aux["den_vals"],
        aux["ref_key"],
    )
    # wall seconds per block, device work included (the first block of a
    # run also holds the step's compilation)
    wall = _out(result_dir, "wall.txt")
    block = min(args.save_interval, 100)
    done = 0
    while done < args.max_iter:
        n = min(block, args.max_iter - done)
        prev_state = state
        t0 = time.perf_counter()
        if protected is not None:
            state, traj = run_steps(state, *est_args, n, protected)
        else:
            state, traj = run_steps(state, *est_args, n)
        jax.block_until_ready((state, traj))
        wall.write(f"{done + n},{n},{time.perf_counter() - t0!r}\n")
        wall.flush()
        if bool(np.asarray(traj["overflow"]).any()):
            # the reference flow-controls its Adder (vec_utils.hpp:991-1019);
            # with static buffers an overflow invalidates the trajectory, so
            # checkpoint and abort instead of silently corrupting the run
            checkpoint.save_state(
                os.path.join(result_dir, "checkpoint_overflow.npz"), prev_state
            )
            for f in (*files.values(), wall):
                f.close()
            raise SystemExit(
                "ERROR: spawn/arena buffer overflow at iteration "
                f"{done + n}; results from this block are invalid. "
                "Re-run with larger --max_dets (or mat_nonz spawn capacity); "
                "last good state saved to checkpoint_overflow.npz"
            )
        for name, f in files.items():
            if name not in traj:  # driver variants emit a metric subset
                continue
            arr = np.asarray(traj[name]).reshape(len(np.asarray(traj["norm"])), -1)
            for row in arr:
                f.write(",".join(repr(_plain(x)) for x in row) + "\n")
            f.flush()
        done += n
        num = np.asarray(traj["proj_num"])[-1]
        den = np.asarray(traj["proj_den"])[-1]
        print(
            f"{done}, en est: {num / den:.8f}, shift: "
            f"{float(np.asarray(traj['shift'])[-1]):.6f}, norm: "
            f"{float(np.asarray(traj['norm'])[-1]):.2f}"
        )
        if done % args.save_interval == 0 or done >= args.max_iter:
            checkpoint.save_state(
                os.path.join(result_dir, "checkpoint.npz"), state
            )
            # arena occupancy diagnostic (print_ht parity, det_hash.hpp:98-114)
            from fries_tpu.runtime import arena as _arena

            occ = _arena.occupancy_stats(state.arena)
            with open(os.path.join(result_dir, "arena_occ.txt"), "a") as f:
                f.write(
                    f"{done},{occ['used']},{occ['capacity']},"
                    f"{occ['fill']:.4f},{occ['live']},{occ['nonzero']},"
                    f"{occ['zero_live']}\n"
                )
    for f in (*files.values(), wall):
        f.close()


def _load_molecular(args):
    """Returns (ham, core_energy).  core_energy feeds the --ham_shift
    conversion hf_en = ham_shift - core_en (frisys_mol.cpp:94-99)."""
    from fries_tpu import io

    if getattr(args, "fcidump_path", None):
        ham, core = io.parse_fcidump(args.fcidump_path, args.point_group)
        return ham, core
    ham, params = io.parse_hf_input(args.hf_path)
    return ham, 0.0  # HF-dir input carries no core-energy record


def _e_ref_from_args(args, core):
    """--ham_shift to the internal diagonal offset (None when absent)."""
    if getattr(args, "ham_shift", None) is None:
        return None
    return float(args.ham_shift) - float(core)


def _load_trial_init(args, ham):
    """--trial_vec / --ini_vec prefixes -> (trial, init_vec) tuples (or
    None): text files <prefix>dets / <prefix>vals (frisys_mol.cpp:27-29)."""
    from fries_tpu import io

    trial = init_vec = None
    if getattr(args, "trial_vec", None):
        trial = io.load_vec_txt(args.trial_vec, ham.n_bits)
    if getattr(args, "ini_vec", None):
        init_vec = io.load_vec_txt(args.ini_vec, ham.n_bits)
    return trial, init_vec


def _add_common(p, molecular=True):
    if molecular:
        p.add_argument("--fcidump_path")
        p.add_argument("--hf_path")
        p.add_argument("--point_group", default="C1")
    p.add_argument("--result_dir", default="./")
    p.add_argument("--max_iter", type=int, default=1000000)
    p.add_argument("--max_dets", type=int, required=True)
    p.add_argument("--initiator", type=float, default=0.0, dest="init_thresh")
    p.add_argument("--target", type=float, default=0.0, dest="target_norm")
    p.add_argument("--save_interval", type=int, default=100)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--load_dir")
    p.add_argument("--n_chips", type=int, default=1,
                   help="hash-shard the run over the first N devices "
                        "(max_dets becomes per-chip capacity)")


def main(argv=None):
    parser = argparse.ArgumentParser(prog="fries_tpu")
    sub = parser.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("frifull_mol", help="exact H*v FRI power method")
    _add_common(p)
    p.add_argument("--epsilon", type=float, required=True)
    p.add_argument("--vec_nonz", type=int, required=True)

    p = sub.add_parser("frisys_mol", help="systematic HB-PP FCI-FRI (flagship)")
    _add_common(p)
    p.add_argument("--epsilon", type=float, required=True)
    p.add_argument("--vec_nonz", type=int, required=True)
    p.add_argument("--mat_nonz", type=int, required=True)
    p.add_argument("--distribution", default="HB", choices=["HB", "HB_unnorm"])
    p.add_argument("--det_space", help="text file of deterministic-subspace dets")
    p.add_argument("--trial_vec", help="prefix of <prefix>dets/<prefix>vals "
                   "text files for the energy-estimator trial vector")
    p.add_argument("--ini_vec", help="prefix of <prefix>dets/<prefix>vals "
                   "text files for the initial iterate")
    p.add_argument("--ham_shift", type=float,
                   help="energy by which the diagonal of H is shifted "
                   "(default: the HF diagonal element)")

    p = sub.add_parser("frimulti_mol", help="multinomial-compression FRI")
    _add_common(p)
    p.add_argument("--epsilon", type=float, required=True)
    p.add_argument("--vec_nonz", type=int, required=True)
    p.add_argument("--mat_nonz", type=int, required=True)
    p.add_argument("--distribution", default="NU", choices=["NU", "HB"])
    p.add_argument("--trial_vec", help="prefix of <prefix>dets/<prefix>vals "
                   "text files for the energy-estimator trial vector")
    p.add_argument("--ini_vec", help="prefix of <prefix>dets/<prefix>vals "
                   "text files for the initial iterate")
    p.add_argument("--ham_shift", type=float,
                   help="energy by which the diagonal of H is shifted")

    p = sub.add_parser("fciqmc_mol", help="integer-walker initiator FCIQMC")
    _add_common(p)
    p.add_argument("--epsilon", type=float, default=1e-3)
    p.add_argument("--distribution", default="NU", choices=["NU", "HB"])
    p.add_argument("--attempt_cap", type=int, default=0)

    p = sub.add_parser("fciqmc_fp_mol", help="floating-point FCIQMC")
    _add_common(p)
    p.add_argument("--epsilon", type=float, default=1e-3)
    p.add_argument("--distribution", default="HB", choices=["NU", "HB"])
    p.add_argument("--attempt_cap", type=int, default=0)

    p = sub.add_parser("frifull_hh", help="exact H*v FRI, Hubbard-Holstein")
    _add_common(p, molecular=False)
    p.add_argument("--params_path", required=True)
    p.add_argument("--vec_nonz", type=int, required=True)
    p.add_argument("--ph_bits", type=int, default=3)

    p = sub.add_parser("frisys_hh", help="factorized FRI, Hubbard-Holstein")
    _add_common(p, molecular=False)
    p.add_argument("--params_path", required=True)
    p.add_argument("--vec_nonz", type=int, required=True)
    p.add_argument("--mat_nonz", type=int, required=True)
    p.add_argument("--ph_bits", type=int, default=3)

    for name, descr in (
        ("subsp_mol", "multi-state subspace iteration"),
        ("subsp_mol_lowmem", "subspace iteration computing <trial|H|v> on "
         "the fly each step - no stored H*trial rows (calc_h_dot, "
         "molecule.cpp:667-885)"),
        ("subspfull_mol", "subspace iteration with exact H application"),
    ):
        p = sub.add_parser(name, help=descr)
        _add_common(p)
        p.add_argument("--epsilon", type=float, required=True)
        p.add_argument("--vec_nonz", type=int, required=True)
        p.add_argument("--mat_nonz", type=int, required=True)
        p.add_argument("--trial_vecs", required=True,
                       help="prefix of <prefix><xx>dets/<prefix><xx>vals "
                       "2-digit trial files, or a .dice Dice/SHCI output file "
                       "(subsp_mol.cpp:26, 197-235)")
        p.add_argument("--num_trial", "--n_trial", type=int, required=True,
                       dest="n_trial")
        p.add_argument("--restart_int", type=int, default=10)
        p.add_argument("--time_reversal", type=int, default=0,
                       choices=[-1, 0, 1])
        p.add_argument("--out_format", default="txt",
                       choices=["none", "txt", "npy", "bin"],
                       help="h_mat/d_mat output format (subsp_mol.cpp:29; "
                       "npy appends along the leading axis like cnpy)")
        p.add_argument("--ham_shift", type=float,
                       help="energy by which the diagonal of H is shifted")

    p = sub.add_parser("observables_mol", help="Rayleigh observable estimator")
    _add_common(p)
    p.add_argument("--epsilon", type=float, required=True)
    p.add_argument("--vec_nonz", type=int, required=True)
    p.add_argument("--obs_des", type=int, required=True)
    p.add_argument("--obs_cre", type=int, required=True)
    p.add_argument("--exponent", type=float, default=0.5)
    p.add_argument("--burn_in", type=int, default=1000)
    p.add_argument("--n_obs", type=int, default=100)
    p.add_argument("--btw_obs", type=int, default=100)

    p = sub.add_parser("obs_repl_mol", help="replica observable estimator")
    _add_common(p)
    p.add_argument("--epsilon", type=float, required=True)
    p.add_argument("--vec_nonz", type=int, required=True)
    p.add_argument("--obs_des", type=int, required=True)
    p.add_argument("--obs_cre", type=int, required=True)

    p = sub.add_parser("dice_dots", help="dot products between Dice vectors")
    p.add_argument("--vecs1", required=True)
    p.add_argument("--vecs2", required=True)
    p.add_argument("--n_orb", type=int, required=True)
    p.add_argument("--n_states1", type=int, required=True)
    p.add_argument("--n_states2", type=int, required=True)

    args = parser.parse_args(argv)
    cmd = args.cmd

    from fries_tpu import compile_cache
    compile_cache.enable()

    if cmd == "dice_dots":
        return _dice_dots(args)

    if cmd in ("frifull_hh", "frisys_hh"):
        return _run_hh(args, cmd)

    ham, core_en = _load_molecular(args)

    if cmd == "frifull_mol":
        from fries_tpu.drivers import frifull, power

        cfg = power.PowerConfig(
            eps=args.epsilon, target_nonz=args.vec_nonz, capacity=args.max_dets,
            init_thresh=args.init_thresh, target_norm=args.target_norm,
        )
        step, run_steps, state, aux = frifull.build(ham, cfg, seed=args.seed)
        return _run_power_driver(args, step, run_steps, state, aux)

    if cmd == "frisys_mol":
        from fries_tpu import io
        from fries_tpu.drivers import frisys

        determ_keys = None
        if args.det_space:
            determ_keys = io.read_dets(args.det_space, ham.n_bits)
        trial, init_vec = _load_trial_init(args, ham)
        e_ref = _e_ref_from_args(args, core_en)
        if args.n_chips > 1:
            from fries_tpu import parallel

            mesh = parallel.make_mesh(args.n_chips)
            cfg = frisys.FrisysConfig(
                eps=args.epsilon, vec_nonz=args.vec_nonz,
                matr_samp=args.mat_nonz, capacity=args.max_dets,
                spawn_cap=int(args.mat_nonz * 1.4),
                init_thresh=args.init_thresh, target_norm=args.target_norm,
                unnorm=args.distribution == "HB_unnorm",
                axis_name=parallel.AXIS, n_shards=args.n_chips,
            )
            step, run_steps, state, aux = frisys.build_sharded(
                ham, cfg, seed=args.seed, mesh=mesh, trial=trial,
                init_vec=init_vec, e_ref=e_ref, determ_keys=determ_keys,
            )
            return _run_power_driver(
                args, step, run_steps, state, aux,
                protected=aux["protected_keys"],
            )
        cfg = frisys.FrisysConfig(
            eps=args.epsilon, vec_nonz=args.vec_nonz, matr_samp=args.mat_nonz,
            capacity=args.max_dets, spawn_cap=int(args.mat_nonz * 1.4),
            init_thresh=args.init_thresh, target_norm=args.target_norm,
            unnorm=args.distribution == "HB_unnorm",
        )
        step, run_steps, state, aux = frisys.build(
            ham, cfg, seed=args.seed, determ_keys=determ_keys, trial=trial,
            init_vec=init_vec, e_ref=e_ref,
        )
        return _run_power_driver(
            args, step, run_steps, state, aux, protected=aux["protected_keys"]
        )

    if cmd == "frimulti_mol":
        from fries_tpu.drivers import frimulti

        cfg = frimulti.FrimultiConfig(
            eps=args.epsilon, vec_nonz=args.vec_nonz, matr_samp=args.mat_nonz,
            capacity=args.max_dets, spawn_cap=int(args.mat_nonz * 1.4),
            init_thresh=args.init_thresh, target_norm=args.target_norm,
            distribution=args.distribution,
        )
        trial, init_vec = _load_trial_init(args, ham)
        step, run_steps, state, aux = frimulti.build(
            ham, cfg, seed=args.seed, trial=trial, init_vec=init_vec,
            e_ref=_e_ref_from_args(args, core_en),
        )
        return _run_power_driver(args, step, run_steps, state, aux)

    if cmd in ("fciqmc_mol", "fciqmc_fp_mol"):
        from fries_tpu.drivers import fciqmc

        cap = args.attempt_cap or 4 * int(args.target_norm or 100000)
        cfg = fciqmc.FciqmcConfig(
            eps=args.epsilon, target_walkers=args.target_norm,
            capacity=args.max_dets, attempt_cap=cap,
            init_thresh=args.init_thresh, distribution=args.distribution,
            integer_walkers=cmd == "fciqmc_mol",
        )
        step, run_steps, state, aux = fciqmc.build(ham, cfg, seed=args.seed)
        return _run_power_driver(args, step, run_steps, state, aux)

    if cmd in ("subsp_mol", "subsp_mol_lowmem", "subspfull_mol"):
        return _run_subspace(
            args, ham, core_en, exact_h=cmd == "subspfull_mol",
            lowmem=cmd == "subsp_mol_lowmem",
        )

    if cmd in ("observables_mol", "obs_repl_mol"):
        return _run_observables(args, ham, replica=cmd == "obs_repl_mol")

    raise SystemExit(f"unknown command {cmd}")


def _run_hh(args, cmd):
    import jax
    from fries_tpu import io
    from fries_tpu.ops import hubbard as hub
    from fries_tpu.drivers import power

    params = io.parse_hh_input(args.params_path)
    ham = hub.HubbardHolstein(
        n_sites=params["lat_len"], n_elec=params["n_elec"],
        ph_bits=args.ph_bits if params["g"] else 0,
        u=params["u"], omega=params["omega"], g=params["g"],
    )
    e_ref = params["gs_energy"]
    eps = params["eps"]
    if cmd == "frifull_hh":
        from fries_tpu.drivers import frifull_hh

        cfg = power.PowerConfig(
            eps=eps, target_nonz=args.vec_nonz, capacity=args.max_dets,
            init_thresh=args.init_thresh, target_norm=args.target_norm,
        )
        step, run_steps, state, aux = frifull_hh.build(
            ham, e_ref=e_ref, cfg=cfg, seed=args.seed
        )
    else:
        from fries_tpu.drivers import frisys_hh

        cfg = frisys_hh.FrisysHHConfig(
            eps=eps, vec_nonz=args.vec_nonz, matr_samp=args.mat_nonz,
            capacity=args.max_dets, spawn_cap=int(args.mat_nonz * 1.4),
            init_thresh=args.init_thresh, target_norm=args.target_norm,
        )
        step, run_steps, state, aux = frisys_hh.build(
            ham, e_ref=e_ref, cfg=cfg, seed=args.seed
        )
    return _run_power_driver(args, step, run_steps, state, aux)


def _run_subspace(args, ham, core_en=0.0, exact_h=False, lowmem=False):
    import jax
    from fries_tpu import io
    from fries_tpu.drivers import subspace
    from fries_tpu import dets as d

    t = args.n_trial
    keys_list, vals_list = [], []
    for j in range(t):
        if args.trial_vecs.endswith(".dice"):
            # Dice/SHCI output: one file, one block per state
            # (subsp_mol.cpp:199-201, load_vec_dice io_utils.cpp:485-562)
            k, v = io.load_vec_dice(
                args.trial_vecs, ham.n_orb, ham.n_bits, state=j
            )
        else:
            # reference 2-digit naming <prefix>XXdets / <prefix>XXvals
            # (subsp_mol.cpp:202-204); fall back to the legacy <prefix>J_
            # naming for vectors written by older fries_tpu versions
            prefix = f"{args.trial_vecs}{j:02d}"
            if not os.path.exists(prefix + "dets"):
                legacy = f"{args.trial_vecs}{j}_"
                if os.path.exists(legacy + "dets"):
                    prefix = legacy
            k, v = io.load_vec_txt(prefix, ham.n_bits)
        keys_list.append(k)
        vals_list.append(v)
    nmax = max(len(v) for v in vals_list)
    import jax.numpy as jnp

    tk = np.tile(np.asarray(d.invalid_det(ham.n_words)), (t, nmax, 1))
    tv = np.zeros((t, nmax))
    for j in range(t):
        tk[j, : len(vals_list[j])] = keys_list[j]
        tv[j, : len(vals_list[j])] = vals_list[j]

    cfg = subspace.SubspaceConfig(
        eps=args.epsilon, n_trial=t, vec_nonz=args.vec_nonz,
        matr_samp=args.mat_nonz, capacity=args.max_dets,
        spawn_cap=int(args.mat_nonz * 1.4), restart_int=args.restart_int,
        init_thresh=args.init_thresh, exact_h=exact_h, lowmem=lowmem,
        spin_parity=getattr(args, "time_reversal", 0),
    )
    step, run_steps, state, aux = subspace.build(
        ham, cfg, jnp.asarray(tk), jnp.asarray(tv), seed=args.seed,
        e_ref=_e_ref_from_args(args, core_en),
    )
    import dataclasses
    from fries_tpu.runtime import checkpoint

    if getattr(args, "load_dir", None):
        ckpt = os.path.join(args.load_dir, "checkpoint.npz")
        scal = checkpoint.load_scalars(ckpt)
        fields = {"arena": checkpoint.load_arena(ckpt),
                  "key": checkpoint.restore_key(ckpt),
                  "iterat": jnp.asarray(scal["iterat"])}
        for name in ("norm_factors", "last_norms"):
            if name in scal:
                fields[name] = jnp.asarray(scal[name])
        state = dataclasses.replace(state, **fields)
        print(f"resumed from {ckpt} at iteration {int(scal['iterat'])}")
    _write_params(args.result_dir, args)
    fmt = getattr(args, "out_format", "txt")
    hfile = dfile = None
    if fmt == "txt":
        hfile = _out(args.result_dir, "h_mat.txt")
        dfile = _out(args.result_dir, "d_mat.txt")
    elif fmt == "bin":
        # raw little-endian f64 records (subsp_mol.cpp:319-332, 471-477)
        hfile = open(os.path.join(args.result_dir, "h_mat.dat"), "ab")
        dfile = open(os.path.join(args.result_dir, "d_mat.dat"), "ab")
    hnpy = os.path.join(args.result_dir, "h_mat.npy")
    dnpy = os.path.join(args.result_dir, "d_mat.npy")
    # per-iteration metric streams (subsp_mol.cpp:366-380, 416-431, 610-631)
    shift_f = _out(args.result_dir, "shifts.txt")
    norm_f = _out(args.result_dir, "norms.txt")
    nini_f = _out(args.result_dir, "n_ini.txt")
    done = 0
    block = min(args.save_interval, 100)
    while done < args.max_iter:
        n = min(block, args.max_iter - done)
        state, traj = run_steps(state, n)
        h = np.asarray(traj["h_mat"])
        dm = np.asarray(traj["d_mat"])
        if bool(np.asarray(traj["overflow"]).any()):
            raise SystemExit(
                "ERROR: spawn/arena buffer overflow in subspace block ending "
                f"at iteration {done + n}; increase --max_dets / mat_nonz"
            )
        norms_tr = np.asarray(traj["norms"])
        nf_tr = np.asarray(traj["norm_factors"])
        nini_tr = np.asarray(traj.get("n_ini", np.zeros_like(norms_tr)))
        for i in range(h.shape[0]):
            if fmt == "txt":
                hfile.write(",".join(repr(_plain(x)) for x in h[i].ravel()) + "\n")
                dfile.write(",".join(repr(_plain(x)) for x in dm[i].ravel()) + "\n")
            elif fmt == "bin":
                hfile.write(np.ascontiguousarray(h[i], np.float64).tobytes())
                dfile.write(np.ascontiguousarray(dm[i], np.float64).tobytes())
            elif fmt == "npy":
                io.npy_append(hnpy, np.ascontiguousarray(h[i], np.float64))
                io.npy_append(dnpy, np.ascontiguousarray(dm[i], np.float64))
            it = done + i + 1
            if it % cfg.shift_interval == 0:
                shift_f.write(
                    ",".join(repr(_plain(x)) for x in nf_tr[i]) + "\n")
            norm_f.write(",".join(repr(_plain(x)) for x in norms_tr[i]) + "\n")
            nini_f.write(",".join(str(int(_plain(x))) for x in
                                  np.atleast_1d(nini_tr[i])) + "\n")
        for f in (hfile, dfile, shift_f, norm_f, nini_f):
            if f is not None:
                f.flush()
        done += n
        print(f"subspace iteration {done}")
        if done % args.save_interval == 0 or done >= args.max_iter:
            checkpoint.save_state(
                os.path.join(args.result_dir, "checkpoint.npz"), state
            )
    for f in (hfile, dfile, shift_f, norm_f, nini_f):
        if f is not None:
            f.close()


def _run_observables(args, ham, replica):
    from fries_tpu.drivers import observables

    cfg = observables.ObservablesConfig(
        eps=args.epsilon, target_nonz=args.vec_nonz, capacity=args.max_dets,
        obs_des=args.obs_des, obs_cre=args.obs_cre,
        exponent=getattr(args, "exponent", 0.5),
        burn_in=getattr(args, "burn_in", 1000),
        n_obs=getattr(args, "n_obs", 100),
        btw_obs=getattr(args, "btw_obs", 100),
        replica=replica,
    )
    step, run_steps, state, aux = observables.build(ham, cfg, seed=args.seed)
    _write_params(args.result_dir, args)
    numf = _out(args.result_dir, "obs_num.txt")
    denf = _out(args.result_dir, "obs_den.txt")
    done = 0
    block = min(args.save_interval, 200)
    while done < args.max_iter:
        n = min(block, args.max_iter - done)
        state, traj = run_steps(state, n)
        sel = np.asarray(traj["in_obs"]) if not replica else np.ones(n, bool)
        num = np.asarray(traj["obs_num"])[sel]
        den = np.asarray(traj["obs_den"])[sel]
        for x in num:
            numf.write(f"{_plain(x)!r}\n")
        for x in den:
            denf.write(f"{_plain(x)!r}\n")
        numf.flush()
        denf.flush()
        done += n
        print(f"observables iteration {done}")
    numf.close()
    denf.close()


def _dice_dots(args):
    """Dot-product matrix between two sets of Dice/SHCI vectors
    (FRIES_bin/dice_dots.cpp)."""
    from fries_tpu import io

    n_bits = 2 * args.n_orb
    mats = np.zeros((args.n_states1, args.n_states2))
    vecs1 = [
        io.load_vec_dice(args.vecs1, args.n_orb, n_bits, state=i)
        for i in range(args.n_states1)
    ]
    vecs2 = [
        io.load_vec_dice(args.vecs2, args.n_orb, n_bits, state=j)
        for j in range(args.n_states2)
    ]
    for i, (k1, v1) in enumerate(vecs1):
        d1 = {tuple(k): v for k, v in zip(k1, v1)}
        for j, (k2, v2) in enumerate(vecs2):
            mats[i, j] = sum(d1.get(tuple(k), 0.0) * v for k, v in zip(k2, v2))
    print(mats)
    np.savetxt("dice_dots.txt", mats, delimiter=",")


if __name__ == "__main__":
    main()
