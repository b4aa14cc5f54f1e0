"""Production-scale accuracy anchor.

A 12-orbital / 6-electron synthetic system spans C(12,3)^2 = 48 400
determinants - far past the dense-FCI cross-checks in tests/ (<= 3 136
dets) and large enough that production budgets (vec_nonz ~2e4,
matr_samp ~1e5) genuinely compress.  The exact ground state comes from
matrix-free Lanczos (H*v chunked through mol.exact_offdiag_batch over the
full enumerated basis, linalg.lanczos_ground_state); the frisys HB-PP
driver then runs long enough that the statistical bar is ~0.2 mEh, and the
anchor asserts the projected energy agrees with Lanczos on purely
statistical grounds.

Matches the role of the reference's Benchmarks/calc_stats.py exact anchors
(Ne/N2 FCI energies, calc_stats.py:7-10) that its shipped Input_Data cannot
reproduce (no eris.txt); run on a GPU:

    python tools/anchor_scale.py --iters 12000

Results are recorded in PARITY.md.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(
    0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "tests"))
os.environ.setdefault(
    "JAX_COMPILATION_CACHE_DIR",
    os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                 ".jax_cache"))

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax


def full_basis_words(n_orb: int, n_alpha: int, n_beta: int):
    """All determinants of the (n_orb, n_alpha, n_beta) FCI space as
    fries_tpu word arrays, sorted by packed det key."""
    from fries_tpu import dets
    import dense_fci

    masks = dense_fci.spin_basis(n_orb, n_alpha, n_beta)
    n_bits = 2 * n_orb
    words = np.stack([dense_fci.mask_to_words(m, n_bits) for m in masks])
    keys = np.asarray(dets.pack_key(jnp.asarray(words)))
    order = np.argsort(keys)
    return jnp.asarray(words[order])


def make_full_matvec(ham, basis_words, chunk: int = 2048):
    """H*v over the full (sorted) basis via exact enumeration, chunked."""
    from fries_tpu import dets
    from fries_tpu.ops import molecule as mol

    d = basis_words.shape[0]
    tmpl = mol.ExcitationTemplate.build(ham.n_orb, ham.n_elec)
    occ = dets.occ_list(basis_words, ham.n_bits, ham.n_elec)
    diag = mol.diag_matrel_chunked(ham, occ)

    n_chunks = -(-d // chunk)
    pad = n_chunks * chunk - d
    # pad with copies of det 0 carrying zero amplitude (safe matrix elements)
    words_p = jnp.concatenate(
        [basis_words, jnp.tile(basis_words[:1], (pad, 1))])
    occ_p = jnp.concatenate([occ, jnp.tile(occ[:1], (pad, 1))])
    words_c = words_p.reshape(n_chunks, chunk, -1)
    occ_c = occ_p.reshape(n_chunks, chunk, -1)

    @jax.jit
    def hv(v):
        v_p = jnp.concatenate([v, jnp.zeros((pad,), v.dtype)])
        v_c = v_p.reshape(n_chunks, chunk)

        def body(acc, xs):
            wc, oc, vc = xs
            nw, amp, _ = mol.exact_offdiag_batch(ham, tmpl, wc, oc, vc, 1.0)
            fw = nw.reshape(-1, ham.n_words)
            fa = amp.reshape(-1)
            pos, fnd = dets.lookup_dets(basis_words, fw)
            acc = acc.at[jnp.where(fnd, pos, 0)].add(
                jnp.where(fnd, fa, 0.0))
            return acc, None

        y, _ = lax.scan(body, diag * v, (words_c, occ_c, v_c))
        return y

    return hv, diag


def exact_energy(ham, n_alpha, n_beta, m: int = 80, chunk: int = 2048):
    from fries_tpu import linalg

    basis = full_basis_words(ham.n_orb, n_alpha, n_beta)
    hv, _ = make_full_matvec(ham, basis, chunk=chunk)
    e0, ritz = linalg.lanczos_ground_state(hv, basis.shape[0], m=m)
    return e0, ritz, basis


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n_orb", type=int, default=12)
    ap.add_argument("--n_elec", type=int, default=6)
    ap.add_argument("--h_chain", type=float, default=None,
                    help="real-molecule mode: linear H_{n_orb} chain at this "
                         "bond length (bohr) from the hand-rolled STO-3G "
                         "integrals (fries_tpu/sto3g.py) instead of the "
                         "random synthetic system; n_elec = n_orb")
    ap.add_argument("--seed", type=int, default=5)
    ap.add_argument("--iters", type=int, default=12000)
    ap.add_argument("--burn", type=int, default=2000)
    ap.add_argument("--block", type=int, default=1000)
    ap.add_argument("--vec_nonz", type=int, default=20000)
    ap.add_argument("--matr_samp", type=int, default=100000)
    ap.add_argument("--lanczos_m", type=int, default=80)
    ap.add_argument("--capacity", type=int, default=1 << 17)
    ap.add_argument("--eps", type=float, default=0.02)
    ap.add_argument("--scan", type=int, default=25,
                    help="iterations per on-device scan; blocks run as "
                         "chained scans of this length")
    ap.add_argument("--e0", type=float, default=None,
                    help="skip Lanczos, use this exact ground-state energy "
                         "(must match n_orb/n_elec/seed; forces trial_k=0)")
    ap.add_argument("--cache", default=None,
                    help="cache file for the Lanczos solve (e0 + Ritz "
                         "vector + basis); default is derived from the "
                         "system parameters")
    ap.add_argument("--trial_k", type=int, default=256,
                    help="estimator trial vector = the top-k components of "
                         "the Lanczos Ritz vector (the production analogue "
                         "of the reference's CISD/HCI trials, "
                         "frisys_mol.cpp:159-214; 0 = HF-only trial)")
    args = ap.parse_args()

    from fries_tpu import stats, synth
    from fries_tpu.drivers import frisys

    core_energy = 0.0
    if args.h_chain is not None:
        from fries_tpu import sto3g

        args.n_elec = args.n_orb
        ham, core_energy = sto3g.h_chain(args.h_chain, args.n_orb,
                                         basis="rhf")
        print(f"# H{args.n_orb} chain R={args.h_chain} bohr (RHF MOs) "
              f"E_nuc={core_energy:.6f}", flush=True)
    else:
        ham = synth.make_system(args.n_orb, args.n_elec, seed=args.seed,
                                scale_two=0.1)
    half = args.n_elec // 2
    if args.cache is None:
        tag = (f"h{args.n_orb}_r{args.h_chain}" if args.h_chain is not None
               else f"synth{args.n_orb}_{args.n_elec}_s{args.seed}")
        args.cache = f"/tmp/anchor_lanczos_{tag}.npz"
        if (args.h_chain is None and args.n_orb == 12 and args.n_elec == 6
                and args.seed == 5
                and os.path.exists("/tmp/anchor_lanczos.npz")):
            args.cache = "/tmp/anchor_lanczos.npz"  # pre-rename cache

    t0 = time.time()
    ritz = None
    if args.e0 is not None:
        from math import comb

        e0 = args.e0
        dim = comb(args.n_orb, half) * comb(args.n_orb, args.n_elec - half)
    elif os.path.exists(args.cache):
        d = np.load(args.cache)
        e0 = float(d["e0"])
        ritz = d["ritz"]
        basis = jnp.asarray(d["basis"])
        dim = basis.shape[0]
    else:
        e0, ritz, basis = exact_energy(ham, half, args.n_elec - half,
                                       m=args.lanczos_m)
        np.savez(args.cache, e0=e0, ritz=np.asarray(ritz),
                 basis=np.asarray(basis))
        dim = basis.shape[0]
    t_lanczos = time.time() - t0
    print(f"# dim={dim} lanczos E0={e0:.9f} ({t_lanczos:.0f}s)", flush=True)

    trial = None
    if args.trial_k and ritz is not None:
        # HF-only trials measured 2 sigma = 5.6 Ha over 12k iterations here
        # (IAT 54, per-sample swings of tens of Ha): the random 12-orbital
        # system is strongly correlated and the HF weight is tiny.  The
        # reference's production runs project against CISD/HCI trial
        # vectors for exactly this reason (Input_Data *cisd* files,
        # frisys_mol.cpp:159-214); the Ritz top-k is this run's equivalent.
        idx = np.argsort(-np.abs(np.asarray(ritz)))[:args.trial_k]
        tv = np.asarray(ritz)[idx]
        trial = (np.asarray(basis)[idx], tv / np.abs(tv).max())
        print(f"# trial: top-{args.trial_k} Ritz components "
              f"(|c| >= {np.abs(tv).min():.2e})", flush=True)

    cfg = frisys.FrisysConfig(
        eps=args.eps, vec_nonz=args.vec_nonz, matr_samp=args.matr_samp,
        capacity=args.capacity, spawn_cap=4 * args.matr_samp,
        target_norm=2.0 * args.vec_nonz, init_thresh=1.0,
    )
    step, run_steps, state, aux = frisys.build(ham, cfg, seed=args.seed + 1,
                                               trial=trial)
    nums, dens = [], []
    t0 = time.time()
    n_blocks = -(-args.iters // args.block)
    n_sub = -(-args.block // args.scan)
    for i in range(n_blocks):
        for _ in range(n_sub):
            state, traj = run_steps(
                state, aux["num_keys"], aux["num_vals"], aux["den_keys"],
                aux["den_vals"], aux["ref_key"], args.scan,
            )
            nums.append(np.asarray(traj["proj_num"]))
            dens.append(np.asarray(traj["proj_den"]))
        ov = bool(np.asarray(traj["overflow"]).any())
        print(f"# block {i + 1}/{n_blocks} overflow={ov} "
              f"({time.time() - t0:.0f}s)", flush=True)
        assert not ov, "arena overflow"
    num = np.concatenate(nums)
    den = np.concatenate(dens)
    exact_corr = e0 - float(aux["e_ref"])
    out = stats.trajectory_stats(num, den, exact_corr=exact_corr,
                                 burn_in=args.burn)
    result = {
        "dim": dim,
        "system": (f"H{args.n_orb}/STO-3G R={args.h_chain}"
                   if args.h_chain is not None
                   else f"synth-{args.n_orb}o{args.n_elec}e"),
        "e_total": e0 + core_energy,
        "lanczos_e0": e0,
        "e_ref": float(aux["e_ref"]),
        "exact_corr": exact_corr,
        "iters": args.iters,
        "vec_nonz": args.vec_nonz,
        "matr_samp": args.matr_samp,
        "error_mEh": float(out["error_mEh"]),
        "two_sigma_mEh": float(out["two_sigma_mEh"]),
        "iat": float(out["iat"]),
        "efficiency": float(out["efficiency"]),
        "sec_per_iter": (time.time() - t0) / args.iters,
    }
    print(json.dumps(result))
    ok = abs(result["error_mEh"]) < 3 * result["two_sigma_mEh"]
    print(f"# |error| < 3*2sigma: {ok}")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
