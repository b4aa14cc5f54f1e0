"""Smoke check of fries_tpu on NVIDIA GPUs.

Runs the system's main path once on the card and checks what comes out:

  1. device gate: JAX's first device must be a GPU (no CPU fallback);
  2. physics at small size through the CLI: frisys_mol on a 6-orbital
     synthetic molecule against dense FCI, and frifull_hh on the 6-site
     U=2 Hubbard chain against its exact ground state;
  3. kernels at the N2/cc-pVDZ 1e6 widths against plain references: the
     arena merge (GPU vs CPU in this process), every ``kernels.py`` helper
     (vs numpy), and the HB-PP exact reconstruction on N2;
  4. the flagship run: frisys_mol on real N2/cc-pVDZ at 1e6 kept
     determinants, through ``fries_tpu.cli.main``.

With ``--four-gpus`` it runs the hash-sharded path on four GPUs instead,
and nothing else: frifull build_sharded vs build, the spawn exchange against
numpy over repeated runs, and frisys_mol --n_chips 4 on N2 at 1e6 kept
determinants per GPU.

Usage (from the checkout root):
    python chip_smoke.py [--seed N]
    python chip_smoke.py --four-gpus

Each phase prints one line per check.  The last line of standard output is
one JSON object, {"ok": true, "device": {...}}, printed only when every
phase passed; otherwise the exit code is 1.  With no GPU the exit code is 2.
"""

from __future__ import annotations

import argparse
import contextlib
import io as _io
import json
import os
import shutil
import subprocess
import sys
import time
import traceback

HERE = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(HERE, "results", "chip_smoke")

# N2/cc-pVDZ 1e6-rung widths: the flagship budget of the CLI run below
N2_ARGS = ["--vec_nonz", "1000000", "--mat_nonz", "1000000",
           "--max_dets", "2097152", "--epsilon", "1e-3",
           "--target", "2000000", "--distribution", "HB"]
FULL = dict(
    capacity=1 << 21,   # arena rows (--max_dets)
    spawns=1_032_768,   # merge stream and spawner stage rows at the 1e6 rung
    n_live=1_000_000,   # live arena rows after compression
)
FLAGSHIP_ITERS = 300    # 100 to compile and settle, 200 timed


def log(msg: str) -> None:
    print(msg, flush=True)


def card_info() -> str:
    """Name and power limit of every card, read by nvidia-smi (a child that
    stays off JAX)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return "; ".join(l.strip() for l in out.splitlines() if l.strip())


def device_gate(n_needed: int = 1):
    """Phase 1: the first JAX device must be a GPU; exits 2 otherwise."""
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        log(f"device gate: FAIL (first JAX device is {devs[0].platform}, "
            "not gpu; there is no CPU fallback)")
        raise SystemExit(2)
    if len(devs) < n_needed:
        log(f"device gate: FAIL ({len(devs)} GPUs, need {n_needed})")
        raise SystemExit(2)
    log(f"device gate: ok platform={devs[0].platform} "
        f"kind={devs[0].device_kind} count={len(devs)}")
    return devs


def _cli(argv, log_name):
    """fries_tpu.cli.main(argv) in-process, its stdout kept in a log file."""
    from fries_tpu import cli

    buf = _io.StringIO()
    with contextlib.redirect_stdout(buf):
        cli.main(argv)
    with open(os.path.join(OUT, log_name), "w") as f:
        f.write(buf.getvalue())


def _stream(result_dir, name):
    import numpy as np

    return np.loadtxt(os.path.join(result_dir, name), delimiter=",", ndmin=1)


def check(ok: bool, line: str) -> None:
    log(("  ok   " if ok else "  FAIL ") + line)
    if not ok:
        raise AssertionError(line)


# ---------------------------------------------------------------------------
# phase 2: physics at small size, through the CLI
# ---------------------------------------------------------------------------

def phase_small_physics() -> None:
    import numpy as np

    sys.path.insert(0, os.path.join(HERE, "tests"))
    import dense_fci
    from test_hubbard import EXACT_6SITE_U2_GS
    from fries_tpu import io, synth
    from fries_tpu.ops import molecule as mol

    # the verify recipe: synthetic (6 orb, 4 elec) molecule vs dense FCI
    ham = synth.make_system(6, 4, seed=3)
    fcidump = os.path.join(OUT, "verify_fcidump")
    io.write_fcidump(ham, fcidump)
    h_dense, _ = dense_fci.build_hamiltonian(
        np.asarray(ham.hcore), np.asarray(ham.eris), ham.n_orb, 2, 2)
    e_corr = dense_fci.ground_state(h_dense)[0] - float(
        mol.hf_reference(ham)[2])
    rdir = os.path.join(OUT, "verify_run")
    _cli(["frisys_mol", "--fcidump_path", fcidump, "--distribution", "HB",
          "--epsilon", "0.02", "--vec_nonz", "400", "--mat_nonz", "1200",
          "--max_dets", "4096", "--max_iter", "600", "--target", "600",
          "--result_dir", rdir, "--seed", "7"], "verify_run.log")
    num, den = _stream(rdir, "projnum.txt"), _stream(rdir, "projden.txt")
    est = float(np.mean((num / den)[len(num) // 2:]))
    err = est - e_corr
    check(abs(err) < 1e-3,
          f"frisys_mol 6-orb synthetic, 600 iters: mean E_corr {est:.6f} vs "
          f"dense FCI {e_corr:.6f} Eh, error {err:+.2e} (limit 1e-3, f64)")

    # exact-H Hubbard: 6-site half-filled U=2 chain, offset energy origin
    params = os.path.join(OUT, "hubbard_params.txt")
    e_ref = EXACT_6SITE_U2_GS + 0.05
    with open(params, "w") as f:
        f.write(f"n_elec\n6\nlat_len\n6\nn_dim\n1\neps\n0.05\nU\n2.0\n"
                f"omega\n0.0\ng\n0.0\ngs_energy\n{e_ref!r}\n")
    rdir = os.path.join(OUT, "hubbard_run")
    _cli(["frifull_hh", "--params_path", params, "--vec_nonz", "2048",
          "--max_dets", "512", "--max_iter", "1200", "--result_dir", rdir,
          "--seed", "1"], "hubbard_run.log")
    num, den = _stream(rdir, "projnum.txt"), _stream(rdir, "projden.txt")
    e_tot = e_ref + float(num[-1] / den[-1])
    err = e_tot - EXACT_6SITE_U2_GS
    check(abs(err) < 1e-3,
          f"frifull_hh 6-site U=2 Hubbard, 1200 iters: E {e_tot:.8f} vs "
          f"exact {EXACT_6SITE_U2_GS:.8f}, error {err:+.2e} "
          "(limit 1e-3, f64)")


# ---------------------------------------------------------------------------
# phase 3: kernels at real widths against plain references
# ---------------------------------------------------------------------------

def _merge_case(rng, capacity, n_live, n_spawn, n_rows):
    """A sorted arena with ``n_live`` rows and a spawn stream of
    ``n_spawn`` rows (half onto arena keys, 10% sentinel, 60% initiator),
    with 52-bit keys in two words as N2/cc-pVDZ has."""
    import numpy as np
    import jax.numpy as jnp
    from fries_tpu import dets
    from fries_tpu.runtime import arena as ar

    raw = rng.integers(0, 1 << 52, size=n_live + n_spawn, dtype=np.int64)
    raw = np.unique(raw)
    rng.shuffle(raw)
    words = np.stack([raw & 0xFFFFFFFF, raw >> 32], axis=1).astype(np.uint32)
    live = words[:n_live]
    packed = np.asarray(dets.pack_key(jnp.asarray(live)))
    live = live[np.argsort(packed, kind="stable")]
    keys = np.tile(np.asarray(dets.invalid_det(2)), (capacity, 1))
    keys[:n_live] = live
    vals = np.zeros((n_rows, capacity))
    vals[:, :n_live] = rng.standard_normal((n_rows, n_live))
    vals[:, :n_live][rng.random((n_rows, n_live)) < 0.2] = 0.0
    arena = ar.Arena(keys=keys, vals=vals,
                     n_used=np.asarray([n_live], np.int32))

    from_arena = rng.random(n_spawn) < 0.5
    skeys = np.where(
        from_arena[:, None],
        live[rng.integers(0, n_live, n_spawn)],
        words[n_live + rng.integers(0, len(words) - n_live, n_spawn)])
    skeys[rng.random(n_spawn) < 0.1] = np.asarray(dets.invalid_det(2))
    svals = rng.standard_normal(n_spawn) * 0.3
    sini = rng.random(n_spawn) < 0.6
    srows = rng.integers(0, n_rows, n_spawn).astype(np.int32)
    keep = rng.random(capacity) < 0.05
    return arena, skeys, svals, sini, srows, keep


def _timed(fn, *args, reps=5):
    """(result, median seconds over ``reps`` calls after one warm call),
    each call ended by block_until_ready."""
    import jax

    out = jax.block_until_ready(fn(*args))
    secs = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn(*args))
        secs.append(time.perf_counter() - t0)
    return out, sorted(secs)[len(secs) // 2]


def _compare_arenas(name, got, want, stats_got, stats_want, svals, card):
    import numpy as np

    gk, wk = np.asarray(got.keys), np.asarray(want.keys)
    gv, wv = np.asarray(got.vals), np.asarray(want.vals)
    keys_ok = np.array_equal(gk, wk) and int(got.n_used[0]) == int(
        want.n_used[0])
    stats_ok = all(
        np.asarray(stats_got[k]).item() == np.asarray(stats_want[k]).item()
        for k in ("overflow", "nonini_occ_add"))
    # segment sums are cumsum differences: their rounding is bounded by the
    # largest partial sum of the spawn stream, whose order differs per device
    atol = 1e-12 * float(np.max(np.abs(np.cumsum(svals))))
    err = np.abs(gv - wv)
    vals_ok = bool(np.all(err <= 1e-12 * np.abs(wv) + atol))
    check(keys_ok and stats_ok and vals_ok,
          f"{name}: keys+counts bit-exact={keys_ok and stats_ok}, values "
          f"max|d|={err.max():.2e} (rtol 1e-12, atol {atol:.1e} = 1e-12 x "
          f"max partial sum; f64) GPU vs CPU [{card}]")


def phase_merge(seed: int, sizes: dict, card: str, timings: dict) -> None:
    import numpy as np
    import jax
    from fries_tpu.runtime import arena as ar

    cpu = jax.devices("cpu")[0]
    gpu = jax.devices()[0]
    rng = np.random.default_rng(seed)
    c, s = sizes["capacity"], sizes["spawns"]

    # power-step layout: origin row 0 gates, row 1 receives, dead rows go
    arena, sk, sv, si, _, keep = _merge_case(rng, c, sizes["n_live"], s, 2)
    arena = ar.Arena(keys=arena.keys, vals=arena.vals.copy(),
                     n_used=arena.n_used)
    arena.vals[1] = 0.0

    def power_merge(a, sk, sv, si, keep):
        a = ar.compact(a, (a.vals[0] != 0) | keep)
        return ar.accumulate(a, sk, sv, si, origin_row=0, dest_row=1)

    def put(dev):
        return jax.device_put((arena, sk, sv, si, keep), dev)

    (g_arena, g_stats), t_gpu = _timed(power_merge, *put(gpu))
    w_arena, w_stats = power_merge(*put(cpu))
    _compare_arenas(f"compact+accumulate C=2^{c.bit_length() - 1} S={s}",
                    g_arena, w_arena, g_stats, w_stats, sv, card)
    (_, _), t_acc = _timed(
        lambda a, sk, sv, si: ar.accumulate(a, sk, sv, si, 0, 1),
        *put(gpu)[:4])
    timings["merge_ms"] = t_gpu * 1e3
    timings["accumulate_ms"] = t_acc * 1e3
    log(f"  info compact+accumulate {t_gpu * 1e3:.2f} ms, accumulate alone "
        f"{t_acc * 1e3:.2f} ms (median of 5, block_until_ready) [{card}]")

    # subspace layout: two rows, each spawn carries its destination row
    arena, sk, sv, si, srows, _ = _merge_case(rng, c, sizes["n_live"], s, 2)
    args = (arena, sk, sv, srows, si)
    (g_arena, g_stats), t_multi = _timed(ar.accumulate_multi,
                                         *jax.device_put(args, gpu))
    w_arena, w_stats = ar.accumulate_multi(*jax.device_put(args, cpu))
    _compare_arenas(f"accumulate_multi R=2 C=2^{c.bit_length() - 1} S={s}",
                    g_arena, w_arena, g_stats, w_stats, sv, card)
    log(f"  info accumulate_multi {t_multi * 1e3:.2f} ms [{card}]")


def phase_helpers(seed: int, sizes: dict, card: str) -> None:
    import numpy as np
    import jax
    import jax.numpy as jnp
    from fries_tpu import kernels

    rng = np.random.default_rng(seed + 1)
    s, c = sizes["spawns"], sizes["capacity"]
    n_orb, n_elec = 26, 10
    n_virt = n_orb - n_elec // 2
    k_cd = n_elec * n_virt

    def exact(name, got, want):
        got, want = np.asarray(got), np.asarray(want)
        ok = got.shape == want.shape and np.array_equal(got, want)
        check(ok, f"{name}: bit-exact vs numpy (shape {want.shape}) "
              f"[{card}]")

    symm = rng.integers(0, 8, n_orb).astype(np.int32)
    idx = rng.integers(0, n_orb, (s, n_elec)).astype(np.int32)
    exact("take_small symm[(S, 10)]", kernels.take_small(
        jnp.asarray(symm), jnp.asarray(idx)), symm[idx])
    table = rng.standard_normal((n_orb, n_orb))
    i = rng.integers(0, n_orb, s).astype(np.int32)
    j = rng.integers(0, n_orb, s).astype(np.int32)
    exact("take_rows_small f64 (26, 26)[(S,)]", kernels.take_rows_small(
        jnp.asarray(table), jnp.asarray(i)), table[i])
    exact("take2_small f64 (26, 26)[(S,), (S,)]", kernels.take2_small(
        jnp.asarray(table), jnp.asarray(i), jnp.asarray(j)), table[i, j])
    rows = rng.standard_normal((s, n_virt))
    jv = rng.integers(0, n_virt, s).astype(np.int32)
    exact("take_along_small f64 (S, 21)[(S,)]", kernels.take_along_small(
        jnp.asarray(rows), jnp.asarray(jv)), rows[np.arange(s), jv])

    # occupied lists of the arena: rank_place over (C, 52) occupancy bits
    bits = rng.random((c, 2 * n_orb)) < n_elec / (2 * n_orb)
    rank = np.cumsum(bits, axis=1) - 1
    occ = np.full((c, n_elec), 2 * n_orb, np.int32)
    r, col = np.nonzero(bits & (rank < n_elec))
    occ[r, rank[r, col]] = col
    pos = np.broadcast_to(np.arange(2 * n_orb, dtype=np.int32), bits.shape)
    exact("rank_place (C, 52) -> (C, 10)", kernels.rank_place(
        jnp.asarray(pos), jnp.asarray(bits), n_elec, jnp.int32(2 * n_orb)),
        occ)

    # f32 products at HIGHEST: a one-hot matmul must select exactly (TF32
    # would keep ~10 mantissa bits of the table)
    t32 = rng.standard_normal((n_orb, 64)).astype(np.float32)
    onehot = jax.nn.one_hot(jnp.asarray(i), n_orb, dtype=jnp.float32)
    exact("one-hot f32 matmul (S, 26) @ (26, 64), default precision "
          "(HIGHEST)", jnp.matmul(onehot, jnp.asarray(t32)), t32[i])

    counts = rng.integers(0, 3, (c, n_orb)).astype(np.float64)
    got = np.asarray(kernels.count_matmul_f64(jnp.asarray(counts),
                                              jnp.asarray(table)))
    want = counts @ table
    bound = np.abs(counts) @ np.abs(table)
    err = np.abs(got - want) / bound
    check(err.max() <= 1e-14,
          f"count_matmul_f64 (C, 26) @ (26, 26): max |d| / sum|terms| "
          f"{err.max():.2e} (rtol 1e-14, f64) [{card}]")

    mask = rng.random((s, k_cd)) < 0.4
    exact(f"row_cumsum bool (S, {k_cd})",
          kernels.row_cumsum(jnp.asarray(mask)),
          np.cumsum(mask, axis=1).astype(np.float32))
    w = rng.random((s, k_cd)).astype(np.float32)
    w /= w.sum(axis=1, keepdims=True)
    got = np.asarray(kernels.row_cumsum(jnp.asarray(w)), np.float64)
    want = np.cumsum(w.astype(np.float64), axis=1)
    rel = np.abs(got - want) / want
    check(rel.max() <= 1e-6,
          f"row_cumsum f32 weights (S, {k_cd}): max rel {rel.max():.2e} "
          f"(rtol 1e-6 vs f64 numpy) [{card}]")


def phase_hbpp_exact(ham, card: str) -> None:
    """Budgets above the path counts: the five HB-PP levels keep every path
    and reproduce -eps * H_offdiag * v exactly (f64 stage rows)."""
    import numpy as np
    import jax
    import jax.numpy as jnp
    from fries_tpu import dets
    from fries_tpu.drivers import frisys
    from fries_tpu.ops import heat_bath as hb
    from fries_tpu.ops import molecule as mol
    from fries_tpu.runtime import arena as ar

    syminfo = mol.SymmInfo.build(np.asarray(ham.symm))
    tens = hb.setup(ham)
    p_doub = frisys.hf_p_doub(ham, syminfo)
    tmpl = mol.ExcitationTemplate.build(ham.n_orb, ham.n_elec)
    hf_words, hf_occ, _ = mol.hf_reference(ham)
    eps = 1e-3

    # HF plus its two largest double excitations (symmetry-allowed)
    w1, a1, _ = mol.exact_offdiag_batch(
        ham, tmpl, hf_words[None], hf_occ[None], jnp.ones((1,)), 1.0)
    w1, a1 = np.asarray(w1).reshape(-1, ham.n_words), np.asarray(a1).ravel()
    top = np.argsort(-np.abs(a1))[:2]
    keys = jnp.asarray(np.concatenate([np.asarray(hf_words)[None], w1[top]]))
    a = ar.from_unsorted(ar.make(8, ham.n_words, 1), keys,
                         jnp.asarray([[1.0, -0.5, 0.25]]))
    avals = jnp.where(a.valid, a.vals[0], 0.0)
    aocc = dets.occ_list(a.keys, ham.n_bits, ham.n_elec)
    ew, ea, _ = mol.exact_offdiag_batch(ham, tmpl, a.keys, aocc, avals, -eps)
    n_paths = int(np.count_nonzero(np.asarray(ea)))

    cfg = frisys.FrisysConfig(
        eps=eps, vec_nonz=64, matr_samp=10 * n_paths, capacity=8,
        spawn_cap=1 << (16 * n_paths).bit_length(), stage_f32=False)
    spawn = frisys.make_hbpp_spawner(ham, tens, syminfo, p_doub, cfg,
                                     e_ref=0.0)
    w, amp, _ = jax.jit(spawn)(a.keys, avals, -eps, jax.random.key(0))

    def summed(words, amps):
        words = np.asarray(words).reshape(-1, ham.n_words)
        amps = np.asarray(amps).ravel()
        live = amps != 0
        packed = np.asarray(dets.pack_key(jnp.asarray(words[live])))
        uq, inv = np.unique(packed, return_inverse=True)
        return dict(zip(uq.tolist(), np.bincount(inv, amps[live]).tolist()))

    got, want = summed(w, amp), summed(ew, ea)
    allk = sorted(set(got) | set(want))
    g = np.asarray([got.get(k, 0.0) for k in allk])
    x = np.asarray([want.get(k, 0.0) for k in allk])
    # norm-wise: elements far below the largest carry the cancellation error
    # of the selection-probability sums (calc_norm_wt), not of the device
    rel = np.abs(g - x).sum() / np.abs(x).sum()
    big = np.abs(x) >= 1e-6 * np.abs(x).max()
    rel_big = np.max(np.abs(g - x)[big] / np.abs(x)[big])
    check(set(got) == set(want) and rel <= 1e-10 and rel_big <= 1e-10,
          f"HB-PP exact reconstruction on N2/cc-pVDZ ({len(want)} targets "
          f"of 3 dets): |d|_1/|x|_1 {rel:.2e}, max rel over elements >= "
          f"1e-6 max|x| {rel_big:.2e} (rtol 1e-10, f64) [{card}]")


# ---------------------------------------------------------------------------
# phase 4: the flagship run through the CLI
# ---------------------------------------------------------------------------

def n2_fcidump() -> str:
    """Real N2/cc-pVDZ (26 active orbitals, 10 electrons, frozen 1s),
    built on the host CPU and written as an FCIDUMP."""
    import jax
    from fries_tpu import io

    sys.path.insert(0, os.path.join(HERE, "tools"))
    import real_systems

    with jax.default_device(jax.devices("cpu")[0]):
        ham = real_systems.n2_ccpvdz()
        path = os.path.join(OUT, "n2_ccpvdz_fcidump")
        io.write_fcidump(ham, path, point_group="D2h")
    return path


def phase_flagship(fcidump, iters: int, card: str, vec_nonz=1_000_000,
                   extra=(), name="frisys_mol", block=100) -> dict:
    import numpy as np
    import jax

    rdir = os.path.join(OUT, name)
    argv = ["frisys_mol", "--fcidump_path", fcidump, "--point_group", "D2h",
            *N2_ARGS, "--max_iter", str(iters), "--save_interval", str(block),
            "--result_dir", rdir, "--seed", "0", *extra]
    t0 = time.perf_counter()
    try:
        _cli(argv, f"{name}.log")
        overflow = False
    except SystemExit as e:
        overflow = "overflow" in str(e)
        if not overflow:
            raise
    wall_total = time.perf_counter() - t0
    check(not overflow, f"{name} N2/cc-pVDZ {' '.join(argv[5:])}: no "
          "overflow abort")
    num, den = _stream(rdir, "projnum.txt"), _stream(rdir, "projden.txt")
    nnonz = _stream(rdir, "nnonz.txt")
    wall = np.loadtxt(os.path.join(rdir, "wall.txt"), delimiter=",",
                      ndmin=2)
    e_last = float(num[-1] / den[-1])
    check(len(num) == iters and bool(np.all(np.isfinite(num / den))),
          f"{name}: {len(num)} iterations, projected E_corr finite "
          f"(last {e_last:.6f} Eh)")
    kept = int(nnonz[-1])
    check(0.9 * vec_nonz <= kept <= 1.01 * vec_nonz,
          f"{name}: kept determinants after compression {kept} "
          f"(expect ~{vec_nonz})")
    steady = wall[1:]
    ms_iter = 1e3 * steady[:, 2].sum() / steady[:, 1].sum()
    compile_s = wall[0, 2] - wall[0, 1] * ms_iter / 1e3
    peak = (jax.devices()[0].memory_stats() or {}).get(
        "peak_bytes_in_use", 0)
    log(f"  info {name}: {ms_iter:.1f} ms/iter over {int(steady[:, 1].sum())}"
        f" iterations after the first block of {int(wall[0, 1])} "
        f"(block_until_ready), compile ~{compile_s:.1f} s, CLI wall "
        f"{wall_total:.1f} s, peak device memory (device 0) "
        f"{peak / 2**30:.2f} GiB [{card}]")
    return {"ms_per_iter": ms_iter, "compile_s": compile_s,
            "peak_bytes_in_use": peak}


# ---------------------------------------------------------------------------
# phase 5 (--four-gpus): the hash-sharded path
# ---------------------------------------------------------------------------

def phase_sharded_exact(devs, card: str, blocks: int = 3,
                        block_iters: int = 10) -> None:
    """frifull build_sharded on the mesh against build on one GPU, run as
    ``blocks`` calls of one compiled program each, so a fault that shows
    only on a program's repeated execution fails the check."""
    import numpy as np
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    sys.path.insert(0, os.path.join(HERE, "tests"))
    import dense_fci
    from fries_tpu import parallel
    from fries_tpu.drivers import frifull, power
    from fries_tpu.ops import molecule as mol

    n = len(devs)
    rng = np.random.default_rng(41)
    h, eris = dense_fci.random_integrals(rng, 5)
    ham = mol.MolecularHamiltonian(
        hcore=jnp.asarray(h), eris=jnp.asarray(eris),
        symm=jnp.zeros(5, jnp.int32), n_orb=5, n_elec=4)

    def blocked(run, st, aux):
        trs = []
        for _ in range(blocks):
            st, tr = run(st, aux["num_keys"], aux["num_vals"],
                         aux["den_keys"], aux["den_vals"], aux["ref_key"],
                         block_iters)
            trs.append({k: np.asarray(tr[k]) for k in
                        ("proj_num", "proj_den", "norm", "overflow")})
        return {k: np.concatenate([t[k] for t in trs]) for k in trs[0]}

    cfg1 = power.PowerConfig(eps=0.05, target_nonz=256, capacity=128)
    with jax.default_device(devs[0]):
        _, run1, st1, aux1 = frifull.build(ham, cfg1, seed=0)
        tr1 = blocked(run1, st1, aux1)
    mesh = Mesh(np.asarray(devs), (parallel.AXIS,))
    cfgn = power.PowerConfig(
        eps=0.05, target_nonz=256, capacity=64, axis_name=parallel.AXIS,
        n_shards=n, exchange_cap=512)
    _, runn, stn, auxn = frifull.build_sharded(ham, cfgn, seed=0, mesh=mesh)
    trn = blocked(runn, stn, auxn)
    e1 = tr1["proj_num"] / tr1["proj_den"]
    en = trn["proj_num"] / trn["proj_den"]
    # |d| <= 1e-9 |e| + 1e-11: the estimator starts at exactly 0
    rel = np.max(np.abs(en - e1) / (np.abs(e1) + 1e-2))
    e_ok = bool(np.all(np.abs(en - e1) <= 1e-9 * np.abs(e1) + 1e-11))
    nrel = np.max(np.abs(trn["norm"] / tr1["norm"] - 1))
    ok = (e_ok and nrel <= 1e-9 and not tr1["overflow"].any()
          and not trn["overflow"].any())
    check(ok, f"frifull build_sharded on {n} GPUs vs build on 1 GPU, "
          f"{blocks} runs x {block_iters} iters of one compiled program: "
          f"energy max |d|/(|e|+1e-2) {rel:.2e} (rtol 1e-9, atol 1e-11), "
          f"norm max rel {nrel:.2e} (rtol 1e-9); f64 [{card}]")


def phase_exchange(devs, card: str, seed: int, s_local: int = 100_000,
                   per_pair_cap: int = 40_000, runs: int = 3) -> None:
    """The spawn exchange at the production shape, one compiled program run
    ``runs`` times on fresh inputs, every run checked against a global
    accumulation of its own rows in numpy."""
    import numpy as np
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, PartitionSpec as P
    from fries_tpu import dets, parallel
    from fries_tpu.runtime import shard as sh

    n = len(devs)
    mesh = Mesh(np.asarray(devs), (parallel.AXIS,))
    rng = np.random.default_rng(seed + 3)

    def body(k, a):
        k, a = k[0], a[0]
        tgt = sh.shard_of_words(k, n)
        rec, ovf = sh.exchange({"keys": k, "amps": a}, tgt, n, per_pair_cap,
                               parallel.AXIS)
        return (rec["keys"][None], rec["amps"][None],
                ovf.astype(jnp.int32)[None])

    f = jax.jit(jax.shard_map(
        body, mesh=mesh, in_specs=(P(parallel.AXIS), P(parallel.AXIS)),
        out_specs=(P(parallel.AXIS),) * 3))

    def wrong_rows(words, amps, rk, ra, ovf):
        """Keys missing from, or foreign to, each shard's received rows, or
        sums off by more than 1e-12; plus the overflow flag."""
        uq, inv = np.unique(words[..., 0].ravel().astype(np.int64),
                            return_inverse=True)
        ref = np.bincount(inv, amps.ravel())
        owner = np.asarray(sh.shard_of_words(
            jnp.asarray(np.stack([uq.astype(np.uint32),
                                  np.zeros_like(uq, np.uint32)], 1)), n))
        rk, ra = np.asarray(rk), np.asarray(ra)
        bad = int(np.asarray(ovf).any())
        for s in range(n):
            valid = ~np.asarray(dets.is_invalid(jnp.asarray(rk[s])))
            got_k, got_inv = np.unique(rk[s][valid][:, 0].astype(np.int64),
                                       return_inverse=True)
            got = np.bincount(got_inv, ra[s][valid])
            mine = uq[owner == s]
            if not (got_k.shape == mine.shape
                    and np.array_equal(got_k, mine)):
                bad += len(np.setxor1d(got_k, mine))
                continue
            bad += int(np.sum(np.abs(got - ref[owner == s]) > 1e-12))
        return bad

    bad, secs = [], []
    for _ in range(runs):
        words = np.zeros((n, s_local, 2), np.uint32)
        words[..., 0] = rng.integers(0, 1 << 24, size=(n, s_local))
        amps = rng.standard_normal((n, s_local))
        x = (jnp.asarray(words), jnp.asarray(amps))
        t0 = time.perf_counter()
        out = jax.block_until_ready(f(*x))
        secs.append(time.perf_counter() - t0)
        bad.append(wrong_rows(words, amps, *out))
    log(f"  info exchange: wrong keys or sums per run {bad}, run times "
        f"{[round(t * 1e3, 2) for t in secs]} ms (the first includes "
        f"compilation) [{card}]")
    check(all(b == 0 for b in bad),
          f"shard.exchange (bucketed all_to_all) on {n} GPUs, {s_local} "
          f"rows/GPU, {runs} runs of one compiled program on fresh inputs: "
          f"every key on its owner exactly once, sums within 1e-12 of numpy "
          f"(f64) [{card}]")


# ---------------------------------------------------------------------------

def run_phase(name, fn, *args, failures):
    log(f"phase {name}")
    t0 = time.perf_counter()
    try:
        out = fn(*args)
    except Exception:  # a failed phase is reported, and fails the run
        traceback.print_exc()
        log(f"  FAIL phase {name} raised (see stderr)")
        failures.append(name)
        return None
    log(f"  phase {name} done in {time.perf_counter() - t0:.1f} s")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the generated kernel inputs")
    ap.add_argument("--four-gpus", action="store_true",
                    help="run only the hash-sharded path on four GPUs")
    args = ap.parse_args(argv)

    devs = device_gate(4 if args.four_gpus else 1)
    card = card_info()
    log(f"card: {card}")

    sys.path.insert(0, HERE)
    from fries_tpu import compile_cache

    log(f"compile cache: {compile_cache.enable()}")
    shutil.rmtree(OUT, ignore_errors=True)
    os.makedirs(OUT)
    failures: list = []

    if args.four_gpus:
        devs = devs[:4]
        run_phase("sharded exact frifull", phase_sharded_exact, devs, card,
                  failures=failures)
        run_phase("spawn exchange", phase_exchange, devs, card, args.seed,
                  failures=failures)
        fcidump = run_phase("N2 FCIDUMP", n2_fcidump, failures=failures)
        if fcidump:
            run_phase("frisys_mol --n_chips 4", phase_flagship, fcidump, 20,
                      card, 4_000_000,
                      ["--n_chips", "4", "--vec_nonz", "4000000",
                       "--mat_nonz", "4000000", "--target", "8000000"],
                      "frisys_mol_4gpu", 10, failures=failures)
    else:
        run_phase("small physics via CLI", phase_small_physics,
                  failures=failures)
        timings: dict = {}
        run_phase("arena merge at 1e6 widths", phase_merge, args.seed, FULL,
                  card, timings, failures=failures)
        run_phase("kernels.py helpers at 1e6 widths", phase_helpers,
                  args.seed, FULL, card, failures=failures)
        fcidump = run_phase("N2 FCIDUMP", n2_fcidump, failures=failures)
        if fcidump:
            from fries_tpu import io

            ham, _ = io.parse_fcidump(fcidump, "D2h")
            run_phase("HB-PP exact reconstruction", phase_hbpp_exact, ham,
                      card, failures=failures)
            main_run = run_phase("N2 flagship 1e6", phase_flagship, fcidump,
                                 FLAGSHIP_ITERS, card, failures=failures)
            if main_run and "merge_ms" in timings:
                log(f"  info merge share of the step: compact+accumulate "
                    f"{timings['merge_ms']:.1f} ms of "
                    f"{main_run['ms_per_iter']:.1f} ms/iter = "
                    f"{timings['merge_ms'] / main_run['ms_per_iter']:.1%} "
                    f"[{card}]")

    if failures:
        log(f"FAILED phases: {', '.join(failures)}")
        return 1
    log(f"card: {card}")
    log(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(__import__("jax").devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
