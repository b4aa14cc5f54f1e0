"""Benchmark: frisys (HB-PP factorized FCI-FRI) iteration throughput on the
flagship real N2/cc-pVDZ configuration, and the other BASELINE.md cells.

Metric (BASELINE.json): sampled H*v nonzeros per second per chip at 1e6 kept
determinants.  The reference publishes no wall-clock numbers (BASELINE.md);
vs_baseline is the speedup over a single-rank run of the same algorithm's
C++ reference implementation on a host CPU (baseline_cpp/baseline.json).

Prints ONE JSON line per run, naming the device it ran on.  Runs on the
default JAX platform, which must be a GPU: a measurement never falls back to
the CPU, and a failed run exits non-zero.

  python bench.py                          # frisys 1e6 rung
  FRIES_BENCH_RUNG=1 python bench.py       # 500k rung (2 = 125k)
  FRIES_BENCH_SMALL=1 python bench.py      # scaled-down smoke run
  FRIES_BENCH_CONFIG=fciqmc python bench.py   # one of CONFIGS below
"""

import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
sys.path.insert(0, os.path.join(HERE, "tools"))

import numpy as np  # noqa: E402

# spawn_cap = matr_samp + small slack: a comp_sub level emits at most n_samp
# rows (kept subs consume budget units and grid hits partition the remaining
# budget exactly, compress.py comp_sub).  Single-chip exact; the overflow
# flag aborts loudly if ever violated.
FULL_LADDER = [
    ("1e6", 1_000_000, 1_000_000, 1 << 21, 1_032_768, 2, 5),
    ("500k", 500_000, 500_000, 1 << 20, 532_768, 2, 5),
    ("125k", 125_000, 125_000, 1 << 18, 157_768, 2, 5),
]


def _device():
    """The GPU this run measures (exits if JAX's first device is not one),
    as a dict for the JSON line: JAX's view plus nvidia-smi's name and power
    limit."""
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"bench: first JAX device is {dev.platform}, not "
                         "a GPU; refusing to measure")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return {"platform": dev.platform, "kind": dev.device_kind,
            "count": len(jax.devices()),
            "card": card.splitlines()[0].strip()}


def _time_steady(run_steps, state, args, n_warm, n_time):
    """Steady-state seconds per iteration: warm up with the same static
    scan length, then time one block, each ended by block_until_ready."""
    import jax

    run = (lambda s: run_steps(s, *args, n_time)) if args else (
        lambda s: run_steps(s, n_time))
    for _ in range(n_warm):
        state, m = jax.block_until_ready(run(state))
    t0 = time.perf_counter()
    state, m = jax.block_until_ready(run(state))
    return (time.perf_counter() - t0) / n_time, m


def _emit(payload):
    """Print one JSON result line, with the device it was measured on."""
    print(json.dumps({**payload, "device": _device()}), flush=True)


def _last(m, name):
    return np.asarray(m[name]).reshape(-1)[-1]


def bench_frifull_hh():
    """BASELINE.md required config: frifull_hh, 4-site Hubbard-Holstein
    (exact H*v, systematic vector compression)."""
    from fries_tpu.ops import hubbard as hub
    from fries_tpu.drivers import frifull_hh, power

    ham = hub.HubbardHolstein(
        n_sites=4, n_elec=4, ph_bits=3, u=2.0, omega=1.0, g=0.5
    )
    cfg = power.PowerConfig(
        eps=0.01, target_nonz=30_000, capacity=1 << 17, target_norm=60_000.0
    )
    step, run_steps, state, aux = frifull_hh.build(
        ham, e_ref=0.0, cfg=cfg, seed=0
    )
    args = (aux["num_keys"], aux["num_vals"], aux["den_keys"],
            aux["den_vals"], aux["ref_key"])
    sec, m = _time_steady(run_steps, state, args, 3, 10)
    _emit({
        "metric": "frifull_hh iterations/sec (4-site Hubbard-Holstein, "
                  "ph_bits=3, 30k kept)",
        "value": 1.0 / sec, "unit": "iters/s", "vs_baseline": None,
        "ms_per_iter": sec * 1e3,
        "n_dets_final": int(_last(m, "n_dets")),
    })


def bench_frifull_mol():
    """BASELINE.md required config: frifull_mol, exact H application (every
    connected excitation per kept det), on real H2O/cc-pVDZ in a (10e, 12o)
    active space: its full FCI space (792^2 = 627k dets) fits the 2^21
    arena, so the uncompressed H*v support never overflows - the regime the
    reference's frifull H2O runs occupy (H*v support bounded by max_size,
    frifull_mol.cpp).  spawn_rows bounds the candidate buffer to the
    occupied arena prefix."""
    import real_systems
    from fries_tpu.drivers import frifull, power
    from fries_tpu.ops import molecule as mol

    full = real_systems.h2o_ccpvdz()
    k = 12
    ham = mol.MolecularHamiltonian(
        hcore=full.hcore[:k, :k], eris=full.eris[:k, :k, :k, :k],
        symm=full.symm[:k], n_orb=k, n_elec=full.n_elec,
        n_frozen=full.n_frozen)
    cfg = power.PowerConfig(
        eps=0.005, target_nonz=30_000, capacity=1 << 21,
        target_norm=60_000.0, batch=1024, spawn_rows=49_152,
        dedup_cap=1 << 19,
    )
    step, run_steps, state, aux = frifull.build(ham, cfg, seed=0)
    args = (aux["num_keys"], aux["num_vals"], aux["den_keys"],
            aux["den_vals"], aux["ref_key"])
    sec, m = _time_steady(run_steps, state, args, 2, 3)
    _emit({
        "metric": "frifull_mol iterations/sec (real H2O/cc-pVDZ (10e,12o) "
                  "CAS, exact H, 30k kept dets)",
        "value": 1.0 / sec, "unit": "iters/s", "vs_baseline": None,
        "ms_per_iter": sec * 1e3,
        "n_dets_final": int(_last(m, "n_dets")),
        "overflow": bool(np.asarray(m["overflow"]).any()),
    })


def bench_fciqmc():
    """BASELINE.md required config: fciqmc_mol at production walker counts
    (real stretched N2/cc-pVDZ r=4.2, heat-bath distribution, 5M walkers)."""
    import real_systems
    from fries_tpu.drivers import fciqmc

    ham = real_systems.n2_stretched()
    att_chunk = int(os.environ.get("FRIES_FCIQMC_CHUNK", 1 << 20))
    cfg = fciqmc.FciqmcConfig(
        eps=1e-3, target_walkers=5_000_000.0, capacity=1 << 21,
        attempt_cap=1 << 23, attempt_chunk=att_chunk, spawn_cap=1 << 22,
        distribution="HB", integer_walkers=True, init_thresh=3.0,
        # deadbeat norm control: damp/(interval*eps)*ln(growth) == the
        # instantaneous growth-rate energy, so one update locks the
        # population at its activation size (~target).  The default 0.05
        # removes only 5% of the log-growth per window, and the population
        # outgrows every buffer before the shift catches up.
        shift_damping=1.0,
    )
    # start the population at scale (the reference grows 50M walkers over
    # ~1e5 CPU iterations, fciqmc_mol.cpp; the bench measures the steady
    # state, so seed 4M walkers on HF and let ~60 iterations spread them),
    # in blocks of 5 iterations (the timed block's scan length)
    step, run_steps, state, aux = fciqmc.build(
        ham, cfg, seed=0, init_walkers=4_000_000.0
    )
    args = (aux["num_keys"], aux["num_vals"], aux["den_keys"],
            aux["den_vals"], aux["ref_key"])
    sec, m = _time_steady(run_steps, state, args, 12, 5)
    walkers = float(_last(m, "norm"))
    e_est = float(_last(m, "proj_num")) / float(_last(m, "proj_den"))
    _emit({
        "metric": "fciqmc_mol iterations/sec (real stretched N2/cc-pVDZ, "
                  "HB, 5M-walker target)",
        "value": 1.0 / sec, "unit": "iters/s", "vs_baseline": None,
        "ms_per_iter": sec * 1e3,
        "walkers": walkers,
        "ns_per_walker_iter": sec / max(walkers, 1) * 1e9,
        "overflow": bool(np.asarray(m["overflow"]).any()),
        "e_proj_finite": bool(np.isfinite(e_est)),
    })


def bench_subsp_sharded():
    """BASELINE.md required config: subsp_mol, real Ne cc-pVQZ, 2 states,
    hash-sharded code path (1-device mesh)."""
    import jax.numpy as jnp
    import real_systems
    from fries_tpu import dets, parallel
    from fries_tpu.drivers import subspace
    from fries_tpu.ops import molecule as mol

    subsp_sys = os.environ.get("FRIES_SUBSP_SYSTEM", "ne_ccpvqz")
    ham = getattr(real_systems, subsp_sys)()
    hf_words, hf_occ, _ = mol.hf_reference(ham)
    # symmetry-allowed single: highest occupied -> first same-irrep virt
    symm = np.asarray(ham.symm)
    half = ham.n_elec // 2
    o = half - 1
    v = next(i for i in range(half, ham.n_orb) if symm[i] == symm[o])
    d1, _ = dets.single_parity(
        hf_words[None], jnp.asarray([o]), jnp.asarray([v]))
    t = 2
    tk = np.tile(np.asarray(dets.invalid_det(ham.n_words)), (t, 1, 1))
    tv = np.zeros((t, 1))
    tk[0, 0] = np.asarray(hf_words)
    tv[0, 0] = 1.0
    tk[1, 0] = np.asarray(d1)[0]
    tv[1, 0] = 1.0
    n_dev = 1
    mesh = parallel.make_mesh(n_dev)
    cfg = subspace.SubspaceConfig(
        eps=0.02, n_trial=t, vec_nonz=100_000, matr_samp=200_000,
        capacity=1 << 19, spawn_cap=300_000, restart_int=10,
        axis_name=parallel.AXIS, n_shards=n_dev, exchange_cap=600_000,
    )
    step, run_steps, state, aux = subspace.build_sharded(
        ham, cfg, jnp.asarray(tk), jnp.asarray(tv), seed=0, mesh=mesh
    )
    sec, m = _time_steady(run_steps, state, None, 3, 5)
    _emit({
        "metric": f"subsp_mol iterations/sec (real {subsp_sys}, 2 states, "
                  "hash-sharded path, 100k kept/vector)",
        "value": 1.0 / sec, "unit": "iters/s", "vs_baseline": None,
        "ms_per_iter": sec * 1e3,
        "sampled_nonzeros_per_sec": t * cfg.matr_samp / sec,
    })


CONFIGS = {
    "frifull_hh": bench_frifull_hh,
    "frifull_mol": bench_frifull_mol,
    "fciqmc": bench_fciqmc,
    "subsp": bench_subsp_sharded,
}


def bench_frisys():
    """The headline: frisys on real N2/cc-pVDZ (frozen core, HF trial) at
    one rung of FULL_LADDER, or a small synthetic smoke configuration."""
    import jax
    from fries_tpu.drivers import frisys

    small = bool(os.environ.get("FRIES_BENCH_SMALL"))
    if small:
        from fries_tpu import synth

        label, vec_nonz, matr_samp, cap, spawn_cap, n_warm, n_time = (
            "small", 2000, 4000, 1 << 13, 6000, 2, 5,
        )
        ham = synth.make_system(10, 6, seed=1)
        sys_label = "small synthetic (SMALL smoke config)"
    else:
        import real_systems

        rung = int(os.environ.get("FRIES_BENCH_RUNG", "0"))
        label, vec_nonz, matr_samp, cap, spawn_cap, n_warm, n_time = (
            FULL_LADDER[rung])
        ham = real_systems.n2_ccpvdz()
        sys_label = "real N2/cc-pVDZ (frozen core)"

    cfg = frisys.FrisysConfig(
        eps=0.001, vec_nonz=vec_nonz, matr_samp=matr_samp, capacity=cap,
        spawn_cap=spawn_cap, target_norm=2.0 * vec_nonz,
    )
    step, run_steps, state, aux = frisys.build(ham, cfg, seed=0)
    args = (
        aux["num_keys"], aux["num_vals"], aux["den_keys"], aux["den_vals"],
        aux["ref_key"],
    )

    # warmup: same static scan length as the timed blocks (a different
    # n_iter would recompile inside the timing), repeated to reach a
    # steady-state population; then three timed blocks, all recorded
    for _ in range(n_warm):
        state, m = jax.block_until_ready(run_steps(state, *args, n_time))
    rep_secs = []
    for _ in range(3):
        t0 = time.perf_counter()
        state, m = jax.block_until_ready(run_steps(state, *args, n_time))
        rep_secs.append((time.perf_counter() - t0) / n_time)
    sec = min(rep_secs)
    nonzeros_per_sec = matr_samp / sec

    vs_baseline = None
    baseline_file = os.path.join(HERE, "baseline_cpp", "baseline.json")
    if os.path.exists(baseline_file):
        with open(baseline_file) as f:
            base = json.load(f)
        if base.get("nonzeros_per_sec"):
            vs_baseline = nonzeros_per_sec / base["nonzeros_per_sec"]

    _emit({
        "metric": "sampled H*v nonzeros/sec/chip, frisys HB-PP, "
                  f"{sys_label}, {label} kept dets",
        "value": nonzeros_per_sec,
        "unit": "nonzeros/s",
        "vs_baseline": vs_baseline,
        "iters_per_sec": 1.0 / sec,
        "n_dets_final": int(_last(m, "n_dets")),
        "overflow": bool(np.asarray(m["overflow"]).any()),
        "reps_ms_per_iter": [x * 1e3 for x in rep_secs],
        "rep_spread": (max(rep_secs) - min(rep_secs)) / min(rep_secs),
    })


def main():
    from fries_tpu import compile_cache

    compile_cache.enable()
    _device()  # refuse to start without a GPU
    which = os.environ.get("FRIES_BENCH_CONFIG", "frisys")
    if which == "frisys":
        return bench_frisys()
    return CONFIGS[which]()


if __name__ == "__main__":
    main()
