"""Profile the real-N2 flagship step against the synthetic bench system.

Times (a) the full step at the flagship config, (b) the estimator lookup
(H|trial> num_keys into the arena) in isolation, (c) the step with a
truncated trial, to attribute the overhead before launching the long run.

Usage: python tools/profile_n2.py [--trial_k 0] [--determ 150] [--scan 5]
"""

from __future__ import annotations

import argparse
import os
import sys
import time

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _REPO)
os.environ.setdefault("JAX_COMPILATION_CACHE_DIR",
                      os.path.join(_REPO, ".jax_cache"))

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--trial_k", type=int, default=0)
    ap.add_argument("--determ", type=int, default=150)
    ap.add_argument("--initiator", type=float, default=1.0)
    ap.add_argument("--scan", type=int, default=5)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--budget", type=int, default=1_000_000)
    ap.add_argument("--skip_lookup", action="store_true")
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp
    sys.path.insert(0, os.path.join(_REPO, "tools"))
    from flagship import build_system
    from fries_tpu.drivers import frisys

    ham, twords, tvals, e_cisd = build_system("n2")
    if args.trial_k and args.trial_k < len(tvals):
        top = np.argsort(-np.abs(tvals))[: args.trial_k]
        twords, tvals = twords[top], tvals[top]
    print(f"# trial {len(tvals)} dets", flush=True)

    budget = args.budget
    cfg = frisys.FrisysConfig(
        eps=0.001, vec_nonz=budget, matr_samp=budget,
        capacity=1 << 21, spawn_cap=budget + 32_768,
        target_norm=float(budget), init_thresh=args.initiator,
    )
    determ_keys = None
    if args.determ:
        top = np.argsort(-np.abs(tvals))[: args.determ]
        determ_keys = twords[top]
    scale = 0.5 * budget / np.abs(tvals).sum()
    t0 = time.time()
    step, run_steps, state, aux = frisys.build(
        ham, cfg, seed=11, trial=(twords, tvals),
        init_vec=(twords, tvals * scale), determ_keys=determ_keys)
    n_num = len(aux["num_vals"])
    print(f"# build {time.time() - t0:.0f}s; H|trial> rows = {n_num}",
          flush=True)

    run_args = [aux["num_keys"], aux["num_vals"], aux["den_keys"],
                aux["den_vals"], aux["ref_key"]]
    pk = aux["protected_keys"]

    # isolated estimator lookup timing (the per-step fused query)
    if not args.skip_lookup:
        from fries_tpu import dets
        from fries_tpu.runtime import arena as ar

        a = state.arena if hasattr(state, "arena") else state[0]
        queries = jnp.concatenate([aux["num_keys"], aux["den_keys"]] +
                                  ([pk] if pk is not None else []))

        @jax.jit
        def lk(keys, q):
            pos, found = dets.lookup_dets(keys, q)
            return jnp.sum(pos * found)

        t0 = time.time()
        r = float(lk(a.keys, queries))
        print(f"# lookup compile+run {time.time() - t0:.1f}s", flush=True)
        t0 = time.perf_counter()
        for _ in range(5):
            r = float(lk(a.keys, queries))
        print(f"# estimator lookup ({queries.shape[0]} rows into "
              f"{a.keys.shape[0]}-cap arena): "
              f"{(time.perf_counter() - t0) / 5 * 1e3:.1f} ms", flush=True)

    t0 = time.time()
    state, m = run_steps(state, *run_args, args.scan, pk)
    print(f"# step compile+first-block {time.time() - t0:.0f}s", flush=True)
    for rep in range(args.reps):
        t0 = time.perf_counter()
        state, m = run_steps(state, *run_args, args.scan, pk)
        nd = float(np.asarray(m["norm"]).reshape(-1)[-1])
        sec = (time.perf_counter() - t0) / args.scan
        print(f"# rep {rep}: {sec * 1e3:.0f} ms/iter (norm {nd:.3e})",
              flush=True)


if __name__ == "__main__":
    main()
