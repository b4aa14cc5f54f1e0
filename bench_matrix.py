"""Bench matrix: all five BASELINE.md-required configurations
(BASELINE.md:62-66), each run by ``bench.py`` in its own child process, one
after another, so that one process at a time holds the GPU (this parent
never imports JAX).  Results go to results/bench_matrix.json.

  frisys       - headline: real N2/cc-pVDZ systematic HB-PP FRI, 1e6 rung
  frifull_hh   - 4-site Hubbard-Holstein, exact H
  frifull_mol  - real H2O/cc-pVDZ (10e,12o) CAS, exact H
  fciqmc       - real stretched N2/cc-pVDZ, heat-bath, 5M-walker target
  subsp        - real Ne cc-pVQZ 2-state subspace, hash-sharded code path

Usage: python bench_matrix.py [config ...]   (default: all)
Exits non-zero if any configuration failed.
"""

import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ALL = ["frisys", "frifull_hh", "frifull_mol", "fciqmc", "subsp"]


def main():
    want = sys.argv[1:] or ALL
    out_path = os.path.join(HERE, "results", "bench_matrix.json")
    os.makedirs(os.path.dirname(out_path), exist_ok=True)
    results = {}
    for name in want:
        env = dict(os.environ, FRIES_BENCH_CONFIG=name)
        sys.stderr.write(f"# running {name}...\n")
        proc = subprocess.run(
            [sys.executable, os.path.join(HERE, "bench.py")],
            env=env, capture_output=True, text=True, timeout=7200,
        )
        line = next(
            (l for l in proc.stdout.splitlines() if l.startswith("{")), None
        )
        if proc.returncode == 0 and line:
            results[name] = json.loads(line)
            print(line)
        else:
            results[name] = {"error": proc.stderr[-4000:],
                             "returncode": proc.returncode}
            sys.stderr.write(f"# {name} FAILED\n{proc.stderr[-4000:]}\n")
        with open(out_path, "w") as f:
            json.dump(results, f, indent=1)
    sys.stderr.write(f"# wrote {out_path}\n")
    if any("error" in r for r in results.values()):
        raise SystemExit(1)


if __name__ == "__main__":
    main()
