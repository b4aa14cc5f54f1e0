"""Re-run the reference C++ single-rank baseline on the REAL N2/cc-pVDZ
integrals (bench.py's frisys rung measures the same system on the GPU).

Writes the reference-format HF directory from the in-repo Hamiltonian
(io.write_hf_dir), runs the rebuilt frisys_mol (/tmp/friesref/build,
MPI stub) for a timed window at the published flagship config, and
updates baseline_cpp/baseline.json.
"""

import json
import os
import re
import subprocess
import sys
import time

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _REPO)
os.environ["JAX_PLATFORMS"] = "cpu"

BIN = "/tmp/friesref/build/FRIES_bin/frisys_mol"


def main():
    import jax

    jax.config.update("jax_platforms", "cpu")
    sys.path.insert(0, os.path.join(_REPO, "tools"))
    import real_systems
    from fries_tpu import io as fio

    from fries_tpu.ops import molecule as mol

    ham = real_systems.n2_ccpvdz()
    fcid = "/tmp/n2_real_fcidump"
    fio.write_fcidump(ham, fcid, point_group="d2h")

    def timed(n_iter):
        run_dir = f"/tmp/cpp_baseline_n2_{n_iter}/"
        os.makedirs(run_dir, exist_ok=True)
        cmd = [BIN, "--fcidump_path", fcid, "--epsilon", "0.001", "--point_group", "D2h", "--target", "1000000",
               "--distribution", "HB", "--vec_nonz", "1000000",
               "--mat_nonz", "1000000", "--max_dets", "3000000",
               "--initiator", "1", "--max_iter", str(n_iter),
               "--result_dir", run_dir]
        print("#", " ".join(cmd), flush=True)
        t0 = time.time()
        out = subprocess.run(cmd, capture_output=True, text=True,
                             timeout=7200)
        wall = time.time() - t0
        if out.returncode != 0:
            sys.stderr.write(out.stderr[-2000:] + "\n")
            raise SystemExit(f"reference binary failed (rc {out.returncode})")
        print(out.stdout[-400:], flush=True)
        return wall

    # subtract setup (HB tensors, FCIDUMP parse) with a two-point measure
    t5 = timed(5)
    t45 = timed(45)
    sec_per_iter = (t45 - t5) / 40.0
    assert sec_per_iter > 0.05, (
        f"implausible reference timing ({sec_per_iter}); refusing to "
        "overwrite the baseline")
    nonz_per_sec = 1_000_000 / sec_per_iter
    print(f"# {sec_per_iter:.3f} s/iter, {nonz_per_sec:.0f} nonzeros/s",
          flush=True)
    path = os.path.join(_REPO, "baseline_cpp", "baseline.json")
    with open(path) as f:
        base = json.load(f)
    base["synthetic_baseline"] = {
        "nonzeros_per_sec": base.get("nonzeros_per_sec"),
        "sec_per_iter": base.get("sec_per_iter"),
        "config": base.get("config"),
    }
    base["nonzeros_per_sec"] = nonz_per_sec
    base["sec_per_iter"] = sec_per_iter
    base["config"] = ("frisys_mol HB, REAL N2/cc-pVDZ (in-repo integrals "
                      "via write_fcidump), vec_nonz=1e6 mat_nonz=1e6 "
                      "eps default, initiator 1, single rank, 1 CPU core")
    base["note"] = ("two-point wall-clock (iters 5..45, setup subtracted); "
                    "population ramping toward 1e6")
    with open(path, "w") as f:
        json.dump(base, f, indent=1)
    print(f"# wrote {path}")


if __name__ == "__main__":
    main()
