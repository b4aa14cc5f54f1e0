"""fries_tpu — stochastic full-CI framework in JAX.

A from-scratch JAX/XLA re-design of the capabilities of sgreene8/FRIES
(Fast Randomized Iteration for Electronic Structure): stochastic power-method
FCI solvers (systematic/pivotal/multinomial FRI, integer and floating-point
initiator FCIQMC, semi-stochastic deterministic subspaces, multi-state subspace
iteration, observable estimators) for molecular Hamiltonians and the
Hubbard-Holstein model.

Design notes (batched arrays, not a port):

* Slater determinants are packed ``uint32`` word arrays plus transient unpacked
  occupancy-bit tensors (``dets.py``); popcount/parity use
  ``lax.population_count`` and masked reductions instead of byte LUTs
  (reference: FRIES/math_utils.c, FRIES/fci_utils.c).
* The hash-table-backed distributed vector (reference FRIES/vec_utils.hpp,
  FRIES/det_hash.hpp) becomes a *sorted, capacity-padded arena* with
  sort+segment-sum accumulation and searchsorted lookups (``runtime/arena.py``).
* Stochastic compression (reference FRIES/compress_utils.cpp) becomes
  threshold-fixpoint preservation + prefix-sum systematic resampling, fully
  batched with static shapes (``compress.py``).
* MPI collectives map to ``jax.lax`` collectives inside ``shard_map`` over a
  1-D device mesh (``runtime/shard.py``); the rank-0 broadcast of shared random
  numbers becomes using the same PRNG key on every shard.
"""

import jax

# f64 accumulations are load-bearing for the estimator / compression math; the
# big per-determinant tensors stay f32/int32.
jax.config.update("jax_enable_x64", True)

# f32 matrix products must not run in TF32 (about 10 mantissa bits), which a
# GPU may pick for the DEFAULT precision: f32 weights feed the inverse-CDF
# draws, whose prefix sums must agree with the probabilities used for value
# division, and f32 products carry counts that must stay exact below 2^24.
# HIGHEST keeps every f32 product in full f32.
jax.config.update("jax_default_matmul_precision", "highest")

__version__ = "0.1.0"
