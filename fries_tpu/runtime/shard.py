"""Multi-chip sharding: hash-distributed arena + all-to-all spawn exchange.

Replacement for the reference's MPI layer (SURVEY.md section 5.8):

* rank assignment by hash (DistVec::idx_to_proc, vec_utils.hpp:360-379)
  becomes an FNV-1a hash of the determinant key words modulo the mesh size;
* the Adder's MPI_Alltoall/MPI_Alltoallv round trip (vec_utils.hpp:991-1019)
  becomes a fixed-capacity bucketed all-to-all over the mesh with a psum'd
  overflow flag instead of flow control;
* ``sum_mpi`` reductions are ``lax.psum``; the rank-0 broadcast of shared
  random numbers (compress_utils.cpp:291) is replaced by using the same PRNG
  key on every shard.

Everything here runs inside ``shard_map`` over a 1-D device mesh.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax

from fries_tpu import dets

FNV_PRIME = np.uint32(0x01000193)
FNV_SEED = np.uint32(0x811C9DC5)


def shard_of_words(words: jax.Array, n_shards: int, seed: int = 0) -> jax.Array:
    """FNV-1a hash of the key words -> owning shard index (..., ) int32."""
    h = jnp.full(words.shape[:-1], FNV_SEED ^ np.uint32(seed), jnp.uint32)
    for w in range(words.shape[-1]):
        h = (h ^ words[..., w]) * FNV_PRIME
    # mix to decorrelate low bits
    h = h ^ (h >> 16)
    h = h * np.uint32(0x7FEB352D)
    h = h ^ (h >> 15)
    return (h % np.uint32(n_shards)).astype(jnp.int32)


def exchange(arrays: dict, target: jax.Array, n_shards: int,
             per_pair_cap: int, axis_name: str):
    """Route spawn rows to their owning shards.

    Pads every (src, dst) bucket to ``per_pair_cap`` rows and moves the
    dense buffer with one ``lax.all_to_all``; the psum'd overflow flag is
    set when any single bucket holds more than ``per_pair_cap`` rows.
    (``lax.ragged_all_to_all`` would send only the live rows, but on GPUs
    with JAX 0.9.0 it returned wrong rows on repeated execution; see
    ROADMAP.md.)

    Args:
      arrays: dict of (S, ...) spawn payloads; must contain "keys" (S, W)
        whose sentinel rows mark invalid entries, and "amps".
      target: (S,) destination shard of each row.
      per_pair_cap: static bucket capacity per destination shard; the
        receive buffer holds n_shards * per_pair_cap rows.

    Returns (received dict of (n_shards*per_pair_cap, ...), overflow bool).
    """
    s = target.shape[0]
    keys = arrays["keys"]
    valid = ~dets.is_invalid(keys)
    target = jnp.where(valid, target, n_shards)  # invalid -> dropped bucket

    # sort rows by destination; bucket d then occupies the contiguous range
    # [start_d, start_d + count_d) of the sorted order.
    order = jnp.argsort(target, stable=True)
    sorted_target = target[order]
    shard_ids = jnp.arange(n_shards, dtype=target.dtype)
    start = jnp.searchsorted(sorted_target, shard_ids, side="left",
                             method="sort").astype(jnp.int32)
    end = jnp.searchsorted(sorted_target, shard_ids, side="right",
                           method="sort").astype(jnp.int32)
    count = end - start
    overflow = jnp.any(count > per_pair_cap)
    overflow = lax.psum(overflow.astype(jnp.int32), axis_name) > 0

    # gather-based send-buffer build: output slot (d, c) pulls sorted row
    # start_d + c when c < count_d
    d_idx = jnp.repeat(shard_ids, per_pair_cap)
    c_idx = jnp.tile(jnp.arange(per_pair_cap, dtype=jnp.int32), n_shards)
    src_slot = start[d_idx] + c_idx
    ok = c_idx < count[d_idx]
    src_slot = jnp.clip(src_slot, 0, s - 1)

    received = {}
    for name, arr in arrays.items():
        arr_sorted = arr[order]
        picked = arr_sorted[src_slot]
        if name == "keys":
            fill = jnp.asarray(dets.invalid_det(arr.shape[-1]))
            buf = jnp.where(ok[:, None], picked, fill)
        else:
            okb = ok.reshape((-1,) + (1,) * (arr.ndim - 1))
            buf = jnp.where(okb, picked, jnp.zeros((), arr.dtype))
        buf = buf.reshape((n_shards, per_pair_cap) + arr.shape[1:])
        out = lax.all_to_all(buf, axis_name, split_axis=0, concat_axis=0, tiled=False)
        received[name] = out.reshape((n_shards * per_pair_cap,) + arr.shape[1:])
    return received, overflow
