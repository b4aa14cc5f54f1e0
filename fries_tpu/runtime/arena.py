"""Sorted capacity-padded sparse-vector arena.

Replacement for the reference's hash-table distributed vector
(DistVec + HashTable + Adder, FRIES/vec_utils.hpp:51-1048,
FRIES/det_hash.hpp): one chip's shard of the solution vector is a fixed
capacity struct-of-arrays *sorted by determinant key*, with

* accumulation of spawned contributions via sort + binary-search merge
  (replaces Adder::perform_add + DistVec::add_elements,
  vec_utils.hpp:991-1019, 606-641),
* the initiator rule expressed as a per-segment mask (a spawn from a
  non-initiator parent only counts when its target determinant already exists
  in the arena with a nonzero origin-row value; vec_utils.hpp:631-639),
* binary search instead of hash lookup for dot products and membership
  (vec_utils.hpp:228-275),
* stable masked compaction instead of per-entry deletion + free-list
  (vec_utils.hpp:458-499).

Unlike the reference's DistVec, the arena carries NO occupied-orbital or
diagonal caches (occ_orbs_ vec_utils.hpp:134, matr_el_ :139): every merge
and compaction would have to move those payload columns too, while
recomputing occupied lists and diagonals from the keys is pure vector math.
Drivers derive both from keys per iteration.

Empty slots carry the all-ones sentinel key, which sorts after every valid
determinant, so the occupied prefix is contiguous and sorted.  All operations
are static-shape and jit-compatible; ``n_used`` is a traced scalar.

Multi-row values: like the reference (vec_utils.hpp:123), the arena holds
``n_vecs`` parallel value rows over one shared index set, used by the
subspace-iteration and observable drivers.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from functools import partial

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax

from fries_tpu import dets


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class Arena:
    """One shard of the sparse solution vector.

    Attributes:
      keys:  (C, W) uint32 determinant words, sorted ascending, sentinel-padded.
      vals:  (R, C) value rows.
      n_used: (1,) int32 number of occupied slots (kept 1-D so the arena
        shards cleanly under shard_map).
    """

    keys: jax.Array
    vals: jax.Array
    n_used: jax.Array

    @property
    def capacity(self) -> int:
        return self.keys.shape[0]

    @property
    def n_words(self) -> int:
        return self.keys.shape[1]

    @property
    def n_vecs(self) -> int:
        return self.vals.shape[0]

    @property
    def valid(self) -> jax.Array:
        return ~dets.is_invalid(self.keys)


def make(capacity: int, n_words: int, n_vecs: int,
         val_dtype=jnp.float64) -> Arena:
    """An empty arena."""
    return Arena(
        keys=jnp.tile(dets.invalid_det(n_words), (capacity, 1)),
        vals=jnp.zeros((n_vecs, capacity), dtype=val_dtype),
        n_used=jnp.zeros((1,), jnp.int32),
    )


def _sort_perm(keys: jax.Array) -> jax.Array:
    """Permutation sorting rows of ``keys`` lexicographically (stable).

    Packed-int64 fast path (one sort operand) when the determinant fits."""
    n = keys.shape[0]
    if dets.packable(keys.shape[1]):
        operands = [dets.pack_key(keys), jnp.arange(n, dtype=jnp.int32)]
        return lax.sort(operands, num_keys=1, is_stable=True)[-1]
    operands = dets.sort_key_columns(keys) + [jnp.arange(n, dtype=jnp.int32)]
    sorted_ops = lax.sort(operands, num_keys=keys.shape[1], is_stable=True)
    return sorted_ops[-1]


@jax.jit
def from_unsorted(arena: Arena, keys, vals) -> Arena:
    """Populate an empty arena from unsorted (possibly sentinel-padded) rows.

    ``vals`` has shape (R, N) with N <= capacity; duplicate keys are NOT
    merged here (use :func:`accumulate` for that).
    """
    c = arena.capacity
    n = keys.shape[0]
    pad = c - n
    if pad:
        keys = jnp.concatenate(
            [keys, jnp.tile(dets.invalid_det(arena.n_words), (pad, 1))]
        )
        vals = jnp.concatenate(
            [vals, jnp.zeros((vals.shape[0], pad), vals.dtype)], axis=1
        )
    perm = _sort_perm(keys)
    keys = keys[perm]
    return Arena(
        keys=keys,
        vals=vals[:, perm].astype(arena.vals.dtype),
        n_used=jnp.sum(~dets.is_invalid(keys), dtype=jnp.int32)[None],
    )


def _rank_select(cum_inc: jax.Array, n_out: int):
    """src[j] = index of the (j+1)-th flagged element, given the inclusive
    cumsum of the flag vector.  Sorted queries against a sorted array, so
    the sort-method searchsorted resolves all of them in one pass."""
    j = jnp.arange(n_out, dtype=cum_inc.dtype)
    return jnp.searchsorted(cum_inc, j + 1, side="left", method="sort")


@jax.jit
def compact(arena: Arena, keep_mask: jax.Array) -> Arena:
    """Remove entries where ``keep_mask`` is False (stable, stays sorted).

    Replaces DistVec::del_at_pos / cleanup (vec_utils.hpp:458-499); callers
    typically keep entries that remain nonzero in any value row or are
    protected (reference frisys_mol.cpp:534-539).  Gather-based: output slot
    j pulls the (j+1)-th kept row (no scatters).
    """
    c, w = arena.keys.shape
    keep = keep_mask & arena.valid
    cum = jnp.cumsum(keep.astype(jnp.int32))
    n_live = cum[-1]
    src = jnp.clip(_rank_select(cum, c), 0, c - 1)
    valid_out = jnp.arange(c, dtype=jnp.int32) < n_live
    out_keys = jnp.where(
        valid_out[:, None], arena.keys[src], jnp.asarray(dets.invalid_det(w))
    )
    out_vals = jnp.where(valid_out[None, :], arena.vals[:, src], 0)
    return Arena(
        keys=out_keys,
        vals=out_vals,
        n_used=n_live[None],
    )


def lookup(arena: Arena, query_keys: jax.Array):
    """(positions, found) of query determinants (replaces hash lookups)."""
    pos, found = dets.lookup_dets(arena.keys, query_keys)
    return pos, found & ~dets.is_invalid(query_keys)


@partial(jax.jit, static_argnames=("row",))
def dot(arena: Arena, query_keys: jax.Array, query_vals: jax.Array, row: int = 0):
    """Local dot product of one value row against a replicated sparse vector.

    Replaces DistVec::dot with precomputed hashes (vec_utils.hpp:228-253);
    sum over shards with psum for the global value.
    """
    pos, found = lookup(arena, query_keys)
    gathered = jnp.where(found, arena.vals[row][pos], 0)
    return jnp.sum(gathered.astype(jnp.float64) * query_vals.astype(jnp.float64))


def one_norm(arena: Arena, row: int = 0) -> jax.Array:
    return jnp.sum(jnp.abs(arena.vals[row].astype(jnp.float64)))


def occupancy_stats(arena: Arena, row: int = 0) -> dict:
    """Diagnostics for the arena_occ stream — the sorted-arena analogue of
    the reference's hash-table occupancy dump (print_ht,
    det_hash.hpp:98-114): slot usage, live (valid-key) slots, nonzeros on
    ``row``, and zero-valued live slots ("dead" entries a chained table
    would keep as tombstones)."""
    used = int(np.asarray(arena.n_used).sum())
    valid = np.asarray(arena.valid)
    vals = np.asarray(arena.vals[row])
    live = int(valid.sum())
    nonz = int(((vals != 0) & valid).sum())
    return {
        "capacity": arena.capacity,
        "used": used,
        "live": live,
        "nonzero": nonz,
        "zero_live": live - nonz,
        "fill": used / arena.capacity,
    }


def n_nonzero(arena: Arena, row: int = 0) -> jax.Array:
    return jnp.sum((arena.vals[row] != 0) & arena.valid, dtype=jnp.int32)


def set_row(arena: Arena, row: int, values: jax.Array) -> Arena:
    return replace(arena, vals=arena.vals.at[row].set(values))


def grow(arena: Arena, new_capacity: int) -> Arena:
    """Host-side capacity growth (outside jit; triggers recompilation of the
    iteration step, the static-shape analogue of DistVec::expand,
    vec_utils.hpp:343-353)."""
    c = arena.capacity
    extra = new_capacity - c
    if extra <= 0:
        return arena
    return Arena(
        keys=jnp.concatenate(
            [arena.keys, jnp.tile(dets.invalid_det(arena.n_words), (extra, 1))]
        ),
        vals=jnp.concatenate(
            [arena.vals, jnp.zeros((arena.n_vecs, extra), arena.vals.dtype)], axis=1
        ),
        n_used=arena.n_used,
    )


@partial(jax.jit, static_argnames=("origin_row", "dest_row"))
def accumulate(
    arena: Arena,
    spawn_keys: jax.Array,
    spawn_vals: jax.Array,
    spawn_ini: jax.Array,
    origin_row: int = 0,
    dest_row: int = 0,
):
    """Merge spawned contributions into the arena with initiator semantics.

    Sorted-merge formulation: only the S spawn rows are sorted; the (already
    sorted) arena is merged by binary search - the full (C+S) sort of the
    naive approach is the most expensive kernel at production sizes.

    Steps: sort spawns by key -> segment-sum duplicate spawn contributions
    (the initiator rule gates each spawn by its own flag or the target's
    nonzero origin-row occupancy, looked up in the arena) -> compute output
    positions for arena rows and new unique keys via searchsorted -> scatter.

    Invalid spawn slots must carry the sentinel key.  Returns (new_arena,
    stats) with stats = dict(overflow, nonini_occ_add) - semantics identical
    to the reference two-pass add (frisys_mol.cpp:430-471, vec_utils.hpp:
    606-641); see tests/test_arena.py.
    """
    c, w = arena.keys.shape
    s = spawn_keys.shape[0]
    r = arena.n_vecs

    # ---- 1. sort spawns by key; segment structure from cumsums ----
    # (everything below is sorts, searchsorteds, cumsums and gathers)
    perm = _sort_perm(spawn_keys)
    skeys = spawn_keys[perm]
    svals = spawn_vals[perm]
    sini = spawn_ini[perm]
    s_valid = ~dets.is_invalid(skeys)
    n_svalid = jnp.sum(s_valid, dtype=jnp.int32)

    first = jnp.concatenate(
        [jnp.ones((1,), jnp.bool_), ~dets.det_eq(skeys[1:], skeys[:-1])]
    ) & s_valid
    nfirst = jnp.cumsum(first.astype(jnp.int32))  # inclusive
    seg_id = jnp.where(s_valid, nfirst - 1, s)
    n_uniq = nfirst[-1]

    # unique segments by rank-select: start of the u-th segment, end = next-1
    u_idx = jnp.arange(s, dtype=jnp.int32)
    valid_u = u_idx < n_uniq
    seg_start = jnp.clip(_rank_select(nfirst, s), 0, s - 1)
    seg_next = jnp.concatenate([seg_start[1:], jnp.full((1,), s, jnp.int32)])
    seg_end = jnp.clip(
        jnp.where(u_idx + 1 < n_uniq, seg_next - 1, n_svalid - 1), 0, s - 1
    )
    ukeys = jnp.where(
        valid_u[:, None], skeys[seg_start], jnp.asarray(dets.invalid_det(w))
    )

    # ---- 2. arena lookup: does each unique key exist with nonzero origin? --
    raw_pos = dets.searchsorted_dets(arena.keys, ukeys)
    apos = jnp.clip(raw_pos, 0, c - 1)
    found = (
        dets.det_eq(arena.keys[apos], ukeys)
        & (raw_pos < c)
        & valid_u
    )
    found = found & arena.valid[apos]
    occupied = found & (arena.vals[origin_row][apos] != 0)

    # per-spawn gating; segment sums via cumulative differences at boundaries
    elem_occupied = occupied[jnp.clip(seg_id, 0, s - 1)] & s_valid
    allowed = s_valid & (sini | elem_occupied)
    nonini_occ_add = jnp.sum(s_valid & ~sini & elem_occupied, dtype=jnp.int32)
    csum_v = jnp.cumsum(jnp.where(allowed, svals, 0))
    csum_n = jnp.cumsum(allowed.astype(jnp.int32))

    def seg_diff(csum):
        lo = jnp.where(seg_start > 0, csum[jnp.maximum(seg_start - 1, 0)], 0)
        return csum[seg_end] - lo

    contrib = jnp.where(valid_u, seg_diff(csum_v), 0.0)
    seg_live = valid_u & (seg_diff(csum_n) > 0)

    # ---- 3. output layout ----
    a_valid = arena.valid
    n_avalid = jnp.sum(a_valid, dtype=jnp.int32)
    is_new = (~found) & seg_live
    cum_new = jnp.cumsum(is_new.astype(jnp.int32))
    new_rank = cum_new - 1
    n_new = cum_new[-1]
    overflow = n_avalid + n_new > c

    # destination of each new unique (strictly increasing on the new subset)
    uniq_dest = jnp.where(is_new, raw_pos + new_rank, c + s)
    ud_sorted, usrc = lax.sort(
        [uniq_dest, u_idx], num_keys=1, is_stable=True
    )

    # ---- 4. gather-based placement: each output slot pulls its source ----
    j = jnp.arange(c, dtype=jnp.int32)
    # #new uniques placed at slots <= j (ud_sorted ascending, queries sorted)
    n_new_leq = jnp.searchsorted(ud_sorted, j, side="right", method="sort")
    prev = jnp.clip(n_new_leq - 1, 0, s - 1)
    is_new_out = (n_new_leq > 0) & (ud_sorted[prev] == j)
    new_u = usrc[prev]

    arena_src = jnp.clip(j - n_new_leq, 0, c - 1)
    from_arena = (~is_new_out) & (j - n_new_leq < n_avalid) & (j - n_new_leq >= 0)

    src_u = jnp.where(is_new_out, new_u, 0)
    out_keys = jnp.where(
        is_new_out[:, None],
        ukeys[src_u],
        jnp.where(
            from_arena[:, None],
            arena.keys[arena_src],
            jnp.asarray(dets.invalid_det(w)),
        ),
    )

    # arena-sourced rows: add this key's merged contribution to dest_row
    # (replaces the scatter-add onto arena.vals); locate the matching unique
    pos_in_uniq = jnp.clip(
        dets.searchsorted_dets(ukeys, arena.keys[arena_src]), 0, s - 1
    )
    hit = (
        from_arena
        & dets.det_eq(ukeys[pos_in_uniq], arena.keys[arena_src])
        & found[pos_in_uniq]
    )
    base_vals = jnp.where(from_arena[None, :], arena.vals[:, arena_src], 0)
    add_dest = jnp.where(hit, contrib[pos_in_uniq], 0.0)
    add_dest = jnp.where(is_new_out, contrib[src_u], add_dest)
    out_vals = base_vals.at[dest_row].add(add_dest.astype(arena.vals.dtype))

    new_arena = Arena(
        keys=out_keys,
        vals=out_vals,
        n_used=jnp.minimum(n_avalid + n_new, c)[None],
    )
    return new_arena, {"overflow": overflow, "nonini_occ_add": nonini_occ_add}


@partial(jax.jit, static_argnames=("cap",))
def dedup_spawns(spawn_keys, spawn_vals, spawn_ini, cap: int):
    """Collapse duplicate spawn targets into ≤ ``cap`` rows before a merge.

    Exact-H streams repeat each target determinant once per connected
    source (kept_dets x n_excitations rows for ~|space| unique targets):
    deduplicating first shrinks every downstream merge cost from the raw
    stream length to the unique count.  Initiator semantics are preserved
    exactly by segmenting on (key, ini_flag) — a target's initiator and
    non-initiator contributions stay separate rows, so accumulate's
    per-spawn gate (own flag OR occupied target, vec_utils.hpp:606-641)
    sees the same sums.  Returns (keys (cap, W), vals, ini, overflow);
    output rows are sorted and sentinel-padded.
    """
    s, w = spawn_keys.shape
    ini_i = spawn_ini.astype(jnp.int32)
    # dead rows (sentinel key or zero value) sort to the tail so the valid
    # prefix has no interleaved holes to confuse the boundary detection
    dead = (dets.is_invalid(spawn_keys) | (spawn_vals == 0)).astype(jnp.int32)
    if dets.packable(w):
        operands = [dead, dets.pack_key(spawn_keys), ini_i,
                    jnp.arange(s, dtype=jnp.int32)]
        perm = lax.sort(operands, num_keys=3, is_stable=True)[-1]
    else:
        operands = [dead] + dets.sort_key_columns(spawn_keys) + [
            ini_i, jnp.arange(s, dtype=jnp.int32)]
        perm = lax.sort(operands, num_keys=w + 2, is_stable=True)[-1]
    skeys = spawn_keys[perm]
    svals = spawn_vals[perm]
    sini = ini_i[perm]
    s_valid = ~dets.is_invalid(skeys) & (svals != 0)

    first = jnp.concatenate([
        jnp.ones((1,), jnp.bool_),
        ~dets.det_eq(skeys[1:], skeys[:-1]) | (sini[1:] != sini[:-1]),
    ]) & s_valid
    nfirst = jnp.cumsum(first.astype(jnp.int32))
    n_seg = nfirst[-1]
    overflow = n_seg > cap

    # segment sums as cumsum differences at segment starts (scatter-free)
    csum = jnp.cumsum(jnp.where(s_valid, svals, 0.0))
    seg_start = jnp.clip(_rank_select(nfirst, cap), 0, s - 1)
    u_idx = jnp.arange(cap, dtype=jnp.int32)
    valid_u = u_idx < n_seg
    seg_next_start = jnp.concatenate(
        [seg_start[1:], jnp.full((1,), s - 1, jnp.int32)])
    # inclusive csum at the last row of each segment = csum[next_start - 1]
    last = jnp.clip(jnp.where(u_idx + 1 < n_seg, seg_next_start - 1, s - 1),
                    0, s - 1)
    upper = csum[last]
    lower = jnp.where(seg_start > 0, csum[jnp.maximum(seg_start - 1, 0)], 0.0)
    out_vals = jnp.where(valid_u, upper - lower, 0.0)
    sentinel = jnp.asarray(dets.invalid_det(w))
    out_keys = jnp.where(valid_u[:, None], skeys[seg_start], sentinel)
    out_ini = jnp.where(valid_u, sini[seg_start], 0).astype(jnp.bool_)
    return out_keys, out_vals, out_ini, overflow


@partial(jax.jit, static_argnames=())
def accumulate_multi(
    arena: Arena,
    spawn_keys: jax.Array,
    spawn_vals: jax.Array,
    spawn_rows: jax.Array,
    spawn_ini: jax.Array,
):
    """Merge spawns targeting *per-spawn* value rows (for the multi-vector
    subspace drivers, reference subsp_mol.cpp:546-600).

    Like :func:`accumulate`, but each spawn carries the row it contributes to
    (``spawn_rows``), and the initiator rule checks occupancy against that
    same row (origin == dest per vector in the reference loop).
    """
    c, w = arena.keys.shape
    s = spawn_keys.shape[0]
    r = arena.n_vecs

    perm = _sort_perm(spawn_keys)
    skeys = spawn_keys[perm]
    svals = spawn_vals[perm]
    sini = spawn_ini[perm]
    srows = spawn_rows[perm]
    s_valid = ~dets.is_invalid(skeys)
    n_svalid = jnp.sum(s_valid, dtype=jnp.int32)

    first = jnp.concatenate(
        [jnp.ones((1,), jnp.bool_), ~dets.det_eq(skeys[1:], skeys[:-1])]
    ) & s_valid
    nfirst = jnp.cumsum(first.astype(jnp.int32))
    seg_id = jnp.where(s_valid, nfirst - 1, s)
    n_uniq = nfirst[-1]

    u_idx = jnp.arange(s, dtype=jnp.int32)
    valid_u = u_idx < n_uniq
    seg_start = jnp.clip(_rank_select(nfirst, s), 0, s - 1)
    seg_next = jnp.concatenate([seg_start[1:], jnp.full((1,), s, jnp.int32)])
    seg_end = jnp.clip(
        jnp.where(u_idx + 1 < n_uniq, seg_next - 1, n_svalid - 1), 0, s - 1
    )
    ukeys = jnp.where(
        valid_u[:, None], skeys[seg_start], jnp.asarray(dets.invalid_det(w))
    )

    raw_pos = dets.searchsorted_dets(arena.keys, ukeys)
    apos = jnp.clip(raw_pos, 0, c - 1)
    found = (
        dets.det_eq(arena.keys[apos], ukeys) & (raw_pos < c) & valid_u
    )
    found = found & arena.valid[apos]

    def seg_diff(csum):
        lo = jnp.where(seg_start > 0, csum[jnp.maximum(seg_start - 1, 0)], 0)
        return csum[seg_end] - lo

    seg_live = jnp.zeros((s,), jnp.bool_)
    nonini_occ_add = jnp.int32(0)
    contribs = []
    for row in range(r):
        occupied_r = found & (arena.vals[row][apos] != 0)
        elem_occ_r = occupied_r[jnp.clip(seg_id, 0, s - 1)] & s_valid
        mine = s_valid & (srows == row)
        allowed_r = mine & (sini | elem_occ_r)
        nonini_occ_add += jnp.sum(mine & ~sini & elem_occ_r, dtype=jnp.int32)
        contribs.append(
            jnp.where(
                valid_u,
                seg_diff(jnp.cumsum(jnp.where(allowed_r, svals, 0))),
                0.0,
            )
        )
        seg_live = seg_live | (
            valid_u & (seg_diff(jnp.cumsum(allowed_r.astype(jnp.int32))) > 0)
        )
    contrib_rows = jnp.stack(contribs)  # (R, S) per-unique sums

    a_valid = arena.valid
    n_avalid = jnp.sum(a_valid, dtype=jnp.int32)
    is_new = (~found) & seg_live
    cum_new = jnp.cumsum(is_new.astype(jnp.int32))
    new_rank = cum_new - 1
    n_new = cum_new[-1]
    overflow = n_avalid + n_new > c

    uniq_dest = jnp.where(is_new, raw_pos + new_rank, c + s)
    ud_sorted, usrc = lax.sort([uniq_dest, u_idx], num_keys=1, is_stable=True)

    j = jnp.arange(c, dtype=jnp.int32)
    n_new_leq = jnp.searchsorted(ud_sorted, j, side="right", method="sort")
    prev = jnp.clip(n_new_leq - 1, 0, s - 1)
    is_new_out = (n_new_leq > 0) & (ud_sorted[prev] == j)
    new_u = usrc[prev]

    arena_src = jnp.clip(j - n_new_leq, 0, c - 1)
    from_arena = (~is_new_out) & (j - n_new_leq < n_avalid) & (j - n_new_leq >= 0)

    src_u = jnp.where(is_new_out, new_u, 0)
    out_keys = jnp.where(
        is_new_out[:, None],
        ukeys[src_u],
        jnp.where(
            from_arena[:, None],
            arena.keys[arena_src],
            jnp.asarray(dets.invalid_det(w)),
        ),
    )

    pos_in_uniq = jnp.clip(
        dets.searchsorted_dets(ukeys, arena.keys[arena_src]), 0, s - 1
    )
    hit = (
        from_arena
        & dets.det_eq(ukeys[pos_in_uniq], arena.keys[arena_src])
        & found[pos_in_uniq]
    )
    base_vals = jnp.where(from_arena[None, :], arena.vals[:, arena_src], 0)
    add_rows = jnp.where(hit[None, :], contrib_rows[:, pos_in_uniq], 0.0)
    add_rows = jnp.where(
        is_new_out[None, :], contrib_rows[:, src_u], add_rows
    )
    out_vals = base_vals + add_rows.astype(arena.vals.dtype)

    new_arena = Arena(
        keys=out_keys,
        vals=out_vals,
        n_used=jnp.minimum(n_avalid + n_new, c)[None],
    )
    return new_arena, {"overflow": overflow, "nonini_occ_add": nonini_occ_add}
