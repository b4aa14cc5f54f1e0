"""Independent numpy reference of the arena merge (accumulate with the
initiator rule), in the spirit of dense_fci.py: plain dict accumulation over
spawns, sharing no code with ``runtime/arena.py``.

Semantics (reference two-pass add, vec_utils.hpp:606-641): a spawn counts
when its own initiator flag is set or its target already holds a nonzero
value in the gating row; a target that receives at least one counted spawn
and is not yet stored becomes a new entry; stored entries keep their values
and receive the summed counted contributions.
"""

import numpy as np

SENTINEL = np.iinfo(np.uint32).max


def arena_entries(keys, vals):
    """{key tuple: value vector} of the valid rows of an arena."""
    keys = np.asarray(keys)
    vals = np.asarray(vals)
    out = {}
    for i in range(keys.shape[0]):
        if np.all(keys[i] == SENTINEL):
            continue
        out[tuple(int(w) for w in keys[i])] = vals[:, i].astype(np.float64)
    return out


def merge(entries, n_rows, capacity, spawn_keys, spawn_vals, spawn_ini,
          spawn_rows=None, gate_row=0, dest_row=0):
    """Accumulate spawns into ``entries`` (dict key -> (R,) values).

    ``spawn_rows`` (per-spawn destination rows, gated on the same row)
    selects the multi-row layout; otherwise every spawn gates on
    ``gate_row`` and lands on ``dest_row``.

    Returns (entries, overflow, nonini_occ_add).
    """
    out = {k: v.copy() for k, v in entries.items()}
    add = {}
    live = set()
    nonini_occ = 0
    for i in range(len(spawn_vals)):
        key = tuple(int(w) for w in np.asarray(spawn_keys[i]))
        if all(w == SENTINEL for w in key):
            continue
        row = int(spawn_rows[i]) if spawn_rows is not None else dest_row
        gate = row if spawn_rows is not None else gate_row
        occupied = key in entries and entries[key][gate] != 0
        if not spawn_ini[i] and occupied:
            nonini_occ += 1
        if spawn_ini[i] or occupied:
            live.add(key)
            acc = add.setdefault(key, np.zeros(n_rows))
            acc[row] += float(spawn_vals[i])
    n_new = sum(1 for k in live if k not in entries)
    overflow = len(entries) + n_new > capacity
    for key, acc in add.items():
        out[key] = out.get(key, np.zeros(n_rows)) + acc
    return out, overflow, nonini_occ


def compact(entries, keep_rows):
    """Drop entries whose keep predicate (key, values) is False."""
    return {k: v for k, v in entries.items() if keep_rows(k, v)}
