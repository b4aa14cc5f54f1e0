"""Small indexing and reduction helpers shared by the samplers.

Each helper is the plain XLA form of its operation (gather, scatter, cumsum,
f64 matmul), with the out-of-range convention the samplers rely on: an index
outside ``[0, size)`` - negative ones included - reads 0 instead of wrapping
or clamping.  Padding slots carry such indices (``n_orb``, ``K``, ``-1``), so
they contribute nothing downstream.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def _in_range(idx: jax.Array, size: int) -> jax.Array:
    """``idx`` with every entry outside [0, size) moved to ``size``, which a
    fill-mode gather reads as 0 (plain JAX indexing wraps negatives)."""
    idx = idx.astype(jnp.int32)
    return jnp.where((idx >= 0) & (idx < size), idx, size)


def _batch_iotas(lead: tuple, out_ndim: int) -> tuple:
    """Index arrays selecting every position of the leading dims ``lead``,
    right-aligned against an ``out_ndim``-dim broadcast result (size-1 dims
    broadcast as index 0)."""
    off = out_ndim - len(lead)
    idx = []
    for a, n in enumerate(lead):
        shape = [1] * out_ndim
        shape[off + a] = n
        idx.append(jnp.arange(n, dtype=jnp.int32).reshape(shape)
                   if n > 1 else jnp.zeros(shape, jnp.int32))
    return tuple(idx)


def row_cumsum(x: jax.Array) -> jax.Array:
    """Inclusive f32 cumulative sum along the last (short) axis.

    Exact for rank counts (< 2^24); f32 rounding for normalized weight rows.
    Returns f32; cast at the call site.
    """
    return jnp.cumsum(x.astype(jnp.float32), axis=-1)


def take_small(table: jax.Array, idx: jax.Array) -> jax.Array:
    """``table[idx]`` for a small 1-D table; out-of-range indices read 0."""
    t = table.shape[0]
    return table.at[_in_range(idx, t)].get(mode="fill", fill_value=0)


def take2_small(table: jax.Array, i: jax.Array, j: jax.Array) -> jax.Array:
    """``table[i, j]`` for a small 2-D table; out-of-range pairs read 0.

    When ``j`` has more dims than ``i``, ``i`` indexes the leading ones;
    otherwise ``i`` and ``j`` broadcast as usual."""
    if j.ndim > i.ndim:
        i = i.reshape(i.shape + (1,) * (j.ndim - i.ndim))
    t1, t2 = table.shape
    return table.at[_in_range(i, t1), _in_range(j, t2)].get(
        mode="fill", fill_value=0)


def take_rows_small(table: jax.Array, idx: jax.Array) -> jax.Array:
    """Row gather ``table[idx]`` from a small (T, C) table: shape
    ``idx.shape + (C,)``; out-of-range rows read 0."""
    t = table.shape[0]
    return table.at[_in_range(idx, t)].get(mode="fill", fill_value=0)


def take_along_small(rows: jax.Array, j: jax.Array) -> jax.Array:
    """``rows[..., j]`` in-row select: ``j`` broadcasts against
    ``rows[..., 0]`` and the result has the broadcast shape; out-of-range
    ``j`` reads 0.  The leading dims of ``rows`` are indexed, not
    materialized at the broadcast shape."""
    k = rows.shape[-1]
    out_ndim = len(jnp.broadcast_shapes(rows.shape[:-1], j.shape))
    lead = _batch_iotas(rows.shape[:-1], out_ndim)
    return rows.at[lead + (_in_range(j, k),)].get(mode="fill", fill_value=0)


def count_matmul_f64(counts: jax.Array, table: jax.Array) -> jax.Array:
    """``counts @ table`` in f64: (..., K) occupancy counts against a
    (K, N) table, returned as (..., N) f64."""
    return jnp.matmul(counts.astype(jnp.float64), table.astype(jnp.float64))


def rank_place(values: jax.Array, mask: jax.Array, n_out: int,
               fill) -> jax.Array:
    """Dense packing along the last axis: output slot r holds
    ``values[..., b]`` where b is the r-th True of ``mask``; missing slots
    get ``fill``, and Trues past ``n_out`` are dropped."""
    rank = jnp.cumsum(mask, axis=-1, dtype=jnp.int32) - 1
    dest = jnp.where(mask, rank, n_out)
    lead = values.shape[:-1]
    out = jnp.full(lead + (n_out,), fill, values.dtype)
    idx = tuple(ix[..., None] for ix in _batch_iotas(lead, len(lead)))
    return out.at[idx + (dest,)].set(values, mode="drop")
