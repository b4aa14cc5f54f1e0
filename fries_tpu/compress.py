"""Stochastic vector-compression kernels (the FRI heart).

Re-designs FRIES/compress_utils.{hpp,cpp} for a static-shape SPMD compiler:

* ``find_preserve`` (reference compress_utils.cpp:29-105): the sequential
  max-heap greedy "preserve the largest exactly" rule becomes a *threshold
  fixpoint*: repeatedly keep every element with |v_i| >= S_rem/budget_rem until
  no additions.  The fixpoint set equals the reference's greedy set (verified
  against a sequential port in tests/test_compress.py).
* ``sys_comp`` (compress_utils.cpp:278-351): systematic (stratified)
  resampling becomes an exclusive prefix sum + shared random grid; the MPI
  broadcast of the grid seed (compress_utils.cpp:291) becomes using the same
  PRNG key on every shard, and the rank-prefix offset (``seed_sys``,
  compress_utils.cpp:107-127) becomes an ``all_gather`` of shard norms.
* ``comp_sub`` (find_keep_sub + sys_sub, compress_utils.cpp:130-276, 702-820):
  hierarchical compression over elements subdivided uniformly (``ndiv``) or by
  weight rows.  Emission uses an output-slot inversion - each of the
  statically-shaped output slots looks up its (parent, sub) source - so no
  dynamic expansion is ever required.
* ``round_binomially`` (compress_utils.cpp:19-27), shift controllers
  (compress_utils.cpp:684-700), and Walker alias tables (compress_utils.cpp:
  823-897) round out the module.

Collectives: every function takes ``axis_name=None``; pass the mesh axis name
when running under ``shard_map`` and the same code runs on 1..N chips.
"""

from __future__ import annotations

from functools import partial

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax

from fries_tpu import kernels
from fries_tpu.kernels import row_cumsum


# ---------------------------------------------------------------------------
# collective helpers
# ---------------------------------------------------------------------------

def _gsum(x, axis_name):
    return lax.psum(x, axis_name) if axis_name else x


def _prefix_sum_over_shards(local: jax.Array, axis_name):
    """Sum of ``local`` over shards with lower axis index (0 on one shard)."""
    if not axis_name:
        return jnp.zeros_like(local)
    all_vals = lax.all_gather(local, axis_name)
    idx = lax.axis_index(axis_name)
    mask = jnp.arange(all_vals.shape[0]) < idx
    return jnp.sum(jnp.where(mask, all_vals, 0), axis=0)


# ---------------------------------------------------------------------------
# stochastic rounding (reference round_binomially, compress_utils.cpp:19-27)
# ---------------------------------------------------------------------------

def round_binomially(key: jax.Array, p: jax.Array, n: jax.Array) -> jax.Array:
    """Unbiased integer rounding: floor(p)*n + Binomial(n, frac(p)).

    ``p`` may be any float array; ``n`` a matching integer array (number of
    independent rounding trials per element).
    """
    flr = jnp.floor(p)
    frac = p - flr
    draws = jax.random.binomial(key, n.astype(jnp.float32), frac.astype(jnp.float32))
    return flr.astype(jnp.int32) * n.astype(jnp.int32) + draws.astype(jnp.int32)


def stochastic_round(key: jax.Array, p: jax.Array) -> jax.Array:
    """Round each element to floor or ceil, unbiased (n=1 case)."""
    flr = jnp.floor(p)
    frac = p - flr
    u = jax.random.uniform(key, p.shape, dtype=p.dtype)
    return flr + (u < frac).astype(p.dtype)


# ---------------------------------------------------------------------------
# greedy-threshold seeding
#
# The greedy "preserve the largest exactly" rule (compress_utils.cpp:29-105)
# has thresholds that strictly DESCEND from T0 = tot_mass/n_samp as elements
# are preserved, so any weight-threshold prefix {u >= t} with t >= T_final is
# a state on the greedy trajectory.  We bound T_final from above with one
# fused pass computing cumulative mass/cost above geometric edges T0*2^-k,
# simulate the greedy over whole buckets, and back off one bucket for float
# safety.  Seeding the exact fixpoint with {u >= T_est} converges in ~2 rounds
# instead of one round per threshold cascade step - the while_loop rounds were
# the dominant kernel-dispatch cost at production sizes.
# ---------------------------------------------------------------------------

_SEED_EDGES = 20


def _preserve_threshold_seed(parts, n_samp, tot_mass, axis_name):
    """Conservative upper bound T_est >= the final greedy preserve threshold.

    ``parts``: list of (u, mass, cost) with u = per-budget-unit weight
    (0 = inactive), mass = u*cost the preserved 1-norm, cost = budget units
    consumed if preserved (None = 1).  Guarantee: every item with
    u >= T_est is in the greedy preserve set.
    """
    nb = _SEED_EDGES
    n_sampf = jnp.maximum(n_samp, 1).astype(jnp.float64)
    t0 = tot_mass / n_sampf
    edges = t0 * jnp.exp2(-2.0 * jnp.arange(nb, dtype=jnp.float64))  # 4x-spaced

    mass_above = jnp.zeros((nb,), jnp.float64)
    cost_above = jnp.zeros((nb,), jnp.float64)
    for u, mass, cost in parts:
        uf = u.reshape(-1)
        if (mass is u and uf.dtype == jnp.float32 and cost is None
                and uf.shape[0] >= 8192):
            # f32 staged rows: accumulate the 20 edge-reductions in f32
            # tiles with an f64 outer stage (counts per tile < 2^24 stay
            # exact in f32). Tile errors ~1e-5 relative sit
            # far inside the one-bucket (4x) backoff below; in the
            # measure-zero tie case where T_est still lands below the greedy
            # threshold, the fixpoint over-preserves - which is exact and
            # unbiased (budget clamps at 0) and at worst trips the loud
            # spawn-cap overflow abort, never a silent bias.
            c = 8192
            tns = uf.shape[0] // c * c
            ur = uf[:tns].reshape(-1, c)
            ge_t = ur[None] >= edges[:, None, None].astype(jnp.float32)
            m1 = jnp.sum(jnp.where(ge_t, ur[None], 0.0), axis=2,
                         dtype=jnp.float32)
            c1 = jnp.sum(ge_t, axis=2, dtype=jnp.float32)
            mass_above = mass_above + jnp.sum(m1, axis=1, dtype=jnp.float64)
            cost_above = cost_above + jnp.sum(c1, axis=1, dtype=jnp.float64)
            if tns < uf.shape[0]:
                tail = uf[tns:]
                ge = tail[None, :] >= edges[:, None]
                mass_above = mass_above + jnp.sum(
                    jnp.where(ge, tail[None, :], 0.0), axis=1,
                    dtype=jnp.float64)
                cost_above = cost_above + jnp.sum(ge, axis=1,
                                                  dtype=jnp.float64)
            continue
        ge = uf[None, :] >= edges[:, None]  # fused into the reductions below
        mass_above = mass_above + jnp.sum(
            jnp.where(ge, mass.reshape(-1)[None, :], 0.0), axis=1,
            dtype=jnp.float64,
        )
        if cost is None:
            cost_above = cost_above + jnp.sum(ge, axis=1, dtype=jnp.float64)
        else:
            cost_above = cost_above + jnp.sum(
                jnp.where(ge, cost.reshape(-1)[None, :].astype(jnp.float64), 0.0),
                axis=1, dtype=jnp.float64,
            )
    return _seed_finish(mass_above, cost_above, n_samp, tot_mass, axis_name)


def _seed_edges(tot_mass, n_samp):
    """Geometric (4x-spaced) threshold edges below T0 = tot_mass/n_samp."""
    n_sampf = jnp.maximum(n_samp, 1).astype(jnp.float64)
    t0 = tot_mass / n_sampf
    return t0 * jnp.exp2(-2.0 * jnp.arange(_SEED_EDGES, dtype=jnp.float64))


def _seed_finish(mass_above, cost_above, n_samp, tot_mass, axis_name):
    """Greedy simulation over whole histogram buckets -> conservative T_est
    (see _preserve_threshold_seed); histogram accumulated by the caller."""
    n_sampf = jnp.maximum(n_samp, 1).astype(jnp.float64)
    t0 = tot_mass / n_sampf
    edges = _seed_edges(tot_mass, n_samp)
    mass_above = _gsum(mass_above, axis_name)
    cost_above = _gsum(cost_above, axis_name)

    zero1 = jnp.zeros((1,), jnp.float64)
    cm_excl = jnp.concatenate([zero1, mass_above[:-1]])
    cc_excl = jnp.concatenate([zero1, cost_above[:-1]])
    budget_rem = n_sampf - cc_excl
    thr_before = (tot_mass - cm_excl) / jnp.maximum(budget_rem, 1e-300)
    ok = (budget_rem > 0) & (cost_above <= n_sampf) & (edges >= thr_before)
    prefix_ok = jnp.cumsum((~ok).astype(jnp.int32)) == 0
    b_last = jnp.sum(prefix_ok, dtype=jnp.int32) - 1
    t_est = jnp.where(
        b_last >= 0,
        t0 * jnp.exp2(-2.0 * jnp.maximum(b_last - 1, 0).astype(jnp.float64)),
        jnp.inf,
    )
    return jnp.where(tot_mass > 0, t_est, jnp.inf)


# ---------------------------------------------------------------------------
# exact preservation (reference find_preserve, compress_utils.cpp:29-105)
# ---------------------------------------------------------------------------

@partial(jax.jit, static_argnames=("axis_name", "max_rounds"))
def find_preserve(
    abs_vals: jax.Array,
    n_samp: jax.Array,
    axis_name: str | None = None,
    max_rounds: int = 64,
):
    """Select elements to preserve exactly before stochastic resampling.

    An element is preserved when its magnitude is at least the remaining mean
    mass per remaining sample, iterated to a fixpoint.

    Args:
      abs_vals: (N,) nonnegative magnitudes (zeros are ignored).
      n_samp:   total (global) sample budget, int.

    Returns:
      keep:        (N,) bool preservation mask.
      n_samp_left: global budget remaining for stochastic samples (int32).
      loc_norm:    this shard's 1-norm of non-preserved elements (f64).

    The returned budget is zero when the residual global norm is negligible
    (reference semantics, compress_utils.cpp:93-96).
    """
    abs_vals = abs_vals.astype(jnp.float64)
    n_samp = jnp.asarray(n_samp, dtype=jnp.int32)

    tot_mass = _gsum(jnp.sum(abs_vals), axis_name)
    t_est = _preserve_threshold_seed(
        [(abs_vals, abs_vals, None)], n_samp, tot_mass, axis_name
    )

    def cond(state):
        keep, n_added, rounds = state
        return (n_added > 0) & (rounds < max_rounds)

    def body(state):
        keep, _, rounds = state
        rem_mask = (~keep) & (abs_vals > 0)
        loc_norm = jnp.sum(jnp.where(rem_mask, abs_vals, 0.0))
        glob_norm = _gsum(loc_norm, axis_name)
        n_kept = _gsum(jnp.sum(keep, dtype=jnp.int32), axis_name)
        budget = jnp.maximum(n_samp - n_kept, 0)
        threshold = jnp.where(
            budget > 0, glob_norm / jnp.maximum(budget, 1).astype(jnp.float64), jnp.inf
        )
        new_keep = keep | (rem_mask & (abs_vals >= threshold))
        n_added = _gsum(
            jnp.sum(new_keep & ~keep, dtype=jnp.int32), axis_name
        )
        return new_keep, n_added, rounds + 1

    keep0 = abs_vals >= t_est
    keep, _, _ = lax.while_loop(cond, body, (keep0, jnp.int32(1), jnp.int32(0)))

    rem_mask = (~keep) & (abs_vals > 0)
    loc_norm = jnp.sum(jnp.where(rem_mask, abs_vals, 0.0))
    glob_norm = _gsum(loc_norm, axis_name)
    n_kept = _gsum(jnp.sum(keep, dtype=jnp.int32), axis_name)
    n_samp_left = jnp.maximum(n_samp - n_kept, 0)
    n_samp_left = jnp.where(glob_norm < 1e-9, 0, n_samp_left)
    return keep, n_samp_left, loc_norm


# ---------------------------------------------------------------------------
# systematic resampling (reference sys_comp, compress_utils.cpp:278-351)
# ---------------------------------------------------------------------------

def _grid_count_below(x, rn, unit):
    """Number of grid points (rn + k)*unit, k >= 0, strictly below x."""
    raw = jnp.floor(x / unit - rn) + 1
    return jnp.maximum(raw, 0.0).astype(jnp.int64)


@partial(jax.jit, static_argnames=("axis_name",))
def sys_comp(
    vals: jax.Array,
    keep: jax.Array,
    n_samp: jax.Array,
    rn: jax.Array,
    loc_norm: jax.Array,
    axis_name: str | None = None,
):
    """Systematic resampling of the non-preserved elements.

    Preserved elements pass through unchanged; each non-preserved element is
    replaced by sign * glob_norm/n_samp times the number of shared-grid points
    landing in its interval (0 for most).  Unbiased: E[out] = in.

    Args:
      vals:     (N,) signed values.
      keep:     (N,) preservation mask from :func:`find_preserve`.
      n_samp:   remaining global sample budget (0 -> zero all non-preserved).
      rn:       shared uniform random number in [0, 1) - must be identical on
                every shard (same PRNG key).
      loc_norm: this shard's non-preserved 1-norm (from find_preserve).

    Returns new values (N,), same dtype as ``vals``.
    """
    dtype = vals.dtype
    vals64 = vals.astype(jnp.float64)
    absw = jnp.where(~keep, jnp.abs(vals64), 0.0)
    glob_norm = _gsum(loc_norm, axis_name)
    lbound = _prefix_sum_over_shards(loc_norm, axis_name)

    unit = jnp.where(n_samp > 0, glob_norm / jnp.maximum(n_samp, 1), jnp.inf)
    cum = lbound + jnp.cumsum(absw) - absw  # exclusive prefix within shard
    n_below_start = _grid_count_below(cum, rn, unit)
    n_below_end = _grid_count_below(cum + absw, rn, unit)
    hits = (n_below_end - n_below_start).astype(jnp.float64)
    sampled_val = jnp.sign(vals64) * hits * unit
    new_vals = jnp.where(keep, vals64, jnp.where(n_samp > 0, sampled_val, 0.0))
    return new_vals.astype(dtype)


def compress_vector(
    vals: jax.Array,
    n_samp: jax.Array,
    rn: jax.Array,
    axis_name: str | None = None,
):
    """find_preserve + sys_comp in one call (the per-iteration vector step)."""
    keep, n_left, loc_norm = find_preserve(jnp.abs(vals), n_samp, axis_name=axis_name)
    return sys_comp(vals, keep, n_left, rn, loc_norm, axis_name=axis_name)


# ---------------------------------------------------------------------------
# pivotal resampling (reference piv_samp_serial, compress_utils.cpp:390-527)
# ---------------------------------------------------------------------------

@partial(jax.jit, static_argnames=())
def piv_comp_serial(key: jax.Array, vals: jax.Array, keep: jax.Array, n_samp, loc_norm):
    """Pivotal resampling of the non-preserved elements of one shard.

    Log-depth tournament formulation of Srinivasan's pivotal sampling: sampling
    units are the systematic strata; within each stratum elements duel pairwise
    so inclusion is +/-1-correlated only locally.  Like the reference
    (compress_utils.cpp:390-527) each element is selected at most once and
    E[out] = in.

    This implementation uses the equivalent "ordered pivotal sampling"
    formulation: with inclusion probabilities p_i = |v_i|/unit summing to
    n_samp, strata boundaries at integers of the cumulative p, the element
    straddling each boundary duels the stratum residual.  Here we implement it
    as a sequential scan (lax.scan over elements), which is exact and O(N) -
    adequate because pivotal compression is only used by the subspace drivers
    where N is the post-preservation remainder.
    """
    dtype = vals.dtype
    vals64 = vals.astype(jnp.float64)
    absw = jnp.where(~keep, jnp.abs(vals64), 0.0)
    n = vals.shape[0]
    unit = jnp.where(n_samp > 0, loc_norm / jnp.maximum(n_samp, 1), jnp.inf)
    p = jnp.where(absw > 0, absw / unit, 0.0)  # inclusion probabilities

    uniforms = jax.random.uniform(key, (n,), dtype=jnp.float64)

    # Sequential pairwise duel (Deville-Tille pivotal method in natural order):
    # carry = (residual probability, residual index, residual selected?)
    def step(carry, inp):
        res_p, res_idx, out_sel = carry
        pi, u, idx = inp
        active = pi > 0
        tot = res_p + pi

        def duel(res_p, pi, u):
            # combined mass < 1: one of the two survives as residual
            take_new = u < pi / jnp.maximum(tot, 1e-300)
            return take_new

        def spill(res_p, pi, u):
            # combined mass >= 1: one is selected, remainder carries on
            sel_new = u < (1.0 - res_p) / jnp.maximum(2.0 - tot, 1e-300)
            return sel_new

        small = tot < 1.0
        take_new = duel(res_p, pi, u)
        sel_new = spill(res_p, pi, u)

        # case tot < 1: winner takes mass tot, loser dies (select prob 0)
        new_res_p_small = tot
        new_res_idx_small = jnp.where(take_new, idx, res_idx)
        sel_now_small = jnp.int32(-1)  # nobody finalized

        # case tot >= 1: selected element finalized with value unit,
        # the other continues with mass tot - 1
        sel_idx_big = jnp.where(sel_new, idx, res_idx)
        cont_idx_big = jnp.where(sel_new, res_idx, idx)
        new_res_p_big = tot - 1.0
        new_res_idx_big = cont_idx_big

        new_res_p = jnp.where(small, new_res_p_small, new_res_p_big)
        new_res_idx = jnp.where(small, new_res_idx_small, new_res_idx_big)
        finalized = jnp.where(small, sel_now_small, sel_idx_big)

        new_res_p = jnp.where(active, new_res_p, res_p)
        new_res_idx = jnp.where(active, new_res_idx, res_idx)
        finalized = jnp.where(active, finalized, jnp.int32(-1))
        return (new_res_p, new_res_idx, out_sel), finalized

    init = (jnp.float64(0.0), jnp.int32(-1), jnp.int32(-1))
    (res_p, res_idx, _), finalized = lax.scan(
        step, init, (p, uniforms, jnp.arange(n, dtype=jnp.int32))
    )
    # final residual survives with probability res_p
    last_u = jax.random.uniform(jax.random.fold_in(key, 1), dtype=jnp.float64)
    res_selected = (last_u < res_p) & (res_idx >= 0)

    selected = jnp.zeros((n,), dtype=jnp.bool_)
    selected = selected.at[jnp.where(finalized >= 0, finalized, n)].set(
        True, mode="drop"
    )
    selected = selected.at[jnp.where(res_selected, res_idx, n)].set(True, mode="drop")

    sampled_val = jnp.sign(vals64) * unit
    new_vals = jnp.where(
        keep, vals64, jnp.where(selected & (n_samp > 0), sampled_val, 0.0)
    )
    return new_vals.astype(dtype)


def piv_select_tree(key: jax.Array, p: jax.Array) -> jax.Array:
    """Pivotal (Deville-Tille) 0/1 selection with inclusion probabilities
    ``p`` (each in [0, 1]) via a log-depth pairing tournament.

    The reference's pivotal resampling (piv_samp_serial,
    compress_utils.cpp:390-527) passes a residual element sequentially; the
    pivotal method is unbiased for ANY duel order, so a binary pairing tree
    gives the same marginals E[sel_i] = p_i in O(log N) vectorized rounds.
    The number selected is floor(sum p) or
    ceil(sum p).

    Returns a bool mask of selected elements.
    """
    n = p.shape[0]
    levels = max(1, int(np.ceil(np.log2(max(n, 2)))))
    size = 1 << levels
    pr = jnp.zeros((size,), jnp.float64).at[:n].set(p.astype(jnp.float64))
    idx = jnp.concatenate(
        [jnp.arange(n, dtype=jnp.int32),
         jnp.full((size - n,), n, jnp.int32)]
    )
    sel = jnp.zeros((n,), jnp.bool_)

    for lev in range(levels):
        m = size >> (lev + 1)
        pa, pb = pr[0::2], pr[1::2]
        ia, ib = idx[0::2], idx[1::2]
        u = jax.random.uniform(
            jax.random.fold_in(key, lev), (m,), dtype=jnp.float64
        )
        tot = pa + pb
        small = tot <= 1.0
        # tot <= 1: winner absorbs the pair's mass, loser's prob drops to 0
        take_a_small = u * jnp.maximum(tot, 1e-300) < pa
        # tot > 1: one element is finalized selected, the other carries tot-1
        sel_a_big = u * jnp.maximum(2.0 - tot, 1e-300) < (1.0 - pb)
        new_p = jnp.where(small, tot, tot - 1.0)
        new_i = jnp.where(
            small,
            jnp.where(take_a_small, ia, ib),
            jnp.where(sel_a_big, ib, ia),  # the non-selected one continues
        )
        fin = jnp.where(
            small, jnp.int32(n), jnp.where(sel_a_big, ia, ib)
        )
        sel = sel.at[fin].set(True, mode="drop")
        pr, idx = new_p, new_i

    # final residual survives with its leftover probability
    u_last = jax.random.uniform(jax.random.fold_in(key, levels), dtype=jnp.float64)
    sel = sel.at[jnp.where(u_last < pr[0], idx[0], n)].set(True, mode="drop")
    return sel


def piv_select_tree_2d(key: jax.Array, p: jax.Array) -> jax.Array:
    """Pivotal 0/1 selection over a (N, K) probability grid.

    Pivotal sampling is unbiased under ANY duel order (Deville-Tille;
    reference piv_samp_serial passes the residual sequentially,
    compress_utils.cpp:390-527), so the duels here pair columns within each
    row first - vectorized lane-axis rounds with scatter-free bitfield
    marking of finalized selections - and the per-row residuals then duel
    across rows through :func:`piv_select_tree` (whose scatters total N
    elements instead of N*K).  Marginals are exactly E[sel] = p, and the
    total selected is floor(sum p) or ceil(sum p), same as the 1-D tree.

    Returns a (N, K) bool mask.
    """
    n, k = p.shape
    lev_k = max(1, int(np.ceil(np.log2(max(k, 2)))))
    kpow = 1 << lev_k
    nw = -(-kpow // 32)  # selection bitfield words per row
    pr = jnp.zeros((n, kpow), jnp.float64).at[:, :k].set(p.astype(jnp.float64))
    idx = jnp.broadcast_to(
        jnp.arange(kpow, dtype=jnp.int32)[None, :], (n, kpow)
    )
    selbits = [jnp.zeros((n,), jnp.uint32) for _ in range(nw)]

    def mark(bits, fin):
        """OR one-hot column masks of ``fin`` (kpow = none) into the words."""
        f32w = (fin >> 5).astype(jnp.int32)
        onebit = jnp.left_shift(
            jnp.uint32(1), (fin & 31).astype(jnp.uint32)
        )
        for w in range(nw):
            hits = jnp.where(f32w == w, onebit, jnp.uint32(0))
            red = jax.lax.reduce(
                hits, jnp.uint32(0), jax.lax.bitwise_or, (1,)
            ) if fin.ndim == 2 else hits
            bits[w] = bits[w] | red
        return bits

    for lev in range(lev_k):
        m = kpow >> (lev + 1)
        pa, pb = pr[:, 0::2], pr[:, 1::2]
        ia, ib = idx[:, 0::2], idx[:, 1::2]
        u = jax.random.uniform(
            jax.random.fold_in(key, lev), (n, m), dtype=jnp.float64
        )
        tot = pa + pb
        small = tot <= 1.0
        take_a_small = u * jnp.maximum(tot, 1e-300) < pa
        sel_a_big = u * jnp.maximum(2.0 - tot, 1e-300) < (1.0 - pb)
        new_p = jnp.where(small, tot, tot - 1.0)
        new_i = jnp.where(
            small,
            jnp.where(take_a_small, ia, ib),
            jnp.where(sel_a_big, ib, ia),
        )
        fin = jnp.where(
            small, jnp.int32(kpow), jnp.where(sel_a_big, ia, ib)
        )
        selbits = mark(selbits, fin)
        pr, idx = new_p, new_i

    # cross-row tournament over the per-row residuals (1-D tree, N scatters)
    p_res = pr[:, 0]
    col_res = idx[:, 0]
    sel_rows = piv_select_tree(jax.random.fold_in(key, 997), p_res)
    selbits = mark(selbits, jnp.where(sel_rows, col_res, jnp.int32(kpow)))

    colids = jnp.arange(k, dtype=jnp.int32)
    sel = jnp.zeros((n, k), jnp.bool_)
    for w in range(nw):
        in_word = (colids >> 5) == w
        bits = (
            jnp.right_shift(
                selbits[w][:, None],
                (colids & 31).astype(jnp.uint32)[None, :],
            )
            & jnp.uint32(1)
        ) > 0
        sel = sel | (in_word[None, :] & bits)
    return sel


def piv_comp_shard(key, vals: jax.Array, keep: jax.Array, n_budget, loc_norm):
    """Pivotal resampling of one shard's non-preserved elements against its
    own budget (the per-rank stage of piv_comp_parallel,
    compress_utils.cpp:354-387).

    Elements whose magnitude reaches the local unit loc_norm/n_budget are
    preserved exactly first - this is the reference's ``adjust_probs``
    magnitude capping (compress_utils.cpp:617-681) expressed as the
    equivalent greedy-preserve rule (a capped element is selected with
    probability 1 at its own value).  The remainder is tree-pivotal sampled.
    """
    dtype = vals.dtype
    vals64 = vals.astype(jnp.float64)
    stoch = jnp.where(keep, 0.0, jnp.abs(vals64))
    # local capping fixpoint == adjust_probs (prob-1 elements kept exactly)
    cap_keep, n_left, cap_norm = find_preserve(stoch, n_budget)
    unit = jnp.where(n_left > 0, cap_norm / jnp.maximum(n_left, 1), jnp.inf)
    p = jnp.where(cap_keep, 0.0, jnp.minimum(stoch / unit, 1.0))
    m = p.shape[0]
    if m % 128 == 0 and m >= 256:
        # blocked duel order (unbiased for any order): lane-axis rounds
        # within 128-wide blocks, then a cross-block tree - scatter volume
        # drops from m to m/128 elements
        selected = piv_select_tree_2d(key, p.reshape(-1, 128)).reshape(-1)
    else:
        selected = piv_select_tree(key, p)
    out = jnp.where(
        keep | cap_keep,
        vals64,
        jnp.where(selected & (n_left > 0), jnp.sign(vals64) * unit, 0.0),
    )
    return out.astype(dtype)


@partial(jax.jit, static_argnames=("axis_name",))
def piv_comp(key, vals: jax.Array, n_samp, axis_name: str | None = None):
    """Full pivotal vector compression: global find_preserve, per-shard
    pivotal budgets, adjust_probs capping, tree-pivotal resampling
    (reference piv_comp_parallel, compress_utils.cpp:354-387).

    ``key`` must be identical on all shards (the reference scatters budgets
    from rank 0; here every shard derives the same budget split from the
    gathered norms)."""
    keep, n_left, loc_norm = find_preserve(
        jnp.abs(vals), n_samp, axis_name=axis_name
    )
    if axis_name:
        shard_norms = lax.all_gather(loc_norm, axis_name)
        budgets = piv_budget(jax.random.fold_in(key, 1), shard_norms, n_left)
        my_budget = budgets[lax.axis_index(axis_name)]
        shard_key = jax.random.fold_in(
            jax.random.fold_in(key, 2), lax.axis_index(axis_name)
        )
    else:
        my_budget = n_left
        shard_key = key
    return piv_comp_shard(shard_key, vals, keep, my_budget, loc_norm)


@partial(jax.jit, static_argnames=("axis_name",))
def multi_comp(key, vals: jax.Array, keep: jax.Array, n_samp, loc_norm,
               axis_name: str | None = None):
    """Multinomial compression of the non-preserved elements: counts ~
    Multinomial(n_samp, |v|/norm), value = sign * unit * count (reference
    compress_vecs_multi's two-level alias sampling, vec_utils.cpp:73-127).

    The alias tables become a searchsorted of n_samp uniform
    draws against the cumulative weight (exact multinomial); the two-level
    rank/element split becomes the shard-prefix offset.
    """
    dtype = vals.dtype
    vals64 = vals.astype(jnp.float64)
    absw = jnp.where(~keep, jnp.abs(vals64), 0.0)
    glob_norm = _gsum(loc_norm, axis_name)
    lbound = _prefix_sum_over_shards(loc_norm, axis_name)
    n_samp = jnp.asarray(n_samp, jnp.int32)
    unit = jnp.where(n_samp > 0, glob_norm / jnp.maximum(n_samp, 1), jnp.inf)

    cum = lbound + jnp.cumsum(absw)  # inclusive prefix within shard
    # same key on every shard -> same global draws; each shard counts the
    # draws landing in its own interval.  The draw count must be static: draw
    # len(vals) uniforms and mask those beyond n_samp (every driver satisfies
    # budget <= vector capacity).
    u = jax.random.uniform(key, (vals.shape[0],), dtype=jnp.float64)
    # mask draws beyond the budget BEFORE sorting (masking after would keep
    # the smallest uniforms - a low-position bias)
    live_draw = jnp.arange(vals.shape[0]) < n_samp
    draws = jnp.sort(jnp.where(live_draw, u, jnp.inf)) * glob_norm
    pos = jnp.searchsorted(cum, draws, side="left")
    counts = jnp.zeros((vals.shape[0],), jnp.int32).at[pos].add(
        1, mode="drop"
    )
    sampled = jnp.sign(vals64) * unit * counts.astype(jnp.float64)
    out = jnp.where(keep, vals64, jnp.where(n_samp > 0, sampled, 0.0))
    return out.astype(dtype)


def piv_budget(key, shard_norms: jax.Array, n_samp):
    """Integer per-shard budgets from shard norms with pivotal remainders.

    Deterministic floor allocation plus pivotal sampling of the fractional
    remainders (reference piv_budget, compress_utils.cpp:560-615).  Every
    shard computes the same result from the gathered norms (no scatter).
    """
    glob = jnp.sum(shard_norms)
    n_samp = jnp.asarray(n_samp, jnp.int32)
    unit = glob / jnp.maximum(n_samp, 1)
    base = jnp.floor(shard_norms / jnp.maximum(unit, 1e-300)).astype(jnp.int32)
    frac = shard_norms / jnp.maximum(unit, 1e-300) - base
    short = n_samp - jnp.sum(base)
    keep = jnp.zeros(shard_norms.shape, jnp.bool_)
    extra = piv_comp_serial(
        key,
        frac,
        keep,
        short,
        jnp.sum(frac),
    )
    return base + (extra > 0).astype(jnp.int32)


# ---------------------------------------------------------------------------
# subdivided (hierarchical) compression
# reference find_keep_sub/sys_sub/comp_sub, compress_utils.cpp:130-276,702-820
# ---------------------------------------------------------------------------

@partial(
    jax.jit,
    static_argnames=(
        "out_size", "axis_name", "max_rounds", "emit_chunk",
    ),
)
def comp_sub(
    values: jax.Array,
    ndiv: jax.Array,
    sub_weights: jax.Array,
    sub_mask: jax.Array,
    n_samp,
    rn: jax.Array,
    out_size: int,
    axis_name: str | None = None,
    max_rounds: int = 64,
    emit_chunk: int = 0,
):
    """One level of hierarchical compression.

    Each parent element i carries nonnegative weight ``values[i]`` subdivided
    either uniformly into ``ndiv[i]`` parts (when ndiv[i] > 0) or according to
    the normalized probability row ``sub_weights[i, :]`` (when ndiv[i] == 0;
    entries with ``sub_mask`` False are ignored).  Sub-elements above the FRI
    preservation threshold are kept exactly; the remainder is systematically
    resampled on a shared grid.  Unbiased: E[sum of outputs mapped back] = in.

    Args:
      values:      (N,) parent weights (>= 0; 0 = inactive parent).
      ndiv:        (N,) int32 uniform-subdivision counts (0 = weighted).
      sub_weights: (N, K) probability rows, each summing to 1 over sub_mask.
                   May be float32: per-sub masses are then held in f32 (halves
                   the dominant stage bandwidth; norms/grid stay f64).
      sub_mask:    (N, K) bool validity of weighted subs.
      n_samp:      total (global) sample budget.
      rn:          shared uniform in [0, 1) (identical on all shards).
      out_size:    static output capacity M.
      emit_chunk:  chunk the output-slot inversion over slots via lax.map
                   (bounds the (chunk, K) emission temporaries; 0 = one pass).

    Returns (out_vals (M,), out_parent (M,) int32, out_sub (M,) int32,
    n_out (int32 count of valid slots), overflowed (bool)).
    """
    n, k = sub_weights.shape
    values = values.astype(jnp.float64)
    cdtype = sub_weights.dtype if sub_weights.dtype == jnp.float32 else jnp.float64
    n_samp = jnp.asarray(n_samp, jnp.int32)

    uniform = (ndiv > 0) & (values > 0)
    weighted = (ndiv == 0) & (values > 0)
    # per-sub masses for weighted parents (held in the sub_weights dtype)
    w_sub = jnp.where(
        weighted[:, None] & sub_mask,
        values.astype(cdtype)[:, None] * sub_weights.astype(cdtype),
        jnp.asarray(0.0, cdtype),
    )
    w_uni = jnp.where(uniform, values, 0.0)
    ndiv_f = jnp.maximum(ndiv, 1).astype(jnp.float64)
    # scale-relative floor for sub-weight preservation (the reference gates on
    # the *global* residual norm, compress_utils.cpp:93-96; an absolute floor
    # would change behavior for small-norm vectors)
    tot_norm0 = _gsum(
        jnp.sum(w_sub, dtype=jnp.float64) + jnp.sum(w_uni), axis_name
    )
    w_floor = jnp.asarray(1e-14 * tot_norm0, cdtype)

    # ---- preservation: seeded threshold fixpoint (reference find_keep_sub) --
    t_est = _preserve_threshold_seed(
        [
            (w_sub, w_sub, None),
            (w_uni / ndiv_f, w_uni, ndiv_f),
        ],
        n_samp, tot_norm0, axis_name,
    )

    # scalar-threshold fixpoint: thresholds descend monotonically, so the
    # final greedy set is exactly {u >= thr_final} - carrying the scalar
    # instead of the (N, K) boolean mask keeps the loop state tiny and lets
    # the emission recompute keep masks from thr on the fly
    u_uni = w_uni / ndiv_f

    def _counts_at(thr):
        kept_sub_t = (w_sub > w_floor) & (w_sub >= thr)
        kept_uni_t = (w_uni > 0) & (u_uni >= thr)
        loc = (
            jnp.sum(jnp.where(kept_sub_t, jnp.asarray(0.0, cdtype), w_sub),
                    dtype=jnp.float64)
            + jnp.sum(jnp.where(kept_uni_t, 0.0, w_uni))
        )
        budget_used = jnp.sum(kept_sub_t, dtype=jnp.int32) + jnp.sum(
            jnp.where(kept_uni_t, ndiv, 0), dtype=jnp.int32
        )
        return loc, budget_used

    def cond(state):
        thr, n_kept, n_prev, rounds = state
        return (n_kept != n_prev) & (rounds < max_rounds)

    def body(state):
        thr, n_kept, _, rounds = state
        loc, used = _counts_at(thr)
        glob_norm = _gsum(loc, axis_name)
        used_g = _gsum(used, axis_name)
        budget = jnp.maximum(n_samp - used_g, 0)
        new_thr = jnp.where(
            budget > 0,
            glob_norm / jnp.maximum(budget, 1).astype(jnp.float64),
            thr,
        )
        # thresholds only descend (each preserved element lowers the ratio)
        new_thr = jnp.minimum(new_thr, thr)
        return new_thr, used_g, n_kept, rounds + 1

    thr_f, _, _, _ = lax.while_loop(
        cond, body, (t_est, jnp.int32(-1), jnp.int32(-2), jnp.int32(0))
    )
    keep_sub = (w_sub > w_floor) & (w_sub >= thr_f)
    keep_uni = (w_uni > 0) & (u_uni >= thr_f)

    rem_uni = jnp.where(keep_uni, 0.0, w_uni)
    loc_norm, kept_budget = _counts_at(thr_f)
    glob_norm = _gsum(loc_norm, axis_name)
    n_grid = jnp.maximum(n_samp - _gsum(kept_budget, axis_name), 0)
    # zero the stochastic budget only when the residual *global norm* is
    # negligible (reference compress_utils.cpp:93-96), not per-sample unit
    n_grid = jnp.where(glob_norm < 1e-9, 0, n_grid)
    unit = jnp.where(n_grid > 0, glob_norm / jnp.maximum(n_grid, 1), jnp.inf)

    # ---- emission bookkeeping ----
    # per-parent non-kept mass; cumulative in parent-major order across shards
    parent_rem = jnp.sum(
        jnp.where(keep_sub, jnp.asarray(0.0, cdtype), w_sub),
        axis=1, dtype=jnp.float64,
    ) + rem_uni  # (N,)
    shard_lbound = _prefix_sum_over_shards(loc_norm, axis_name)
    cum_parent = shard_lbound + jnp.cumsum(parent_rem) - parent_rem  # exclusive

    # grid hits per parent
    g_start = _grid_count_below(cum_parent, rn, unit)
    g_end = _grid_count_below(cum_parent + parent_rem, rn, unit)
    grid_counts = jnp.where(n_grid > 0, (g_end - g_start), 0).astype(jnp.int32)

    # kept-emission counts per parent
    kept_counts = jnp.where(keep_uni, ndiv, jnp.sum(keep_sub, axis=1, dtype=jnp.int32))
    counts = kept_counts + grid_counts
    offsets = jnp.cumsum(counts) - counts  # exclusive, local to this shard
    total = jnp.sum(counts)
    overflow = total > out_size

    # ---- output-slot inversion (optionally chunked over slots) ----
    col_ids = jnp.arange(k, dtype=jnp.int32)
    # one consolidated per-parent payload: a single row gather per chunk
    # replaces eight separate scalar gathers (each costs a full gather pass;
    # g_start/offsets are exact in f64 up to 2^53)
    payload = jnp.stack(
        [
            offsets.astype(jnp.float64),
            kept_counts.astype(jnp.float64),
            g_start.astype(jnp.float64),
            cum_parent,
            parent_rem,
            values,
            ndiv_f,
            uniform.astype(jnp.float64),
        ],
        axis=1,
    )
    # pack payload + w_sub row into ONE per-parent row so the emission does a
    # single row gather per chunk.  Only for f64 sub-weights: f32 rows keep
    # two gathers (one f64 payload row + one f32 w_sub row)
    pack_one = cdtype != jnp.float32
    if pack_one:
        packed = jnp.concatenate([payload, w_sub], axis=1)

    def emit(slot):
        valid = slot < total
        # parent of each slot: offsets and slots are both ascending, so one
        # sort-based searchsorted resolves every slot
        parent = jnp.searchsorted(
            offsets, slot, side="right", method="sort"
        ).astype(jnp.int32) - 1
        parent = jnp.clip(parent, 0, n - 1)
        if pack_one:
            prow = packed[parent]                       # (M', 8 + K)
            pay = prow[:, :8]
            w_rows = prow[:, 8:]                        # (M', K) cdtype
        else:
            pay = payload[parent]                       # (M', 8) f64
            w_rows = w_sub[parent]                      # (M', K) f32
        p_offset = pay[:, 0].astype(jnp.int32)
        p_kept_counts = pay[:, 1].astype(jnp.int32)
        p_g_start = pay[:, 2]
        p_cum_parent = pay[:, 3]
        p_parent_rem = pay[:, 4]
        p_values = pay[:, 5]
        p_ndiv_f = pay[:, 6]
        p_uniform = pay[:, 7] != 0.0

        r = slot - p_offset
        is_kept_emit = r < p_kept_counts

        # keep masks recomputed from the scalar final threshold - no second
        # (M', K) gather
        keep_rows = (w_rows > w_floor) & (w_rows >= thr_f)
        rem_rows_v = jnp.where(keep_rows, jnp.asarray(0.0, cdtype), w_rows)

        # kept emissions: column of the r-th kept sub in the parent's row
        # (fused rank compare instead of a scatter-built inverse map)
        kept_rank_rows = row_cumsum(keep_rows).astype(jnp.int32) - 1
        kept_hit = keep_rows & (kept_rank_rows == r[:, None])
        kept_col = jnp.sum(jnp.where(kept_hit, col_ids, 0), axis=1)
        kept_sub_idx = jnp.where(p_uniform, r, kept_col)
        kept_val = jnp.where(
            p_uniform,
            p_values / p_ndiv_f,
            kernels.take_along_small(
                w_rows, jnp.clip(kept_sub_idx, 0, k - 1)
            ).astype(jnp.float64),
        )

        # grid-hit emissions
        g = p_g_start + (r - p_kept_counts).astype(jnp.float64)
        x = (rn + g) * unit  # grid point position
        y = x - p_cum_parent  # offset into parent's non-kept mass
        # uniform parent: sub index from uniform split of parent mass
        uni_sub = jnp.clip(
            jnp.floor(y / jnp.maximum(p_parent_rem, 1e-300) * p_ndiv_f),
            0,
            p_ndiv_f - 1,
        ).astype(jnp.int32)
        # weighted parent: first non-kept sub whose cumulative exceeds y;
        # the within-row exclusive cumsum is recomputed per chunk in f64
        rem_rows = rem_rows_v > 0
        row_cum_incl = row_cumsum(rem_rows_v).astype(jnp.float64)
        wt_sub = jnp.sum(
            (row_cum_incl <= y[:, None]) & rem_rows, axis=1, dtype=jnp.int32
        )
        # clamp to the last non-kept sub: protects the boundary case where the
        # row cumsum rounds below the f64 parent mass used for grid counting
        wt_sub = jnp.minimum(
            wt_sub,
            jnp.maximum(jnp.sum(rem_rows, axis=1, dtype=jnp.int32) - 1, 0),
        )
        # map count of exhausted subs to the actual column index of the next
        # non-kept sub (fused rank compare)
        nonkept_rank_rows = row_cumsum(rem_rows).astype(jnp.int32) - 1
        nk_hit = rem_rows & (nonkept_rank_rows == wt_sub[:, None])
        wt_sub_col = jnp.sum(jnp.where(nk_hit, col_ids, 0), axis=1)

        grid_sub_idx = jnp.where(p_uniform, uni_sub, wt_sub_col)

        out_sub = jnp.where(is_kept_emit, kept_sub_idx, grid_sub_idx)
        out_val = jnp.where(is_kept_emit, kept_val, unit)
        out_val = jnp.where(valid, out_val, 0.0)
        out_parent = jnp.where(valid, parent, -1)
        out_sub = jnp.where(valid, out_sub, -1)
        return out_val, out_parent, out_sub

    if emit_chunk and emit_chunk < out_size:
        n_chunks = -(-out_size // emit_chunk)
        slots = jnp.arange(n_chunks * emit_chunk, dtype=jnp.int32).reshape(
            n_chunks, emit_chunk
        )
        out_val, out_parent, out_sub = lax.map(emit, slots)
        out_val = out_val.reshape(-1)[:out_size]
        out_parent = out_parent.reshape(-1)[:out_size]
        out_sub = out_sub.reshape(-1)[:out_size]
    else:
        out_val, out_parent, out_sub = emit(jnp.arange(out_size, dtype=jnp.int32))
    return out_val, out_parent, out_sub, jnp.minimum(total, out_size), overflow


def comp_sub_factored(
    values: jax.Array,
    ndiv: jax.Array,
    fac_a: jax.Array,
    fac_b: jax.Array,
    n_samp,
    rn: jax.Array,
    out_size: int,
    kill_b0: jax.Array | None = None,
    axis_name: str | None = None,
    max_rounds: int = 64,
    emit_chunk: int = 0,
    row_chunk: int = 0,
):
    """comp_sub over a RANK-1 FACTORED probability row, never materializing
    the (N, E*V) joint stage.

    Weighted parents (ndiv == 0) carry the joint sub-weight row
        w_sub[i, e*V + v] = values[i] * fac_a[i, e] * fac_b[i, v]
    (optionally zeroing the v = 0 column where ``kill_b0[i, e]`` — the
    HB-PP unnormalized same-spin first-virtual exclusion).  This is the
    fused C+D (o2, u1) stage of apply_HBPP_sys (heat_bathPP.cpp:686-992):
    P(u1 | o1) does not involve o2, so the joint conditional factorizes.
    Materializing it at the 1e6 flagship rung costs (spawn_cap, 294) rows
    plus padded 3-D temporaries.  Here every (N, K) quantity is recomputed on the fly
    from the two factors, in ``row_chunk``-row chunks when requested:
    the histogram seed, the threshold fixpoint, the per-parent emission
    bookkeeping, and the per-slot emission rows.  Recomputation is
    bit-deterministic (identical elementwise expressions), so keep masks
    agree across passes.

    Semantics and returns match comp_sub(values, ndiv, joint, joint != 0,
    ...) up to float reassociation of the (values * a) * b product.
    ``row_chunk`` = 0 processes all rows in one pass.
    """
    n, e_k = fac_a.shape
    v_k = fac_b.shape[1]
    k = e_k * v_k
    values = values.astype(jnp.float64)
    cdtype = fac_a.dtype if fac_a.dtype == jnp.float32 else jnp.float64
    n_samp = jnp.asarray(n_samp, jnp.int32)

    uniform = (ndiv > 0) & (values > 0)
    weighted = (ndiv == 0) & (values > 0)
    # factor A carries the parent scale; inactive rows zeroed
    fa = jnp.where(
        weighted[:, None],
        values.astype(cdtype)[:, None] * fac_a.astype(cdtype),
        jnp.asarray(0.0, cdtype),
    )
    fb = fac_b.astype(cdtype)
    w_uni = jnp.where(uniform, values, 0.0)
    ndiv_f = jnp.maximum(ndiv, 1).astype(jnp.float64)

    # ---- chunked row recomputation ----
    if not row_chunk or row_chunk >= n:
        row_chunk = n
    n_chunks = -(-n // row_chunk)
    npad = n_chunks * row_chunk
    if npad > n:
        fa_p = jnp.pad(fa, ((0, npad - n), (0, 0)))
        fb_p = jnp.pad(fb, ((0, npad - n), (0, 0)))
        kill_p = (jnp.pad(kill_b0, ((0, npad - n), (0, 0)))
                  if kill_b0 is not None else None)
    else:
        fa_p, fb_p, kill_p = fa, fb, kill_b0
    col_v0 = (jnp.arange(k, dtype=jnp.int32) % v_k) == 0

    def _rows_of(a, b, kc):
        """(C, K) joint rows from (C, E) x (C, V) factors (2-D repeat/tile:
        no (C, E, V) 3-D intermediate)."""
        w = jnp.repeat(a, v_k, axis=1) * jnp.tile(b, (1, e_k))
        if kc is not None:
            kmask = jnp.repeat(kc, v_k, axis=1) & col_v0[None, :]
            w = jnp.where(kmask, jnp.asarray(0.0, cdtype), w)
        return w

    def _chunk_rows(i):
        a = lax.dynamic_slice_in_dim(fa_p, i * row_chunk, row_chunk)
        b = lax.dynamic_slice_in_dim(fb_p, i * row_chunk, row_chunk)
        kc = (lax.dynamic_slice_in_dim(kill_p, i * row_chunk, row_chunk)
              if kill_p is not None else None)
        return _rows_of(a, b, kc)

    # ---- pass 1: total stage mass ----
    def _tot_body(i, acc):
        return acc + jnp.sum(_chunk_rows(i), dtype=jnp.float64)

    w_sub_tot = lax.fori_loop(0, n_chunks, _tot_body, jnp.float64(0.0))
    tot_norm0 = _gsum(w_sub_tot + jnp.sum(w_uni), axis_name)
    w_floor = jnp.asarray(1e-14 * tot_norm0, cdtype)

    # ---- pass 2: histogram seed for the preserve threshold ----
    edges = _seed_edges(tot_norm0, n_samp)
    edges_c = edges.astype(cdtype)

    def _hist_body(i, acc):
        m_acc, c_acc = acc
        w = _chunk_rows(i)
        ge = w[None] >= edges_c[:, None, None]
        # inner reduction over K stays in the stage dtype (counts <= K are
        # f32-exact; mass tile error ~1e-7 relative sits inside the seed's
        # one-bucket backoff), outer accumulation in f64
        m1 = jnp.sum(jnp.where(ge, w[None], jnp.asarray(0.0, cdtype)),
                     axis=2, dtype=cdtype)
        c1 = jnp.sum(ge, axis=2, dtype=jnp.int32)
        m_acc = m_acc + jnp.sum(m1, axis=1, dtype=jnp.float64)
        c_acc = c_acc + jnp.sum(c1, axis=1, dtype=jnp.float64)
        return m_acc, c_acc

    mass_above, cost_above = lax.fori_loop(
        0, n_chunks, _hist_body,
        (jnp.zeros((_SEED_EDGES,), jnp.float64),
         jnp.zeros((_SEED_EDGES,), jnp.float64)),
    )
    # uniform parents' contribution (per-budget-unit weight w_uni/ndiv)
    u_uni = w_uni / ndiv_f
    ge_u = u_uni[None, :] >= edges[:, None]
    mass_above = mass_above + jnp.sum(
        jnp.where(ge_u, w_uni[None, :], 0.0), axis=1, dtype=jnp.float64
    )
    cost_above = cost_above + jnp.sum(
        jnp.where(ge_u, ndiv_f[None, :], 0.0), axis=1, dtype=jnp.float64
    )
    t_est = _seed_finish(mass_above, cost_above, n_samp, tot_norm0, axis_name)

    # ---- scalar-threshold fixpoint (chunked _counts_at) ----
    def _counts_at(thr):
        def body(i, acc):
            loc_a, used_a = acc
            w = _chunk_rows(i)
            kept = (w > w_floor) & (w >= thr)
            loc_a = loc_a + jnp.sum(
                jnp.where(kept, jnp.asarray(0.0, cdtype), w),
                dtype=jnp.float64,
            )
            used_a = used_a + jnp.sum(kept, dtype=jnp.int32)
            return loc_a, used_a

        loc, used = lax.fori_loop(
            0, n_chunks, body, (jnp.float64(0.0), jnp.int32(0))
        )
        kept_uni_t = (w_uni > 0) & (u_uni >= thr)
        loc = loc + jnp.sum(jnp.where(kept_uni_t, 0.0, w_uni))
        used = used + jnp.sum(
            jnp.where(kept_uni_t, ndiv, 0), dtype=jnp.int32
        )
        return loc, used

    def cond(state):
        thr, n_kept, n_prev, rounds = state
        return (n_kept != n_prev) & (rounds < max_rounds)

    def body(state):
        thr, n_kept, _, rounds = state
        loc, used = _counts_at(thr)
        glob_norm = _gsum(loc, axis_name)
        used_g = _gsum(used, axis_name)
        budget = jnp.maximum(n_samp - used_g, 0)
        new_thr = jnp.where(
            budget > 0,
            glob_norm / jnp.maximum(budget, 1).astype(jnp.float64),
            thr,
        )
        new_thr = jnp.minimum(new_thr, thr)
        return new_thr, used_g, n_kept, rounds + 1

    thr_f, _, _, _ = lax.while_loop(
        cond, body, (t_est, jnp.int32(-1), jnp.int32(-2), jnp.int32(0))
    )
    keep_uni = (w_uni > 0) & (u_uni >= thr_f)
    rem_uni = jnp.where(keep_uni, 0.0, w_uni)

    # ---- final pass: per-parent non-kept mass + kept counts ----
    def _final_body(i, acc):
        pr, kc = acc
        w = _chunk_rows(i)
        kept = (w > w_floor) & (w >= thr_f)
        pr = lax.dynamic_update_slice_in_dim(
            pr,
            jnp.sum(jnp.where(kept, jnp.asarray(0.0, cdtype), w),
                    axis=1, dtype=jnp.float64),
            i * row_chunk, 0,
        )
        kc = lax.dynamic_update_slice_in_dim(
            kc, jnp.sum(kept, axis=1, dtype=jnp.int32), i * row_chunk, 0
        )
        return pr, kc

    parent_rem_w, kept_counts_w = lax.fori_loop(
        0, n_chunks, _final_body,
        (jnp.zeros((npad,), jnp.float64), jnp.zeros((npad,), jnp.int32)),
    )
    parent_rem_w = parent_rem_w[:n]
    kept_counts_w = kept_counts_w[:n]

    # scalars derived FROM the per-parent arrays so the grid bookkeeping is
    # self-consistent (comp_sub tolerates the same reassociation slack)
    loc_norm = jnp.sum(parent_rem_w) + jnp.sum(rem_uni)
    kept_budget = jnp.sum(kept_counts_w) + jnp.sum(
        jnp.where(keep_uni, ndiv, 0), dtype=jnp.int32
    )
    glob_norm = _gsum(loc_norm, axis_name)
    n_grid = jnp.maximum(n_samp - _gsum(kept_budget, axis_name), 0)
    n_grid = jnp.where(glob_norm < 1e-9, 0, n_grid)
    unit = jnp.where(n_grid > 0, glob_norm / jnp.maximum(n_grid, 1), jnp.inf)

    # ---- emission bookkeeping (as comp_sub) ----
    parent_rem = parent_rem_w + rem_uni
    shard_lbound = _prefix_sum_over_shards(loc_norm, axis_name)
    cum_parent = shard_lbound + jnp.cumsum(parent_rem) - parent_rem
    g_start = _grid_count_below(cum_parent, rn, unit)
    g_end = _grid_count_below(cum_parent + parent_rem, rn, unit)
    grid_counts = jnp.where(n_grid > 0, (g_end - g_start), 0).astype(jnp.int32)
    kept_counts = jnp.where(keep_uni, ndiv, kept_counts_w)
    counts = kept_counts + grid_counts
    offsets = jnp.cumsum(counts) - counts
    total = jnp.sum(counts)
    overflow = total > out_size

    payload = jnp.stack(
        [
            offsets.astype(jnp.float64),
            kept_counts.astype(jnp.float64),
            g_start.astype(jnp.float64),
            cum_parent,
            parent_rem,
            values,
            ndiv_f,
            uniform.astype(jnp.float64),
        ],
        axis=1,
    )
    # one factor-row gather per chunk: fa | fb | kill as f32 0/1 columns
    fab_cols = [fa.astype(cdtype), fb]
    if kill_b0 is not None:
        fab_cols.append(kill_b0.astype(cdtype))
    fab = jnp.concatenate(fab_cols, axis=1)
    col_ids = jnp.arange(k, dtype=jnp.int32)

    def emit(slot):
        valid = slot < total
        parent = jnp.searchsorted(
            offsets, slot, side="right", method="sort"
        ).astype(jnp.int32) - 1
        parent = jnp.clip(parent, 0, n - 1)
        pay = payload[parent]
        frow = fab[parent]
        a_rows = frow[:, :e_k]
        b_rows = frow[:, e_k : e_k + v_k]
        k_rows = (frow[:, e_k + v_k :] != 0) if kill_b0 is not None else None
        # identical elementwise construction to _rows_of -> bit-identical
        # keep masks vs the fixpoint passes
        w_rows = _rows_of(a_rows, b_rows, k_rows)

        p_offset = pay[:, 0].astype(jnp.int32)
        p_kept_counts = pay[:, 1].astype(jnp.int32)
        p_g_start = pay[:, 2]
        p_cum_parent = pay[:, 3]
        p_parent_rem = pay[:, 4]
        p_values = pay[:, 5]
        p_ndiv_f = pay[:, 6]
        p_uniform = pay[:, 7] != 0.0

        r = slot - p_offset
        is_kept_emit = r < p_kept_counts

        keep_rows = (w_rows > w_floor) & (w_rows >= thr_f)
        rem_rows_v = jnp.where(keep_rows, jnp.asarray(0.0, cdtype), w_rows)

        kept_rank_rows = row_cumsum(keep_rows).astype(jnp.int32) - 1
        kept_hit = keep_rows & (kept_rank_rows == r[:, None])
        kept_col = jnp.sum(jnp.where(kept_hit, col_ids, 0), axis=1)
        kept_sub_idx = jnp.where(p_uniform, r, kept_col)
        kept_val = jnp.where(
            p_uniform,
            p_values / p_ndiv_f,
            kernels.take_along_small(
                w_rows, jnp.clip(kept_sub_idx, 0, k - 1)
            ).astype(jnp.float64),
        )

        g = p_g_start + (r - p_kept_counts).astype(jnp.float64)
        x = (rn + g) * unit
        y = x - p_cum_parent
        uni_sub = jnp.clip(
            jnp.floor(y / jnp.maximum(p_parent_rem, 1e-300) * p_ndiv_f),
            0,
            p_ndiv_f - 1,
        ).astype(jnp.int32)
        rem_rows = rem_rows_v > 0
        row_cum_incl = row_cumsum(rem_rows_v).astype(jnp.float64)
        wt_sub = jnp.sum(
            (row_cum_incl <= y[:, None]) & rem_rows, axis=1, dtype=jnp.int32
        )
        wt_sub = jnp.minimum(
            wt_sub,
            jnp.maximum(jnp.sum(rem_rows, axis=1, dtype=jnp.int32) - 1, 0),
        )
        nonkept_rank_rows = row_cumsum(rem_rows).astype(jnp.int32) - 1
        nk_hit = rem_rows & (nonkept_rank_rows == wt_sub[:, None])
        wt_sub_col = jnp.sum(jnp.where(nk_hit, col_ids, 0), axis=1)

        grid_sub_idx = jnp.where(p_uniform, uni_sub, wt_sub_col)

        out_sub = jnp.where(is_kept_emit, kept_sub_idx, grid_sub_idx)
        out_val = jnp.where(is_kept_emit, kept_val, unit)
        out_val = jnp.where(valid, out_val, 0.0)
        out_parent = jnp.where(valid, parent, -1)
        out_sub = jnp.where(valid, out_sub, -1)
        return out_val, out_parent, out_sub

    if emit_chunk and emit_chunk < out_size:
        n_ch = -(-out_size // emit_chunk)
        slots = jnp.arange(n_ch * emit_chunk, dtype=jnp.int32).reshape(
            n_ch, emit_chunk
        )
        out_val, out_parent, out_sub = lax.map(emit, slots)
        out_val = out_val.reshape(-1)[:out_size]
        out_parent = out_parent.reshape(-1)[:out_size]
        out_sub = out_sub.reshape(-1)[:out_size]
    else:
        out_val, out_parent, out_sub = emit(
            jnp.arange(out_size, dtype=jnp.int32)
        )
    return out_val, out_parent, out_sub, jnp.minimum(total, out_size), overflow


@partial(
    jax.jit,
    static_argnames=("out_size", "max_ndiv", "axis_name", "max_rounds"),
)
def comp_sub_piv(
    values: jax.Array,
    ndiv: jax.Array,
    sub_weights: jax.Array,
    sub_mask: jax.Array,
    n_samp,
    key: jax.Array,
    out_size: int,
    max_ndiv: int = 0,
    axis_name: str | None = None,
    max_rounds: int = 64,
):
    """Pivotal variant of one hierarchical-compression level (the reference's
    apply_HBPP_piv stages, heat_bathPP.cpp:994-1419).

    The reference expands each stage's sub-elements into ``long_vec`` and
    runs piv_comp_parallel on the flattened items; here the expansion is the
    static (N, Kp) grid (uniform parents occupy the first ndiv columns with
    weight v/ndiv), preservation is the seeded greedy fixpoint over items,
    and the pivotal resampling is the log-depth tree tournament.  Same
    signature/semantics as :func:`comp_sub` but selection is pivotal (each
    sub selected at most once) and driven by ``key`` instead of a shared
    grid rn.

    ``max_ndiv``: static bound on ndiv values (0 = K covers them).
    """
    n, k = sub_weights.shape
    kp = max(k, max_ndiv)
    values = values.astype(jnp.float64)
    cdtype = sub_weights.dtype if sub_weights.dtype == jnp.float32 else jnp.float64
    n_samp = jnp.asarray(n_samp, jnp.int32)

    uniform = (ndiv > 0) & (values > 0)
    weighted = (ndiv == 0) & (values > 0)
    ndiv_f = jnp.maximum(ndiv, 1).astype(jnp.float64)
    col = jnp.arange(kp, dtype=jnp.int32)
    w_sub = jnp.zeros((n, kp), cdtype)
    w_sub = w_sub.at[:, :k].set(
        jnp.where(
            weighted[:, None] & sub_mask,
            values.astype(cdtype)[:, None] * sub_weights.astype(cdtype),
            jnp.asarray(0.0, cdtype),
        )
    )
    w_uni_each = jnp.where(
        uniform[:, None] & (col[None, :] < ndiv[:, None]),
        (values / ndiv_f).astype(cdtype)[:, None],
        jnp.asarray(0.0, cdtype),
    )
    w_flat = w_sub + w_uni_each  # (N, Kp), every sub an independent item

    tot_norm0 = _gsum(jnp.sum(w_flat, dtype=jnp.float64), axis_name)
    w_floor = jnp.asarray(1e-14 * tot_norm0, cdtype)

    # seeded greedy preserve over the flattened items (all cost 1); the
    # thresholds descend monotonically, so the final greedy set is exactly
    # {w >= thr_final} - carry the scalar threshold through the fixpoint
    # instead of the (N, Kp) mask (same structure as comp_sub's loop)
    t_est = _preserve_threshold_seed(
        [(w_flat, w_flat, None)], n_samp, tot_norm0, axis_name
    )

    def _counts_at(thr):
        kept_t = (w_flat > w_floor) & (w_flat >= thr)
        loc = jnp.sum(
            jnp.where(kept_t, jnp.asarray(0.0, cdtype), w_flat),
            dtype=jnp.float64,
        )
        return loc, jnp.sum(kept_t, dtype=jnp.int32)

    def cond(state):
        thr, n_kept, n_prev, rounds = state
        return (n_kept != n_prev) & (rounds < max_rounds)

    def body(state):
        thr, n_kept, _, rounds = state
        loc, used = _counts_at(thr)
        glob_norm = _gsum(loc, axis_name)
        used_g = _gsum(used, axis_name)
        budget = jnp.maximum(n_samp - used_g, 0)
        new_thr = jnp.where(
            budget > 0,
            glob_norm / jnp.maximum(budget, 1).astype(jnp.float64),
            thr,
        )
        new_thr = jnp.minimum(new_thr, thr)
        return new_thr, used_g, n_kept, rounds + 1

    thr_f, _, _, _ = lax.while_loop(
        cond, body, (t_est, jnp.int32(-1), jnp.int32(-2), jnp.int32(0))
    )
    keep = (w_flat > w_floor) & (w_flat >= thr_f)

    rem = jnp.where(keep, jnp.asarray(0.0, cdtype), w_flat)
    loc_norm = jnp.sum(rem, dtype=jnp.float64)
    glob_norm = _gsum(loc_norm, axis_name)
    n_kept_tot = _gsum(jnp.sum(keep, dtype=jnp.int32), axis_name)
    n_grid = jnp.maximum(n_samp - n_kept_tot, 0)
    n_grid = jnp.where(glob_norm < 1e-9, 0, n_grid)
    unit = jnp.where(n_grid > 0, glob_norm / jnp.maximum(n_grid, 1), jnp.inf)

    # per-shard pivotal budget + adjust_probs-equivalent local capping, then
    # the tree tournament over this shard's items
    if axis_name:
        shard_norms = lax.all_gather(loc_norm, axis_name)
        budgets = piv_budget(jax.random.fold_in(key, 1), shard_norms, n_grid)
        my_budget = budgets[lax.axis_index(axis_name)]
        shard_key = jax.random.fold_in(
            jax.random.fold_in(key, 2), lax.axis_index(axis_name)
        )
    else:
        my_budget = n_grid
        shard_key = key
    p = jnp.minimum(
        rem.astype(jnp.float64)
        / jnp.where(my_budget > 0, loc_norm / jnp.maximum(my_budget, 1), jnp.inf),
        1.0,
    )
    # 2-D blocked tournament: within-row duels + cross-row tree - the flat
    # (N*Kp,) tree would scatter ~N*Kp elements at finalization
    sel = piv_select_tree_2d(shard_key, p) & (my_budget > 0)

    flagged = keep | sel
    f_counts = jnp.sum(flagged, axis=1, dtype=jnp.int32)
    offsets = jnp.cumsum(f_counts) - f_counts
    total = jnp.sum(f_counts)
    overflow = total > out_size

    payload = jnp.stack(
        [offsets.astype(jnp.float64), values, ndiv_f,
         uniform.astype(jnp.float64)], axis=1,
    )
    slot = jnp.arange(out_size, dtype=jnp.int32)
    valid = slot < total
    parent = jnp.searchsorted(
        offsets, slot, side="right", method="sort"
    ).astype(jnp.int32) - 1
    parent = jnp.clip(parent, 0, n - 1)
    pay = payload[parent]
    r = slot - pay[:, 0].astype(jnp.int32)

    flag_rows = flagged[parent]
    keep_rows = keep[parent]
    rank_rows = row_cumsum(flag_rows).astype(jnp.int32) - 1
    hit = flag_rows & (rank_rows == r[:, None])
    sub_idx = jnp.sum(jnp.where(hit, col, 0), axis=1)
    is_kept = jnp.sum(jnp.where(hit, keep_rows, False), axis=1) > 0
    w_rows = w_flat[parent]
    kept_val = kernels.take_along_small(w_rows, sub_idx).astype(jnp.float64)
    out_val = jnp.where(is_kept, kept_val, unit)
    out_val = jnp.where(valid, out_val, 0.0)
    out_parent = jnp.where(valid, parent, -1)
    out_sub = jnp.where(valid, sub_idx, -1)
    return out_val, out_parent, out_sub, jnp.minimum(total, out_size), overflow


# ---------------------------------------------------------------------------
# energy-shift controllers (reference adjust_shift, compress_utils.cpp:684-700)
# ---------------------------------------------------------------------------

def adjust_shift(shift, one_norm, last_norm, target_norm, damp_factor):
    """Norm-control energy shift update.  Returns (new_shift, new_last_norm).

    Inactive until the norm first exceeds ``target_norm``; afterwards
    S <- S - damp * log(norm / last_norm).
    """
    active = last_norm != 0
    new_shift = jnp.where(
        active, shift - damp_factor * jnp.log(one_norm / jnp.where(active, last_norm, 1.0)), shift
    )
    new_last = jnp.where(
        active, one_norm, jnp.where(one_norm > target_norm, one_norm, last_norm)
    )
    return new_shift, new_last


def adjust_shift2(shift, one_norm, last_norm, damp_factor):
    """Multiplicative norm-factor controller for subspace iteration
    (reference adjust_shift2, compress_utils.cpp:695-700)."""
    new_shift = shift ** (1 - damp_factor) * (one_norm / last_norm) ** damp_factor
    new_last = last_norm**damp_factor * (one_norm / shift) ** (1 - damp_factor)
    return new_shift, new_last


# ---------------------------------------------------------------------------
# Walker alias tables (reference setup_alias/sample_alias,
# compress_utils.cpp:823-897).  Hot paths use inverse-CDF searchsorted instead,
# but the alias utilities are provided for parity and for CPU-side sampling.
# ---------------------------------------------------------------------------

def setup_alias(probs: np.ndarray):
    """Build Walker/Vose alias tables for one distribution (numpy, host-side)."""
    probs = np.asarray(probs, dtype=np.float64)
    n = probs.shape[0]
    aliases = np.arange(n, dtype=np.int64)
    alias_probs = n * probs.copy()
    small = [i for i in range(n) if alias_probs[i] < 1]
    big = [i for i in range(n) if alias_probs[i] >= 1]
    while small and big:
        s = small.pop()
        b = big[-1]
        aliases[s] = b
        alias_probs[b] += alias_probs[s] - 1
        if alias_probs[b] < 1:
            small.append(b)
            big.pop()
    return aliases, alias_probs


def sample_alias(key, aliases, alias_probs, shape):
    """Draw samples from an alias table (vectorized)."""
    aliases = jnp.asarray(aliases)
    alias_probs = jnp.asarray(alias_probs)
    n = aliases.shape[0]
    k1, k2 = jax.random.split(key)
    idx = jax.random.randint(k1, shape, 0, n)
    u = jax.random.uniform(k2, shape, dtype=jnp.float64)
    return jnp.where(u < alias_probs[idx], idx, aliases[idx]).astype(jnp.int32)


def sample_categorical_rows(key, probs: jax.Array, valid: jax.Array | None = None):
    """Inverse-CDF sample one index per row of a batch of small distributions.

    This replaces the per-sample alias tables in the hierarchical
    samplers: rows are short (<= n_states), so a cumsum + compare per row is
    cheaper than building tables.
    """
    p = probs.astype(jnp.float64)
    if valid is not None:
        p = jnp.where(valid, p, 0.0)
    tot = jnp.sum(p, axis=-1, keepdims=True)
    cum = row_cumsum(p).astype(jnp.float64)
    u = jax.random.uniform(key, probs.shape[:-1] + (1,), dtype=jnp.float64) * tot
    idx = jnp.sum((cum <= u).astype(jnp.int32), axis=-1)
    return jnp.minimum(idx, probs.shape[-1] - 1)
