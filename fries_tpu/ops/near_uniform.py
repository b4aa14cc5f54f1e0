"""Near-uniform symmetry-adapted excitation sampling, batched per attempt.

Re-designs FRIES/Hamiltonians/near_uniform.cpp (Booth et al. 2014 section
5.2) for batched arrays: the per-walker rejection/search loops (_doub_choose_virt1
near_uniform.cpp:91-170, _sing_choose_occ :248-257) become exact masked
rank-inversions over static orbital grids - every attempt draws directly from
the uniform distribution over allowed choices with one uniform variate, no
rejection.

All functions take a batch of sampling attempts, each tied to a parent
determinant (bits + occupied list + per-(irrep, spin) unoccupied counts from
ops.heat_bath.unocc_symm_counts).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from fries_tpu.ops import heat_bath as hb


def _uniform_index(key, count, maxval_shape):
    """Uniform integer in [0, count) per row (count >= 1 assumed where used)."""
    u = jax.random.uniform(key, count.shape, dtype=jnp.float64)
    return jnp.minimum((u * count).astype(jnp.int32), jnp.maximum(count - 1, 0))


def _masked_rank_select(mask, rank):
    """Index of the rank-th True per row; (idx, found)."""
    k = mask.shape[-1]
    cum = jnp.cumsum(mask.astype(jnp.int32), axis=-1) - 1
    hit = mask & (cum == rank[..., None])
    idx = jnp.sum(jnp.where(hit, jnp.arange(k, dtype=jnp.int32), 0), axis=-1)
    return idx, jnp.any(hit, axis=-1)


def tri_to_pair(n_elec: int, tri_idx):
    """Triangle inversion: pair index -> (elec_slot_hi, elec_slot_lo)
    (_tri_to_occ_pair, near_uniform.cpp:46-57)."""
    i1 = ((jnp.sqrt(tri_idx * 8.0 + 1.0) - 1.0) / 2.0).astype(jnp.int32)
    i2 = (tri_idx - i1 * (i1 + 1) // 2).astype(jnp.int32)
    i1 = i1 + 1
    return jnp.clip(i1, 0, n_elec - 1), jnp.clip(i2, 0, n_elec - 1)


def sample_doubles(key, n_orb, n_elec, symm, lookup, occ, occ_bits, counts):
    """One uniform symmetry-allowed double excitation per attempt.

    Args:
      occ: (B, E) occupied lists; occ_bits: (B, 2n) occupancy; counts:
      (B, 8, 2) unoccupied counts per (irrep, spin).

    Returns dict(o1, o2, u1, u2, prob, valid) - orbital quadruple with
    o1 < o2 and u1 < u2 and the generation probability
    (doub_multin, near_uniform.cpp:193-245).
    """
    b = occ.shape[0]
    half = n_elec // 2
    k1, k2, k3 = jax.random.split(key, 3)

    n_pairs = n_elec * (n_elec - 1) // 2
    tri = _uniform_index(k1, jnp.full((b,), n_pairs, jnp.int32), None)
    e_hi, e_lo = tri_to_pair(n_elec, tri.astype(jnp.float64))
    orb1 = jnp.take_along_axis(occ, e_hi[:, None], axis=-1)[:, 0]
    orb2 = jnp.take_along_axis(occ, e_lo[:, None], axis=-1)[:, 0]
    spin1 = orb1 // n_orb
    spin2 = orb2 // n_orb
    same_spin = spin1 == spin2
    sym_prod = symm[orb1 % n_orb] ^ symm[orb2 % n_orb]

    # ---- first virtual: uniform over allowed orbitals a with n_virt2(a) > 0
    all_orbs = jnp.arange(2 * n_orb, dtype=jnp.int32)
    a_spa = all_orbs % n_orb
    a_spin = all_orbs // n_orb
    unocc = ~occ_bits  # (B, 2n)
    # spin eligibility of a: same-spin pair -> a in their spin; opposite-spin
    # pair -> either spin (b then takes the other)
    spin_ok = jnp.where(
        same_spin[:, None], a_spin[None, :] == spin1[:, None], True
    )
    b_spin = jnp.where(
        same_spin[:, None],
        a_spin[None, :],
        spin1[:, None] ^ spin2[:, None] ^ a_spin[None, :],
    )
    b_symm = sym_prod[:, None] ^ symm[a_spa][None, :]
    n_virt2 = counts[
        jnp.arange(b)[:, None], b_symm, b_spin
    ] - ((sym_prod[:, None] == 0) & (a_spin[None, :] == b_spin)).astype(jnp.int32)
    a_mask = unocc & spin_ok & (n_virt2 > 0)
    m_a_allow = jnp.sum(a_mask, axis=-1)
    a_rank = _uniform_index(k2, jnp.maximum(m_a_allow, 1), None)
    u1, found1 = _masked_rank_select(a_mask, a_rank)
    valid = (m_a_allow > 0) & found1
    u1 = jnp.where(valid, u1, 0)
    u1_spin = u1 // n_orb
    u2_spin = jnp.where(same_spin, u1_spin, spin1 ^ spin2 ^ u1_spin)
    u1_symm = symm[u1 % n_orb]
    u2_symm = sym_prod ^ u1_symm

    # ---- second virtual: uniform over unoccupied same-symmetry orbitals != u1
    orb_row = lookup[u2_symm]  # (B, K) spatial
    row_valid = orb_row < n_orb
    cand = jnp.where(row_valid, orb_row, 0) + u2_spin[:, None] * n_orb
    cand_unocc = row_valid & ~hb.dets_read(occ_bits, cand, 2 * n_orb) & (cand != u1[:, None])
    m_ab = counts[jnp.arange(b), u2_symm, u2_spin] - (
        (sym_prod == 0) & (u1_spin == u2_spin)
    ).astype(jnp.int32)
    b_rank = _uniform_index(k3, jnp.maximum(m_ab, 1), None)
    u2, found2 = _masked_rank_select(cand_unocc, b_rank)
    u2 = jnp.take_along_axis(cand, jnp.clip(u2, 0, cand.shape[1] - 1)[:, None], axis=-1)[:, 0]
    valid &= (m_ab > 0) & found2

    # generation probability (near_uniform.cpp:229-230)
    m_ba = counts[jnp.arange(b), u1_symm, u1_spin] - (
        (sym_prod == 0) & (u1_spin == u2_spin)
    ).astype(jnp.int32)
    prob = (
        2.0
        / n_elec
        / (n_elec - 1)
        / jnp.maximum(m_a_allow, 1)
        * (1.0 / jnp.maximum(m_ab, 1) + 1.0 / jnp.maximum(m_ba, 1))
    )

    o1 = jnp.minimum(orb1, orb2)
    o2 = jnp.maximum(orb1, orb2)
    lo = jnp.minimum(u1, u2)
    hi = jnp.maximum(u1, u2)
    return {
        "o1": o1, "o2": o2, "u1": lo, "u2": hi,
        "prob": jnp.where(valid, prob, 1.0),
        "valid": valid,
    }


def sample_singles(key, n_orb, n_elec, symm, lookup, occ, occ_bits, counts):
    """One uniform symmetry-allowed single excitation per attempt
    (sing_multin, near_uniform.cpp:277-313)."""
    b = occ.shape[0]
    per_elec, _ = hb.sing_allowed(n_orb, n_elec, symm, counts, occ)
    allowed = per_elec > 0
    n_allowed = jnp.sum(allowed, axis=-1)
    k1, k2 = jax.random.split(key)
    e_rank = _uniform_index(k1, jnp.maximum(n_allowed, 1), None)
    e_idx, found_e = _masked_rank_select(allowed, e_rank)
    valid = (n_allowed > 0) & found_e
    e_idx = jnp.where(valid, e_idx, 0)
    o = jnp.take_along_axis(occ, e_idx[:, None], axis=-1)[:, 0]
    o_spin = o // n_orb
    g = symm[o % n_orb]
    orb_row = lookup[g]
    row_valid = orb_row < n_orb
    cand = jnp.where(row_valid, orb_row, 0) + o_spin[:, None] * n_orb
    cand_unocc = row_valid & ~hb.dets_read(occ_bits, cand, 2 * n_orb)
    m_allow = jnp.take_along_axis(per_elec, e_idx[:, None], axis=-1)[:, 0]
    u_rank = _uniform_index(k2, jnp.maximum(m_allow, 1), None)
    u_col, found_u = _masked_rank_select(cand_unocc, u_rank)
    u = jnp.take_along_axis(cand, jnp.clip(u_col, 0, cand.shape[1] - 1)[:, None], axis=-1)[:, 0]
    valid &= (m_allow > 0) & found_u
    prob = 1.0 / jnp.maximum(m_allow, 1) / jnp.maximum(n_allowed, 1)
    return {"o": o, "u": u, "prob": jnp.where(valid, prob, 1.0), "valid": valid}


def sample_doubles_heat_bath(key, tens, n_orb, n_elec, symm, lookup, occ,
                             occ_bits):
    """One heat-bath Power-Pitzer double excitation per attempt
    (hb_doub_multi, heat_bathPP.cpp:601-683), with the total normalized
    selection weight from ops.heat_bath.norm_weight."""
    from fries_tpu import compress

    b = occ.shape[0]
    k1, k2, k3, k4 = jax.random.split(key, 4)
    probs1, _ = hb.o1_probs(tens, n_orb, occ)
    o1_idx = compress.sample_categorical_rows(k1, probs1)
    probs2, _ = hb.o2_probs(tens, n_orb, n_elec, occ, o1_idx)
    o2_idx = compress.sample_categorical_rows(k2, probs2)
    o1 = jnp.take_along_axis(occ, o1_idx[:, None], axis=-1)[:, 0]
    o2 = jnp.take_along_axis(occ, o2_idx[:, None], axis=-1)[:, 0]

    probs_u1, _, virts = hb.u1_probs(tens, n_orb, n_elec, occ_bits, o1)
    u1_slot = compress.sample_categorical_rows(k3, probs_u1)
    n_virt = virts.shape[1]
    u1_sp = jnp.take_along_axis(
        virts, jnp.clip(u1_slot, 0, n_virt - 1)[:, None], axis=-1
    )[:, 0]
    u1 = jnp.where(u1_sp < n_orb, u1_sp, 0) + (o1 // n_orb) * n_orb

    probs_u2, u2_norm, orb_row = hb.u2_probs(
        tens, n_orb, symm, lookup, o1, o2, u1
    )
    u2_col = compress.sample_categorical_rows(k4, probs_u2)
    u2_sp = jnp.take_along_axis(
        orb_row, jnp.clip(u2_col, 0, orb_row.shape[1] - 1)[:, None], axis=-1
    )[:, 0]
    u2 = jnp.where(u2_sp < n_orb, u2_sp, 0) + (o2 // n_orb) * n_orb

    valid = (
        (jnp.sum(probs1, -1) > 0)
        & (jnp.sum(probs2, -1) > 0)
        & (jnp.sum(probs_u1, -1) > 0)
        & (u2_norm > 0)
        & (u1_sp < n_orb)
        & (u2_sp < n_orb)
        & ~hb.dets_read(occ_bits, u2[:, None], 2 * n_orb)[:, 0]
        & (u1 != u2)
    )

    o_lo = jnp.minimum(o1, o2)
    o_hi = jnp.maximum(o1, o2)
    u_lo = jnp.minimum(u1, u2)
    u_hi = jnp.maximum(u1, u2)
    prob = hb.norm_weight(
        tens, n_orb, n_elec, symm, lookup, occ, occ_bits, o_lo, o_hi, u_lo, u_hi
    )
    return {
        "o1": o_lo, "o2": o_hi, "u1": u_lo, "u2": u_hi,
        "prob": jnp.where(valid, prob, 1.0),
        "valid": valid,
    }
