"""Heat-bath Power-Pitzer (HB-PP) factorized Hamiltonian compression.

Re-designs FRIES/Hamiltonians/heat_bathPP.{hpp,cpp} for batched arrays: the
five-level
hierarchical sampling of double excitations (single-vs-double -> o1 -> o2 ->
u1 -> u2, apply_HBPP_sys heat_bathPP.cpp:686-992) becomes five batched
``comp_sub`` rounds over statically-shaped sample buffers.  Per-sample scalar
loops (calc_o1/o2/u1/u2_probs, heat_bathPP.cpp:182-412) become gather +
masked-reduction rows computed for the whole sample batch at once; alias
tables are unnecessary because compression itself does the selection.

Tensor conventions (setup, heat_bathPP.cpp:15-179): all tables are indexed by
*unfrozen spatial* orbitals and stored dense-square (the reference's
triangular packing trades memory for scalar indexing; batched code gathers
from dense tables):

  d_diff[i, j]  = sum_{a != i, b != j} |<i j | a b>|        (opposite spin)
  d_same[i, j]  = sum_{b < a; a,b not in {i,j}} 2 |<i j|a b> - <i j|b a>|
                  (symmetric, zero diagonal)
  s_tens[i]     = sum_j d_same[i, j] + sum_j d_diff[i, j]
  exch_sqrt[i, j] = sqrt(|<i j | j i>|), with diagonal sqrt(|<i i | i i>|)
  exch_norms[i] = sum_j exch_sqrt[i, j]

Both the normalized distribution (calc_norm_wt, heat_bathPP.cpp:442-598) and
the unnormalized "new" variant (calc_unnorm_wt, :414-439) are provided.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial

import numpy as np
import jax
import jax.numpy as jnp

from fries_tpu import dets, kernels
from fries_tpu.ops import molecule as mol


@partial(
    jax.tree_util.register_dataclass,
    data_fields=("d_same", "d_diff", "s_tens", "s_norm", "exch_sqrt", "exch_norms"),
    meta_fields=(),
)
@dataclass(frozen=True)
class HeatBathTensors:
    d_same: jax.Array      # (n, n) symmetric, zero diagonal
    d_diff: jax.Array      # (n, n)
    s_tens: jax.Array      # (n,)
    s_norm: jax.Array      # ()
    exch_sqrt: jax.Array   # (n, n); diagonal holds diag_sqrt
    exch_norms: jax.Array  # (n,)


def setup(ham: mol.MolecularHamiltonian) -> HeatBathTensors:
    """Precompute the HB-PP tensors from the ERIs (O(n_orb^4), one-time)."""
    n = ham.n_orb
    hf = ham.n_frozen // 2
    eri = np.asarray(ham.eris)[hf:, hf:, hf:, hf:]  # active block, physicist

    absv = np.abs(eri)
    i_idx = np.arange(n)
    ii = i_idx[:, None, None, None]
    jj = i_idx[None, :, None, None]
    aa = i_idx[None, None, :, None]
    bb = i_idx[None, None, None, :]

    # d_diff[i, j] = sum over a != i, b != j of |<ij|ab>|
    valid_diff = (aa != ii) & (bb != jj)
    d_diff = np.einsum("ijab,ijab->ij", absv, valid_diff.astype(float))

    # d_same[i, j] = sum_{b < a; a,b not in {i,j}} 2|<ij|ab> - <ij|ba>|
    anti = np.abs(eri - eri.transpose(0, 1, 3, 2))
    valid_same = (aa != ii) & (aa != jj) & (bb != ii) & (bb != jj) & (aa > bb)
    d_same = 2 * np.einsum("ijab,ijab->ij", anti, valid_same.astype(float))
    np.fill_diagonal(d_same, 0.0)

    s_tens = d_same.sum(1) + d_diff.sum(1)
    s_norm = s_tens.sum()

    exch = np.sqrt(np.abs(np.einsum("ijji->ij", eri)))
    diag = np.sqrt(np.abs(np.einsum("iiii->i", eri)))
    exch_sqrt = exch.copy()
    np.fill_diagonal(exch_sqrt, diag)
    exch_norms = exch_sqrt.sum(1)

    return HeatBathTensors(
        d_same=jnp.asarray(d_same),
        d_diff=jnp.asarray(d_diff),
        s_tens=jnp.asarray(s_tens),
        s_norm=jnp.asarray(s_norm),
        exch_sqrt=jnp.asarray(exch_sqrt),
        exch_norms=jnp.asarray(exch_norms),
    )


# ---------------------------------------------------------------------------
# batched probability rows (replace calc_o1/o2/u1/u2_probs scalar loops)
# ---------------------------------------------------------------------------

def o1_probs(tens: HeatBathTensors, n_orb: int, occ):
    """(B, E) normalized first-occupied weights s_tens[occ] (calc_o1_probs,
    heat_bathPP.cpp:182-200)."""
    w = kernels.take_small(tens.s_tens, occ % n_orb)
    norm = jnp.sum(w, axis=-1, keepdims=True)
    return w / jnp.maximum(norm, 1e-300), norm[..., 0]


def o2_probs(tens: HeatBathTensors, n_orb: int, n_elec: int, occ, o1_idx):
    """(B, E) normalized second-occupied weights given the slot of o1
    (calc_o2_probs, heat_bathPP.cpp:203-233)."""
    half = n_elec // 2
    o1_orb = jnp.take_along_axis(occ, o1_idx[..., None], axis=-1)[..., 0]
    o1_spin = o1_orb // n_orb
    occ_spin = (jnp.arange(n_elec) >= half).astype(jnp.int32)
    same = occ_spin[None, :] == o1_spin[..., None]
    occ_sp = occ % n_orb
    o1_sp = o1_orb % n_orb
    # one shared row fetch for both tables: the o1 rows of [d_same | d_diff]
    # ride a single one-hot matmul, then in-row selects by occ_sp
    cat = jnp.concatenate([tens.d_same, tens.d_diff], axis=1)
    rows = kernels.take_rows_small(cat, o1_sp)  # (..., 2 n_orb)
    w_same = kernels.take_along_small(rows[..., None, :n_orb], occ_sp)
    w_diff = kernels.take_along_small(rows[..., None, n_orb:], occ_sp)
    w = jnp.where(same, w_same, w_diff)
    w = jnp.where(jnp.arange(n_elec, dtype=jnp.int32)[None, :]
                  == o1_idx[..., None], 0.0, w)
    norm = jnp.sum(w, axis=-1, keepdims=True)
    return w / jnp.maximum(norm, 1e-300), norm[..., 0]


def o2_probs_half(tens, n_orb, n_elec, occ, o1_idx):
    """Ordered variant: only slots below o1 (calc_o2_probs_half,
    heat_bathPP.cpp:236-270); returns (probs, norm_fraction) where
    norm_fraction = norm / s_tens[o1]."""
    probs, norm = o2_probs(tens, n_orb, n_elec, occ, o1_idx)
    below = jnp.arange(n_elec, dtype=jnp.int32)[None, :] < o1_idx[..., None]
    w = probs * jnp.where(below, 1.0, 0.0) * norm[..., None]
    new_norm = jnp.sum(w, axis=-1, keepdims=True)
    o1_orb = jnp.take_along_axis(occ, o1_idx[..., None], axis=-1)[..., 0]
    frac = new_norm[..., 0] / jnp.maximum(
        kernels.take_small(tens.s_tens, o1_orb % n_orb), 1e-300
    )
    return w / jnp.maximum(new_norm, 1e-300), frac


def virtual_slots(n_orb: int, n_elec: int, occ_bits_spin):
    """Rank-inversion: (B, n_orb) spin-occupancy -> (B, n_virt) ascending
    unoccupied spatial orbitals (replaces find_nth_virt, fci_utils.c:138-148).

    Each spin sector holds exactly n_elec/2 electrons, so the number of
    virtuals is the static n_orb - n_elec/2.
    """
    n_virt = n_orb - n_elec // 2
    unocc = ~occ_bits_spin
    positions = jnp.broadcast_to(
        jnp.arange(n_orb, dtype=jnp.int32), occ_bits_spin.shape
    )
    return kernels.rank_place(positions, unocc, n_virt, jnp.int32(n_orb))


def u1_probs(tens: HeatBathTensors, n_orb, n_elec, occ_bits, o1_orb,
             exclude_first=None):
    """(B, n_virt) normalized first-virtual weights exch_sqrt[o1, v] over the
    unoccupied orbitals of o1's spin (calc_u1_probs, heat_bathPP.cpp:273-319).

    Returns (probs, norm_fraction, virt_orbs) with norm_fraction =
    norm / exch_norms[o1] (used by the unnormalized variant).
    """
    spin = o1_orb // n_orb
    spin_bits = jnp.where(
        (spin == 0)[:, None], occ_bits[:, :n_orb], occ_bits[:, n_orb : 2 * n_orb]
    )
    virts = virtual_slots(n_orb, n_elec, spin_bits)  # (B, n_virt)
    valid = virts < n_orb
    w = jnp.where(
        valid,
        kernels.take2_small(
            tens.exch_sqrt, o1_orb % n_orb, jnp.clip(virts, 0, n_orb - 1)
        ),
        0.0,
    )
    if exclude_first is not None:
        w = jnp.where(exclude_first[:, None] & (jnp.arange(w.shape[1]) == 0), 0.0, w)
    norm = jnp.sum(w, axis=-1, keepdims=True)
    frac = norm[..., 0] / jnp.maximum(
        kernels.take_small(tens.exch_norms, o1_orb % n_orb), 1e-300
    )
    return w / jnp.maximum(norm, 1e-300), frac, virts


def u2_probs(tens: HeatBathTensors, n_orb, symm, lookup, o1_orb, o2_orb,
             u1_orb, occ_bits=None, half=False, u1_lt=None):
    """(B, K) normalized second-virtual weights over the symmetry row of
    irrep(o1)^irrep(o2)^irrep(u1) (calc_u2_probs / _half,
    heat_bathPP.cpp:322-412).

    half=True (unnormalized variant): mask occupied targets and restrict
    same-spin pairs to u2 < u1.

    Returns (probs, norm_fraction, orb_row (B, K) spatial candidates).
    """
    o2_sp = o2_orb % n_orb
    u1_sp = u1_orb % n_orb
    same_spin = (o1_orb // n_orb) == (o2_orb // n_orb)
    g = (
        kernels.take_small(symm, o1_orb % n_orb)
        ^ kernels.take_small(symm, o2_sp)
        ^ kernels.take_small(symm, u1_sp)
    )
    orb_row = kernels.take_rows_small(lookup, g)  # (B, K) spatial, padded with n_orb
    valid = orb_row < n_orb
    w = jnp.where(
        valid,
        kernels.take2_small(
            tens.exch_sqrt, o2_sp, jnp.clip(orb_row, 0, n_orb - 1)
        ),
        0.0,
    )
    w = jnp.where(same_spin[:, None] & (orb_row == u1_sp[:, None]), 0.0, w)
    if half:
        u2_spin = o2_orb // n_orb
        bit = orb_row + u2_spin[:, None] * n_orb
        occupied = dets_read(occ_bits, bit, 2 * n_orb)
        w = jnp.where(occupied, 0.0, w)
        w = jnp.where(same_spin[:, None] & (orb_row >= u1_sp[:, None]), 0.0, w)
    norm = jnp.sum(w, axis=-1, keepdims=True)
    frac = norm[..., 0] / jnp.maximum(
        kernels.take_small(tens.exch_norms, o2_sp), 1e-300
    )
    return w / jnp.maximum(norm, 1e-300), frac, orb_row


def dets_read(occ_bits, pos, n_bits):
    """Read bit ``pos`` from unpacked occupancy bits (B, n_bits); positions
    broadcast (B, K)."""
    pos = jnp.clip(pos, 0, n_bits - 1)
    return kernels.take_along_small(
        occ_bits[..., None, :], pos
    ).astype(jnp.bool_)


# ---------------------------------------------------------------------------
# total selection weights
# ---------------------------------------------------------------------------

def unnorm_weight(tens: HeatBathTensors, n_orb, o1, o2, u1, u2):
    """calc_unnorm_wt (heat_bathPP.cpp:414-439), batched.  Orbitals are spin
    orbitals with o1 < o2 (and u1 < u2 for same spin)."""
    same = (o1 // n_orb) == (o2 // n_orb)
    o1s, o2s, u1s, u2s = o1 % n_orb, o2 % n_orb, u1 % n_orb, u2 % n_orb
    rows1 = kernels.take_rows_small(tens.exch_sqrt, o1s)
    rows2 = kernels.take_rows_small(tens.exch_sqrt, o2s)
    ex_o1u1 = kernels.take_along_small(rows1, u1s)
    ex_o2u2 = kernels.take_along_small(rows2, u2s)
    d_s = kernels.take2_small(tens.d_same, o1s, o2s)
    d_d = kernels.take2_small(tens.d_diff, o2s, o1s)
    base = jnp.where(same, d_s, d_d)
    return (
        base
        * ex_o1u1
        * ex_o2u2
        / tens.s_norm
        / kernels.take_small(tens.exch_norms, o1s)
        / kernels.take_small(tens.exch_norms, o2s)
    )


def norm_weight(tens: HeatBathTensors, n_orb, n_elec, symm, lookup,
                occ, occ_bits, o1, o2, u1, u2):
    """calc_norm_wt (heat_bathPP.cpp:442-598), batched: total probability of
    selecting excitation (o1,o2)->(u1,u2) under the normalized HB-PP
    factorization, summed over both selection orders.

    Batched formulation: the per-sample sums over virtual / symmetry-row
    orbitals collapse to O(1) gathers against precomputed row sums
    (exch_norms, per-irrep exch row sums) minus the occupied/excluded
    corrections - no (B, n_orb) masked reductions."""
    half = n_elec // 2
    o1s, o2s, u1s, u2s = o1 % n_orb, o2 % n_orb, u1 % n_orb, u2 % n_orb
    o1_spin, o2_spin = o1 // n_orb, o2 // n_orb
    same = o1_spin == o2_spin

    # occupancy indicator vectors straight from the unpacked bits: the
    # per-electron sums over the occupied list become (B, n_orb) dots
    n_alpha = occ_bits[:, :n_orb].astype(jnp.float64)
    n_beta = occ_bits[:, n_orb : 2 * n_orb].astype(jnp.float64)
    n_tot = n_alpha + n_beta

    s_denom = jnp.sum(tens.s_tens * n_tot, axis=-1)

    # ONE wide one-hot matmul per occupied orbital instead of many narrow
    # ones: rows of [d_same | d_diff | exch_sqrt | symm_sums | s_tens |
    # exch_norms] fetched together; every o1s/o2s-indexed quantity below is
    # an in-row select from these two row sets (no further row matmuls)
    irrep_onehot = (symm[:, None] == jnp.arange(8)[None, :]).astype(jnp.float64)
    symm_sums = tens.exch_sqrt @ irrep_onehot  # (n_orb, 8) exch row sums
    cat = jnp.concatenate(
        [
            tens.d_same, tens.d_diff, tens.exch_sqrt, symm_sums,
            tens.s_tens[:, None], tens.exch_norms[:, None],
        ],
        axis=1,
    )
    cat1 = kernels.take_rows_small(cat, o1s)
    cat2 = kernels.take_rows_small(cat, o2s)
    rows_ds1 = cat1[:, :n_orb]
    rows_dd1 = cat1[:, n_orb : 2 * n_orb]
    rows_o1 = cat1[:, 2 * n_orb : 3 * n_orb]
    ss_o1 = cat1[:, 3 * n_orb : 3 * n_orb + 8]
    s_tens_o1 = cat1[:, 3 * n_orb + 8]
    exch_norms_o1 = cat1[:, 3 * n_orb + 9]
    rows_ds2 = cat2[:, :n_orb]
    rows_dd2 = cat2[:, n_orb : 2 * n_orb]
    rows_o2 = cat2[:, 2 * n_orb : 3 * n_orb]
    ss_o2 = cat2[:, 3 * n_orb : 3 * n_orb + 8]
    s_tens_o2 = cat2[:, 3 * n_orb + 8]
    exch_norms_o2 = cat2[:, 3 * n_orb + 9]

    n_same1 = jnp.where((o1_spin == 0)[:, None], n_alpha, n_beta)
    n_diff1 = jnp.where((o1_spin == 0)[:, None], n_beta, n_alpha)
    n_same2 = jnp.where((o2_spin == 0)[:, None], n_alpha, n_beta)
    n_diff2 = jnp.where((o2_spin == 0)[:, None], n_beta, n_alpha)

    d1_denom = jnp.sum(rows_ds1 * n_same1 + rows_dd1 * n_diff1, axis=-1)
    d2_denom = jnp.sum(rows_ds2 * n_same2 + rows_dd2 * n_diff2, axis=-1)
    e1_virt = exch_norms_o1 - jnp.sum(rows_o1 * n_same1, axis=-1)
    e2_virt = exch_norms_o2 - jnp.sum(rows_o2 * n_same2, axis=-1)

    u1_irrep = kernels.take_small(symm, u1s)
    u2_irrep = kernels.take_small(symm, u2s)

    exo1u1 = kernels.take_along_small(rows_o1, u1s)
    exo1u2 = kernels.take_along_small(rows_o1, u2s)
    exo2u1 = kernels.take_along_small(rows_o2, u1s)
    exo2u2 = kernels.take_along_small(rows_o2, u2s)

    # e_symm terms: the irrep row sums come from the shared cat rows and the
    # same-irrep exclusion corrections are exactly the exch entries above
    excl_u1 = same & (u1_irrep == u2_irrep)  # symm[u1] == g(u2) etc.
    excl_u2 = same & (u2_irrep == u1_irrep)
    e2_symm_no1 = kernels.take_along_small(ss_o2, u2_irrep) - jnp.where(
        excl_u1, exo2u1, 0.0
    )
    e1_symm_no1 = kernels.take_along_small(ss_o1, u2_irrep) - jnp.where(
        excl_u1, exo1u1, 0.0
    )
    e2_symm_no2 = kernels.take_along_small(ss_o2, u1_irrep) - jnp.where(
        excl_u2, exo2u2, 0.0
    )
    e1_symm_no2 = kernels.take_along_small(ss_o1, u1_irrep) - jnp.where(
        excl_u2, exo1u2, 0.0
    )

    def safe_div(a, b):
        return a / jnp.where(b == 0, 1.0, b) * (b != 0)

    d_same_12 = kernels.take_along_small(rows_ds1, o2s)
    d_diff_12 = kernels.take_along_small(rows_dd1, o2s)
    d_diff_21 = kernels.take_along_small(rows_dd2, o1s)
    w_same = d_same_12 / s_denom * (
        safe_div(s_tens_o1, d1_denom * e1_virt)
        * (safe_div(exo1u1 * exo2u2, e2_symm_no1) + safe_div(exo1u2 * exo2u1, e2_symm_no2))
        + safe_div(s_tens_o2, d2_denom * e2_virt)
        * (safe_div(exo2u1 * exo1u2, e1_symm_no1) + safe_div(exo2u2 * exo1u1, e1_symm_no2))
    )
    w_diff = (
        safe_div(s_tens_o1 * d_diff_12, d1_denom * e1_virt * e2_symm_no1)
        + safe_div(s_tens_o2 * d_diff_21, d2_denom * e2_virt * e1_symm_no2)
    ) * exo1u1 * exo2u2 / s_denom
    return jnp.where(same, w_same, w_diff)


# ---------------------------------------------------------------------------
# symmetry-allowed singles counting (near-uniform machinery,
# near_uniform.cpp:14-28, 316-347)
# ---------------------------------------------------------------------------

def unocc_symm_counts(n_orb, n_elec, symm, symm_counts, occ):
    """(B, 8, 2) number of unoccupied orbitals per (irrep, spin)
    (count_symm_virt, near_uniform.cpp:14-28)."""
    half = n_elec // 2
    occ_sp = occ % n_orb
    irreps = kernels.take_small(symm, occ_sp)  # (B, E)
    spin = (jnp.arange(n_elec) >= half).astype(jnp.int32)[None, :]
    # occupancy histogram per (irrep, spin) by fused compare-reduce instead
    # of a scalar scatter (B, 8, 2, E)
    hit = (
        (irreps[:, None, None, :]
         == jnp.arange(8, dtype=jnp.int32)[None, :, None, None])
        & (spin[:, None, None, :]
           == jnp.arange(2, dtype=jnp.int32)[None, None, :, None])
    )
    occ_counts = jnp.sum(hit, axis=-1, dtype=jnp.int32)
    return symm_counts[None, :, None].astype(jnp.int32) - occ_counts


def sing_allowed(n_orb, n_elec, symm, counts, occ):
    """Per-electron count of symmetry-allowed single-excitation targets, and
    the number of electrons with any (count_sing_allowed / count_sing_virt,
    near_uniform.cpp:316-347)."""
    half = n_elec // 2
    irreps = kernels.take_small(symm, occ % n_orb)
    spin = (jnp.arange(n_elec) >= half).astype(jnp.int32)[None, :]
    flat = counts.reshape(counts.shape[0], 16)  # (B, 8*2)
    key16 = irreps * 2 + spin
    per_elec = kernels.take_along_small(flat[:, None, :], key16).astype(jnp.int32)
    n_allowed = jnp.sum(per_elec > 0, axis=-1)
    return per_elec, n_allowed
