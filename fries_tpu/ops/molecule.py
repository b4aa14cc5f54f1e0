"""Molecular (ab initio) Hamiltonian: Slater-Condon matrix elements and
symmetry-resolved excitation enumeration, fully batched.

Re-designs FRIES/Hamiltonians/molecule.{hpp,cpp} for batched arrays:

* ERIs are a dense physicist-notation tensor ``<pq|rs>`` (the reference's
  8-fold-packed SymmERIs, ndarr.hpp:206-244, trades memory for scalar access;
  a dense array serves vectorized gathers - 46 orbitals is 36 MB).
* Matrix elements (doub_matr_el_nosgn molecule.cpp:8-42, sing_matr_el_nosgn
  :45-105, diag_matrel :935-1029) are evaluated for whole batches of
  excitations with gather + masked-reduction kernels.
* Excitation enumeration (doub_ex_symm :108-175, sing_ex_symm :178-203)
  becomes a static candidate template (numpy, built once per system) plus a
  batched validity mask - no per-determinant loops.

Orbital conventions follow the reference: ``n_orb`` unfrozen *spatial*
orbitals; spin orbitals 0..n_orb-1 are alpha, n_orb..2n_orb-1 beta; occupied
lists hold n_elec/2 ascending alpha then n_elec/2 ascending beta spin
orbitals.  Frozen-core spatial orbitals occupy the first n_frozen/2 rows of
``hcore``/``eris`` and are excluded from the active bit string.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from functools import partial

import numpy as np
import jax
import jax.numpy as jnp

from fries_tpu import dets, kernels

N_IRREPS = 8  # <= 8 abelian irreps, XOR product table (molecule.hpp:14)


@partial(
    jax.tree_util.register_dataclass,
    data_fields=("hcore", "eris", "symm"),
    meta_fields=("n_orb", "n_elec", "n_frozen"),
)
@dataclass(frozen=True)
class MolecularHamiltonian:
    """Integrals + system sizes.

    Attributes:
      hcore: (T, T) one-electron integrals, T = n_orb + n_frozen/2.
      eris:  (T, T, T, T) two-electron integrals, physicist notation <pq|rs>.
      symm:  (n_orb,) int32 irrep labels of the unfrozen spatial orbitals.
      n_orb: unfrozen spatial orbitals.
      n_elec: unfrozen electrons.
      n_frozen: frozen electrons (n_frozen/2 frozen spatial orbitals).
    """

    hcore: jax.Array
    eris: jax.Array
    symm: jax.Array
    n_orb: int
    n_elec: int
    n_frozen: int = 0

    @property
    def tot_orb(self) -> int:
        return self.n_orb + self.n_frozen // 2

    @property
    def n_bits(self) -> int:
        return 2 * self.n_orb

    @property
    def n_words(self) -> int:
        return dets.n_words(self.n_bits)


# ---------------------------------------------------------------------------
# matrix elements
# ---------------------------------------------------------------------------

def _spatial(ham: MolecularHamiltonian, spin_orb):
    """Unfrozen spin orbital -> total spatial index (with frozen offset)."""
    return spin_orb % ham.n_orb + ham.n_frozen // 2


def _spin(ham: MolecularHamiltonian, spin_orb):
    return spin_orb // ham.n_orb


@jax.jit
def doub_matr_el(ham: MolecularHamiltonian, o1, o2, u1, u2):
    """Sign-free double-excitation element <o1 o2||u1 u2> (batched).

    Mirrors doub_matr_el_nosgn (molecule.cpp:8-42): Coulomb minus exchange
    when both electrons share a spin.
    """
    same_sp = _spin(ham, o1) == _spin(ham, o2)
    s0, s1 = _spatial(ham, o1), _spatial(ham, o2)
    s2, s3 = _spatial(ham, u1), _spatial(ham, u2)
    # one flat 1-D gather for Coulomb AND exchange: a single gather pass of
    # 2B elements instead of two 4-operand gathers
    t = ham.tot_orb
    base = (s0.astype(jnp.int32) * t + s1) * t
    idx = jnp.stack([(base + s2) * t + s3, (base + s3) * t + s2])
    g = ham.eris.reshape(-1)[idx]
    return g[0] - jnp.where(same_sp, g[1], 0.0)


def _sing_tables(ham: MolecularHamiltonian):
    """coul3[p,r,q] = <p q|r q>, exch3[p,r,q] = <p q|q r>: the only ERI
    slices single-excitation elements need.  Extracting them per call is a
    cheap diagonal gather that XLA hoists, instead of random 4-index gathers
    into the full ERI tensor."""
    coul3 = jnp.einsum("pqrq->prq", ham.eris)
    exch3 = jnp.einsum("pqqr->prq", ham.eris)
    return coul3, exch3


@jax.jit
def sing_matr_el(ham: MolecularHamiltonian, o, u, occ):
    """Sign-free single-excitation element (batched over leading dims).

    Mirrors sing_matr_el_nosgn (molecule.cpp:45-105), reformulated for batches:
    the Coulomb/exchange sums over occupied orbitals become dot products of
    per-sample occupancy vectors with rows of the (T,T,T) coul3/exch3 slices
    (one small row gather per sample instead of O(E) random 4-index gathers).

    Args:
      o, u: (...,) occupied / virtual spin orbitals (same spin).
      occ:  (..., E) occupied spin-orbital lists.
    """
    t = ham.tot_orb
    half_frz = ham.n_frozen // 2
    coul3, exch3 = _sing_tables(ham)
    so = _spatial(ham, o)
    su = _spatial(ham, u)
    spin_o = _spin(ham, o)
    occ_spa = _spatial(ham, occ)
    same_spin = _spin(ham, occ) == spin_o[..., None]

    if o.ndim == 1:
        # sampled-excitation path: one-hot-matmul the (so, su) row out of the
        # (T*T, T) slab, then dot with occupancy indicator vectors - no
        # take_along_axis (scalar-gather path) anywhere
        mel = kernels.take2_small(ham.hcore, so, su)
        onehot = occ_spa[..., None] == jnp.arange(t, dtype=jnp.int32)
        n_all = jnp.sum(onehot, axis=-2).astype(jnp.float64)
        n_same = jnp.sum(
            jnp.where(same_spin[..., None], onehot, False), axis=-2
        ).astype(jnp.float64)
        c = so * t + su
        coul_row = kernels.take_rows_small(coul3.reshape(t * t, t), c)
        exch_row = kernels.take_rows_small(exch3.reshape(t * t, t), c)
        mel = mel + jnp.sum(coul_row * n_all, axis=-1)
        mel = mel - jnp.sum(exch_row * n_same, axis=-1)
    else:
        # enumeration path (exact H application): (B, NS) candidates share
        # occ rows; the one-hot-matmul row select would materialize
        # (B, NS, T*T), so keep per-row take_along selection here
        shape = jnp.broadcast_shapes(occ_spa.shape, same_spin.shape)
        occ_b = jnp.broadcast_to(occ_spa, shape)
        mel = ham.hcore[so, su]
        coul_row = coul3[so, su]          # (..., T)
        exch_row = exch3[so, su]
        coul_sel = jnp.take_along_axis(
            jnp.broadcast_to(coul_row, shape[:-1] + (t,)), occ_b, axis=-1
        )
        exch_sel = jnp.take_along_axis(
            jnp.broadcast_to(exch_row, shape[:-1] + (t,)), occ_b, axis=-1
        )
        mel = mel + jnp.sum(coul_sel, axis=-1)
        mel = mel - jnp.sum(jnp.where(same_spin, exch_sel, 0.0), axis=-1)
    if half_frz:
        mel = mel + 2 * jnp.sum(coul_row[..., :half_frz], axis=-1)
        mel = mel - jnp.sum(exch_row[..., :half_frz], axis=-1)
    return mel


def _scatter_counts(idx, weights, t):
    """(..., E) indices + weights -> (..., T) occupancy counts.

    One-hot compare + reduce instead of scatter-add: XLA fuses the compare,
    multiply, and reduction into one pass."""
    onehot = idx[..., :, None] == jnp.arange(t, dtype=idx.dtype)
    return jnp.sum(jnp.where(onehot, weights[..., :, None], 0.0), axis=-2)


@jax.jit
def diag_matrel(ham: MolecularHamiltonian, occ):
    """Diagonal element <det|H|det> (batched over leading dims of ``occ``).

    Mirrors diag_matrel (molecule.cpp:935-1029) reformulated for batches: the
    pairwise Coulomb/exchange sums become occupancy-vector quadratic forms

        sum_{j<k} C[s_j, s_k]          = (n^T C n - sum_p n_p C_pp) / 2
        sum_{same-spin j<k} X[s_j,s_k] = (a^T X a - a.X_diag)/2 + (b ...)

    over the (T,T) slices C[p,q] = <pq|pq>, X[p,q] = <pq|qp> - batched
    matmuls instead of O(E^2) random 4-index ERI gathers.
    """
    t = ham.tot_orb
    half_frz = ham.n_frozen // 2
    coul2 = jnp.einsum("pqpq->pq", ham.eris)
    exch2 = jnp.einsum("pqqp->pq", ham.eris)

    spa = _spatial(ham, occ)
    spin = _spin(ham, occ)
    a_vec = _scatter_counts(spa, jnp.where(spin == 0, 1.0, 0.0), t)
    b_vec = _scatter_counts(spa, jnp.where(spin == 1, 1.0, 0.0), t)
    n_vec = a_vec + b_vec

    h_diag = jnp.diagonal(ham.hcore)
    c_diag = jnp.diagonal(coul2)
    x_diag = jnp.diagonal(exch2)

    # occupancy-vector contractions: the (.., T) @ (T, T) products as f64
    # matmuls and the (.., T) @ (T,) products plain elementwise f64 sums
    total = jnp.sum(n_vec * h_diag, axis=-1)
    nc = kernels.count_matmul_f64(n_vec, coul2)
    total = total + 0.5 * (
        jnp.sum(nc * n_vec, axis=-1) - jnp.sum(n_vec * c_diag, axis=-1)
    )
    ax = kernels.count_matmul_f64(a_vec, exch2)
    bx = kernels.count_matmul_f64(b_vec, exch2)
    total = total - 0.5 * (
        jnp.sum(ax * a_vec, axis=-1) - jnp.sum(a_vec * x_diag, axis=-1)
        + jnp.sum(bx * b_vec, axis=-1) - jnp.sum(b_vec * x_diag, axis=-1)
    )

    if half_frz:
        j = np.arange(half_frz)
        core = 2 * jnp.sum(ham.hcore[j, j]) + jnp.sum(jnp.diagonal(coul2)[j])
        jj, kk = jnp.meshgrid(j, j, indexing="ij")
        mask = kk > jj
        core = core + jnp.sum(
            jnp.where(mask, 4 * coul2[jj, kk] - 2 * exch2[jj, kk], 0.0)
        )
        # frozen-active interaction: sum_p n_p sum_f (2 C[p,f] - X[p,f])
        fa = jnp.sum(2 * coul2[:, :half_frz] - exch2[:, :half_frz], axis=1)
        total = total + core + jnp.sum(n_vec * fa, axis=-1)
    return total


def hf_reference(ham: MolecularHamiltonian):
    """(hf_det_words, hf_occ, hf_energy) of the aufbau HF determinant."""
    words = dets.hf_det(ham.n_orb, ham.n_elec)
    occ = dets.occ_list(words[None], ham.n_bits, ham.n_elec)[0]
    energy = diag_matrel(ham, occ[None])[0]
    return words, occ, energy


# ---------------------------------------------------------------------------
# symmetry tables (reference SymmInfo, molecule.hpp:265-280, gen_symm_lookup
# molecule.cpp:1050-1065)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class SymmInfo:
    """Irrep labels and per-irrep orbital lists (host-side numpy).

    lookup[g] lists the spatial orbitals of irrep g; counts[g] their number;
    the dense (N_IRREPS, max_count) array is gather-friendly on device.
    """

    symm: np.ndarray            # (n_orb,)
    counts: np.ndarray          # (N_IRREPS,)
    lookup: np.ndarray          # (N_IRREPS, max_count) padded with n_orb
    max_count: int

    @staticmethod
    def build(symm) -> "SymmInfo":
        symm = np.asarray(symm, dtype=np.int32)
        n_orb = symm.shape[0]
        counts = np.zeros(N_IRREPS, np.int32)
        rows = []
        for g in range(N_IRREPS):
            orbs = np.where(symm == g)[0]
            counts[g] = len(orbs)
            rows.append(orbs)
        max_count = max(1, int(counts.max()))
        lookup = np.full((N_IRREPS, max_count), n_orb, np.int32)
        for g in range(N_IRREPS):
            lookup[g, : counts[g]] = rows[g]
        return SymmInfo(symm, counts, lookup, max_count)


# ---------------------------------------------------------------------------
# static excitation templates (replaces doub_ex_symm / sing_ex_symm loops)
# ---------------------------------------------------------------------------

@partial(
    jax.tree_util.register_dataclass,
    data_fields=("d_e1", "d_e2", "d_t1", "d_t2", "s_e", "s_t"),
    meta_fields=(),
)
@dataclass(frozen=True)
class ExcitationTemplate:
    """Static per-system candidate excitations, masked per determinant.

    Doubles enumerate (electron-slot pair) x (spatial target pair) for the
    three spin cases; singles enumerate (electron slot) x (spatial target).
    Bounds match count_doub_nosymm (molecule.cpp:888-892).
    """

    # doubles
    d_e1: np.ndarray  # (ND,) electron slot of first occupied
    d_e2: np.ndarray  # (ND,)
    d_t1: np.ndarray  # (ND,) spatial target for electron 1 (same spin)
    d_t2: np.ndarray  # (ND,)
    # singles
    s_e: np.ndarray  # (NS,)
    s_t: np.ndarray  # (NS,)

    @property
    def n_doub(self) -> int:
        return len(self.d_e1)

    @property
    def n_sing(self) -> int:
        return len(self.s_e)

    @staticmethod
    def build(n_orb: int, n_elec: int) -> "ExcitationTemplate":
        half = n_elec // 2
        d_e1, d_e2, d_t1, d_t2 = [], [], [], []
        # alpha-beta
        for e1 in range(half):
            for e2 in range(half, n_elec):
                for t1 in range(n_orb):
                    for t2 in range(n_orb):
                        d_e1.append(e1)
                        d_e2.append(e2)
                        d_t1.append(t1)
                        d_t2.append(t2)
        # same spin (alpha then beta)
        for base in (0, half):
            for e1 in range(base, base + half):
                for e2 in range(e1 + 1, base + half):
                    for t1 in range(n_orb):
                        for t2 in range(t1 + 1, n_orb):
                            d_e1.append(e1)
                            d_e2.append(e2)
                            d_t1.append(t1)
                            d_t2.append(t2)
        s_e, s_t = [], []
        for e in range(n_elec):
            for t in range(n_orb):
                s_e.append(e)
                s_t.append(t)
        return ExcitationTemplate(
            np.asarray(d_e1, np.int32),
            np.asarray(d_e2, np.int32),
            np.asarray(d_t1, np.int32),
            np.asarray(d_t2, np.int32),
            np.asarray(s_e, np.int32),
            np.asarray(s_t, np.int32),
        )


def enumerate_doubles(ham: MolecularHamiltonian, tmpl: ExcitationTemplate,
                      det_words, occ):
    """All symmetry-allowed double excitations of a batch of determinants.

    Returns (o1, o2, u1, u2, valid) each (B, ND); orbital ordering matches
    doub_ex_symm (molecule.cpp:108-175): o1 < o2, and for the alpha-beta case
    u1 alpha / u2 beta, same-spin case u1 < u2.
    """
    n_orb = ham.n_orb
    half = ham.n_elec // 2
    e1 = jnp.asarray(tmpl.d_e1)
    e2 = jnp.asarray(tmpl.d_e2)
    spin1 = (e1 >= half).astype(jnp.int32)
    spin2 = (e2 >= half).astype(jnp.int32)
    o1 = occ[:, e1]
    o2 = occ[:, e2]
    u1 = jnp.asarray(tmpl.d_t1) + spin1 * n_orb
    u2 = jnp.asarray(tmpl.d_t2) + spin2 * n_orb
    u1 = jnp.broadcast_to(u1, o1.shape)
    u2 = jnp.broadcast_to(u2, o2.shape)
    unocc = ~dets.read_bit(det_words[:, None, :], u1) & ~dets.read_bit(
        det_words[:, None, :], u2
    )
    symm = ham.symm
    allowed = (
        symm[o1 % n_orb] ^ symm[o2 % n_orb] ^ symm[u1 % n_orb] ^ symm[u2 % n_orb]
    ) == 0
    return o1, o2, u1, u2, unocc & allowed


def enumerate_singles(ham: MolecularHamiltonian, tmpl: ExcitationTemplate,
                      det_words, occ):
    """All symmetry-allowed single excitations (B, NS) + validity mask."""
    n_orb = ham.n_orb
    half = ham.n_elec // 2
    e = jnp.asarray(tmpl.s_e)
    spin = (e >= half).astype(jnp.int32)
    o = occ[:, e]
    u = jnp.broadcast_to(jnp.asarray(tmpl.s_t) + spin * n_orb, o.shape)
    unocc = ~dets.read_bit(det_words[:, None, :], u)
    allowed = ham.symm[o % n_orb] == ham.symm[u % n_orb]
    return o, u, unocc & allowed


@jax.jit
def exact_offdiag_batch(ham: MolecularHamiltonian, tmpl: ExcitationTemplate,
                        det_words, occ, vals, h_fac):
    """Exact H_offdiag action for a batch of source determinants.

    The batched analogue of h_op_offdiag (molecule.cpp:448-665): instead of
    streaming per-determinant enumeration loops through an Adder with flow
    control, all candidates are materialized as a (B, ND+NS) masked batch of
    (new_det, value) spawns ready for arena accumulation.

    Returns (new_words (B, NC, W), amps (B, NC), new_occ (B, NC, E)) where
    masked-out candidates have zero amplitude and sentinel keys.
    """
    b = det_words.shape[0]
    o1, o2, u1, u2, dmask = enumerate_doubles(ham, tmpl, det_words, occ)
    so, su, smask = enumerate_singles(ham, tmpl, det_words, occ)

    dmel = doub_matr_el(ham, o1, o2, u1, u2)
    dnew, dsign = dets.double_parity(det_words[:, None, :], o1, o2, u1, u2)
    damp = jnp.where(dmask, dmel * dsign * vals[:, None] * h_fac, 0.0)

    smel = sing_matr_el(ham, so, su, occ[:, None, :])
    snew, ssign = dets.single_parity(det_words[:, None, :], so, su)
    samp = jnp.where(smask, smel * ssign * vals[:, None] * h_fac, 0.0)

    new_words = jnp.concatenate([dnew, snew], axis=1)
    amps = jnp.concatenate([damp, samp], axis=1)
    masks = jnp.concatenate([dmask, smask], axis=1)

    # occupied lists of the spawned determinants (recomputed; cheap relative
    # to the matrix elements and keeps the spawner self-contained)
    new_occ = dets.occ_list(new_words, ham.n_bits, ham.n_elec)
    sentinel = jnp.asarray(dets.invalid_det(ham.n_words))
    new_words = jnp.where(masks[..., None], new_words, sentinel)
    return new_words, amps, new_occ


def diag_matrel_chunked(ham: MolecularHamiltonian, occ, chunk: int = 65536):
    """diag_matrel evaluated in fixed-size chunks via lax.map.

    The batched diagonal builds O(B * E^2) gather intermediates; for
    million-row spawn batches that is multiple GB of device temps, so the hot
    drivers evaluate it chunkwise.
    """
    b = occ.shape[0]
    if b <= chunk:
        return diag_matrel(ham, occ)
    n_chunks = -(-b // chunk)
    pad = n_chunks * chunk - b
    occ_p = jnp.concatenate([occ, jnp.zeros((pad, occ.shape[1]), occ.dtype)])
    out = jax.lax.map(
        lambda o: diag_matrel(ham, o), occ_p.reshape(n_chunks, chunk, -1)
    )
    return out.reshape(-1)[:b]
