"""Hubbard-Holstein lattice model in the site basis, batched.

Re-designs FRIES/Hamiltonians/hub_holstein.{hpp,cpp} and FRIES/hh_vec.hpp:

* State layout (hh_vec.hpp:27): bits 0..n-1 spin-up site occupation, bits
  n..2n-1 spin-down, then ``ph_bits`` phonon-counter bits per site starting at
  bit 2n.  1-D open boundary conditions.
* Hopping excitations (hub_multin / hub_all, hub_holstein.cpp:10-98) become a
  static candidate grid (spin x bond x direction) with an occupancy mask - no
  per-determinant neighbor lists.  Nearest-neighbor hops in this layout never
  cross another same-spin orbital, so the fermionic sign is always +1 (the
  reference likewise applies no parity for the lattice model).
* The diagonal is U * (number of doubly occupied sites) + omega * total
  phonons (hub_diag, hub_holstein.cpp:101-136; frifull_hh.cpp:260-268).
* The reference-overlap energy estimator (calc_ref_ovlp,
  hub_holstein.hpp:94-182) is re-expressed as a *static connected set*: all
  determinants coupled to the phonon-free reference state (the reference det
  itself, its single hops, and its one-phonon satellites) with their matrix
  elements precomputed; the estimator is then one arena dot product.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial

import numpy as np
import jax
import jax.numpy as jnp

from fries_tpu import dets


@partial(
    jax.tree_util.register_dataclass,
    data_fields=(),
    meta_fields=("n_sites", "n_elec", "ph_bits", "u", "omega", "g", "t"),
)
@dataclass(frozen=True)
class HubbardHolstein:
    n_sites: int
    n_elec: int
    ph_bits: int = 0
    u: float = 0.0
    omega: float = 0.0
    g: float = 0.0
    t: float = 1.0

    @property
    def n_bits(self) -> int:
        return 2 * self.n_sites + self.ph_bits * self.n_sites

    @property
    def n_words(self) -> int:
        return dets.n_words(self.n_bits)

    @property
    def max_ph(self) -> int:
        return (1 << self.ph_bits) - 1 if self.ph_bits else 0


# ---------------------------------------------------------------------------
# phonon bit-field helpers (reference HubHolVec::det_from_ph, hh_vec.hpp:207-233)
# ---------------------------------------------------------------------------

def phonon_nums(ham: HubbardHolstein, words: jax.Array) -> jax.Array:
    """Decode per-site phonon occupation numbers: (..., W) -> (..., n_sites)."""
    if ham.ph_bits == 0:
        return jnp.zeros(words.shape[:-1] + (ham.n_sites,), jnp.int32)
    bits = dets.unpack_bits(words, ham.n_bits)
    ph = bits[..., 2 * ham.n_sites :].astype(jnp.int32)
    ph = ph.reshape(ph.shape[:-1] + (ham.n_sites, ham.ph_bits))
    weights = (1 << np.arange(ham.ph_bits)).astype(np.int32)
    return jnp.sum(ph * weights, axis=-1)


def with_phonon(ham: HubbardHolstein, words: jax.Array, site, new_num) -> jax.Array:
    """Set site's phonon counter to ``new_num`` (batched; site/new_num arrays)."""
    bits = dets.unpack_bits(words, ham.n_bits)
    pos0 = 2 * ham.n_sites + site * ham.ph_bits
    for b in range(ham.ph_bits):
        bit_val = ((new_num >> b) & 1).astype(bits.dtype)
        idx = pos0 + b
        onehot = (
            jnp.arange(ham.n_bits) == idx[..., None]
        )
        bits = jnp.where(onehot, bit_val[..., None], bits)
    return dets.pack_bits(bits, words.shape[-1])


# ---------------------------------------------------------------------------
# diagonal
# ---------------------------------------------------------------------------

@jax.jit
def diag_matrel(ham: HubbardHolstein, words: jax.Array) -> jax.Array:
    """U * n_doubly_occupied + omega * n_phonons (absolute, unshifted)."""
    bits = dets.unpack_bits(words, ham.n_bits)
    up = bits[..., : ham.n_sites]
    down = bits[..., ham.n_sites : 2 * ham.n_sites]
    n_doub = jnp.sum(up & down, axis=-1).astype(jnp.float64)
    ph = jnp.sum(phonon_nums(ham, words), axis=-1).astype(jnp.float64)
    return ham.u * n_doub + ham.omega * ph


# ---------------------------------------------------------------------------
# spawning: all off-diagonal H terms as a static masked candidate grid
# ---------------------------------------------------------------------------

@jax.jit
def offdiag_batch(ham: HubbardHolstein, words: jax.Array, vals: jax.Array,
                  h_fac):
    """All off-diagonal spawns for a batch of determinants.

    Candidates per determinant (static count NC):
      * hops: spin (2) x bond (n_sites-1) x direction (2); amplitude
        h_fac * (-t) * v (hub_all semantics, frifull_hh.cpp:207-215 spawn
        eps*t*v = -eps*(-t)*v).
      * phonon raise/lower per site (2 * n_sites when ph_bits > 0); amplitude
        h_fac * g * sqrt(ph or ph+1) * n_elec(site) * v
        (frifull_hh.cpp:219-250).

    Returns (new_words (B, NC, W), amps (B, NC)); masked-out slots carry the
    sentinel key and zero amplitude.
    """
    n = ham.n_sites
    b = words.shape[0]
    bits = dets.unpack_bits(words, ham.n_bits)
    up = bits[..., :n]
    down = bits[..., n : 2 * n]

    out_words = []
    out_amps = []

    # ---- hops ----
    # static candidate list: (spin, from, to) over adjacent bonds
    froms, tos, spins = [], [], []
    for s in range(2):
        for i in range(n - 1):
            froms += [i, i + 1]
            tos += [i + 1, i]
            spins += [s, s]
    froms = np.asarray(froms, np.int32)
    tos = np.asarray(tos, np.int32)
    spins = np.asarray(spins, np.int32)
    from_bit = froms + spins * n
    to_bit = tos + spins * n

    occ_from = dets.read_bit(words[:, None, :], jnp.asarray(from_bit))
    empty_to = ~dets.read_bit(words[:, None, :], jnp.asarray(to_bit))
    hop_mask = occ_from & empty_to
    hop_words = dets.set_bit(
        dets.clear_bit(words[:, None, :], jnp.asarray(from_bit)),
        jnp.asarray(to_bit),
    )
    hop_amp = jnp.where(hop_mask, h_fac * (-ham.t) * vals[:, None], 0.0)
    out_words.append(hop_words)
    out_amps.append(hop_amp)

    # ---- phonon raise/lower ----
    if ham.ph_bits:
        ph = phonon_nums(ham, words)  # (B, n)
        n_at_site = up.astype(jnp.int32) + down.astype(jnp.int32)  # (B, n)
        site_idx = jnp.arange(n, dtype=jnp.int32)

        for direction in (-1, +1):
            new_num = ph + direction
            ok = (new_num >= 0) & (new_num <= ham.max_ph) & (n_at_site > 0)
            sqrt_fac = jnp.sqrt(
                jnp.where(direction < 0, ph, ph + 1).astype(jnp.float64)
            )
            amp = jnp.where(
                ok,
                h_fac * ham.g * sqrt_fac * n_at_site * vals[:, None],
                0.0,
            )
            nw = with_phonon(
                ham,
                words[:, None, :],
                jnp.broadcast_to(site_idx, (b, n)),
                jnp.clip(new_num, 0, ham.max_ph),
            )
            out_words.append(nw)
            out_amps.append(amp)

    new_words = jnp.concatenate(out_words, axis=1)
    amps = jnp.concatenate(out_amps, axis=1)
    sentinel = jnp.asarray(dets.invalid_det(ham.n_words))
    new_words = jnp.where((amps != 0)[..., None], new_words, sentinel)
    return new_words, amps


def n_candidates(ham: HubbardHolstein) -> int:
    nc = 4 * (ham.n_sites - 1)
    if ham.ph_bits:
        nc += 2 * ham.n_sites
    return nc


# ---------------------------------------------------------------------------
# electron occupation lists (for the arena occ cache)
# ---------------------------------------------------------------------------

def occ_list(ham: HubbardHolstein, words: jax.Array) -> jax.Array:
    """Occupied electron spin-orbitals (phonon bits excluded)."""
    bits = dets.unpack_bits(words, ham.n_bits)[..., : 2 * ham.n_sites]
    return dets.occ_list_from_bits(bits, ham.n_elec)


# ---------------------------------------------------------------------------
# reference-overlap energy estimator as a static connected set
# ---------------------------------------------------------------------------

def reference_connections(ham: HubbardHolstein, ref_words: np.ndarray,
                          e_ref: float):
    """(conn_keys, conn_mels) with <ref|(H - e_ref)|det> for every determinant
    coupled to the phonon-free reference state.

    Replaces the full-vector scan of calc_ref_ovlp (hub_holstein.hpp:94-182)
    with one precomputed sparse row of H; the estimator numerator is then a
    single arena dot product and the denominator is the reference amplitude.
    """
    n = ham.n_sites
    ref_words = np.asarray(ref_words)
    ref_bits = np.asarray(dets.unpack_bits(jnp.asarray(ref_words)[None], ham.n_bits))[0]
    up = ref_bits[:n]
    down = ref_bits[n : 2 * n]

    keys = [ref_words]
    mels = [ham.u * float(np.sum(up & down)) - e_ref]

    def words_of(bits):
        return np.asarray(dets.pack_bits(jnp.asarray(bits[None]), ham.n_words))[0]

    # single hops (H element -t)
    for s, row in ((0, up), (1, down)):
        for i in range(n - 1):
            for frm, to in ((i, i + 1), (i + 1, i)):
                if row[frm] and not row[to]:
                    nb = ref_bits.copy()
                    nb[frm + s * n] = False
                    nb[to + s * n] = True
                    keys.append(words_of(nb))
                    mels.append(-ham.t)
    # one-phonon satellites (H element g * sqrt(1) * n_elec(site))
    if ham.ph_bits:
        for site in range(n):
            n_at = int(up[site]) + int(down[site])
            if n_at == 0:
                continue
            nb = ref_bits.copy()
            nb[2 * n + site * ham.ph_bits] = True
            keys.append(words_of(nb))
            mels.append(ham.g * n_at)
    return jnp.asarray(np.stack(keys)), jnp.asarray(np.asarray(mels, np.float64))
