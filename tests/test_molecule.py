"""Molecular Hamiltonian tests against the independent dense-FCI builder.

The reference validates its Hamiltonian against real Ne integral data
(tests/test_hamiltonian.cpp:16-45); no ERIs ship with the repo, so here every
matrix-element path (diagonal, singles, doubles, parity, symmetry masks,
frozen core) is checked against exact second-quantization on small synthetic
systems instead.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

import dense_fci
from fries_tpu import dets
from fries_tpu.ops import molecule as mol


def project_symmetry(h, eris, symm):
    """Zero integrals that violate the abelian point-group symmetry."""
    symm = np.asarray(symm)
    sp = symm[:, None] == symm[None, :]
    h = np.where(sp, h, 0.0)
    g = symm
    allowed = (
        g[:, None, None, None]
        ^ g[None, :, None, None]
        ^ g[None, None, :, None]
        ^ g[None, None, None, :]
    ) == 0
    return h, np.where(allowed, eris, 0.0)


def occ_of_mask(mask, n_bits, n_elec):
    occ = [b for b in range(n_bits) if (mask >> b) & 1]
    assert len(occ) == n_elec
    return occ


def build_system(n_orb, n_elec, symm=None, frozen=0, seed=0):
    rng = np.random.default_rng(seed)
    tot = n_orb + frozen
    h, eris = dense_fci.random_integrals(rng, tot)
    if symm is None:
        symm = np.zeros(n_orb, np.int32)
    # symmetry applies to active orbitals; frozen orbitals take irrep 0
    full_symm = np.concatenate([np.zeros(frozen, np.int32), symm])
    h, eris = project_symmetry(h, eris, full_symm)
    ham = mol.MolecularHamiltonian(
        hcore=jnp.asarray(h),
        eris=jnp.asarray(eris),
        symm=jnp.asarray(symm, dtype=jnp.int32),
        n_orb=n_orb,
        n_elec=n_elec,
        n_frozen=2 * frozen,
    )
    dense_h, basis = dense_fci.build_hamiltonian(
        h, eris, n_orb, n_elec // 2, n_elec // 2, frozen=frozen
    )
    return ham, dense_h, basis


CASES = [
    dict(n_orb=5, n_elec=4, symm=None, frozen=0, seed=0),
    dict(n_orb=5, n_elec=4, symm=np.array([0, 1, 0, 1, 0], np.int32), frozen=0, seed=1),
    dict(n_orb=4, n_elec=4, symm=None, frozen=1, seed=2),
]


@pytest.fixture(scope="module")
def systems():
    return {i: build_system(**c) for i, c in enumerate(CASES)}


def test_diag_matches_dense(systems):
    for i, (ham, dense_h, basis) in systems.items():
        occs = np.array(
            [occ_of_mask(m, ham.n_bits, ham.n_elec) for m in basis], np.int32
        )
        got = np.asarray(mol.diag_matrel(ham, jnp.asarray(occs)))
        want = np.diag(dense_h)
        np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-10, err_msg=f"case {i}")


def test_hf_reference(systems):
    ham, dense_h, basis = systems[0]
    words, occ, energy = mol.hf_reference(ham)
    hf_mask = (2 ** (ham.n_elec // 2) - 1) | ((2 ** (ham.n_elec // 2) - 1) << ham.n_orb)
    idx = basis.index(hf_mask)
    np.testing.assert_allclose(float(energy), dense_h[idx, idx], rtol=1e-12)


def test_exact_offdiag_matches_dense_columns(systems):
    """Full column of off-diagonal H from exact_offdiag_batch must equal the
    dense Hamiltonian column (tests enumeration + elements + parity at once)."""
    for case, (ham, dense_h, basis) in systems.items():
        tmpl = mol.ExcitationTemplate.build(ham.n_orb, ham.n_elec)
        index = {m: i for i, m in enumerate(basis)}
        words = jnp.asarray(
            np.stack([dense_fci.mask_to_words(m, ham.n_bits) for m in basis])
        )
        occ = jnp.asarray(
            np.array([occ_of_mask(m, ham.n_bits, ham.n_elec) for m in basis], np.int32)
        )
        vals = jnp.ones(len(basis))
        new_words, amps, _ = mol.exact_offdiag_batch(ham, tmpl, words, occ, vals, 1.0)
        new_words = np.asarray(new_words)
        amps = np.asarray(amps)
        got = np.zeros_like(dense_h)
        for col in range(len(basis)):
            for c in range(amps.shape[1]):
                if amps[col, c] == 0:
                    continue
                mask = 0
                for b in range(ham.n_bits):
                    if (new_words[col, c, b // 32] >> (b % 32)) & 1:
                        mask |= 1 << b
                got[index[mask], col] += amps[col, c]
        want = dense_h - np.diag(np.diag(dense_h))
        np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-9, err_msg=f"case {case}")


def test_single_element_against_dense(systems):
    """Spot-check sing_matr_el + parity against dense H entries."""
    ham, dense_h, basis = systems[0]
    index = {m: i for i, m in enumerate(basis)}
    rng = np.random.default_rng(3)
    checked = 0
    for _ in range(200):
        col = rng.integers(len(basis))
        mask = basis[col]
        occ = occ_of_mask(mask, ham.n_bits, ham.n_elec)
        o = int(rng.choice(occ))
        virts = [b for b in range(ham.n_bits) if not (mask >> b) & 1
                 and b // ham.n_orb == o // ham.n_orb]
        if not virts:
            continue
        u = int(rng.choice(virts))
        new_mask = (mask & ~(1 << o)) | (1 << u)
        mel = float(
            mol.sing_matr_el(
                ham, jnp.asarray([o]), jnp.asarray([u]), jnp.asarray([occ])
            )[0]
        )
        words = jnp.asarray(dense_fci.mask_to_words(mask, ham.n_bits))[None]
        _, sign = dets.single_parity(words, jnp.asarray([o]), jnp.asarray([u]))
        got = mel * int(sign[0])
        want = dense_h[index[new_mask], col]
        np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-12)
        checked += 1
    assert checked > 50


def test_doub_element_hermitian(systems):
    ham, dense_h, basis = systems[1]
    np.testing.assert_allclose(dense_h, dense_h.T, atol=1e-12)


def test_matmul_precision_guard(systems):
    """The package must pin jax_default_matmul_precision to HIGHEST.

    Under the DEFAULT precision an accelerator may run f32 products in a
    reduced-mantissa mode (TF32 on a GPU), and XLA may choose that lowering
    for some batch shapes only: diag_matrel then comes out wrong by ~1 mHa,
    with values that depend on the batch shape.  This guards the config and
    the batch-vs-single consistency it keeps (trivially true on CPU).
    """
    assert jax.config.jax_default_matmul_precision == "highest"
    ham, dense_h, basis = systems[1]
    occs = np.array(
        [occ_of_mask(m, ham.n_bits, ham.n_elec) for m in basis], np.int32
    )
    batch = np.asarray(mol.diag_matrel(ham, jnp.asarray(occs)))
    idx = [0, len(basis) // 3, len(basis) - 1]
    single = np.array(
        [float(mol.diag_matrel(ham, jnp.asarray(occs[i : i + 1]))[0]) for i in idx]
    )
    np.testing.assert_allclose(batch[idx], single, rtol=0, atol=0)
