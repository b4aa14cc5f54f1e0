"""Real-molecule anchor: hand-rolled STO-3G integrals for H_n systems.

H2 at R=1.4 bohr reproduces the textbook FCI total energy -1.13728 Ha
(Szabo & Ostlund Table 3.15) from our own Gaussian integrals - the one
literature-anchored real molecule the reference's Benchmarks assume but
do not ship integrals for."""

import os

import numpy as np
import jax.numpy as jnp
import pytest

import dense_fci
from fries_tpu import io, sto3g
from fries_tpu.drivers import frisys
from fries_tpu.ops import molecule as mol

E_H2_FCI_LIT = -1.13728  # Ha, Szabo & Ostlund Table 3.15 (R = 1.4 bohr)


def test_h2_sto3g_matches_literature_fci():
    ham, enuc = sto3g.h_chain(1.4, 2)
    H, basis = dense_fci.build_hamiltonian(
        np.asarray(ham.hcore), np.asarray(ham.eris), 2, 1, 1
    )
    e0, _ = dense_fci.ground_state(H)
    assert abs((e0 + enuc) - E_H2_FCI_LIT) < 5e-5, e0 + enuc


def test_h2_fcidump_roundtrip(tmp_path):
    """FCIDUMP written from the STO-3G integrals re-parses to the same FCI
    energy (exercises the real-molecule I/O path end to end)."""
    ham, enuc = sto3g.h_chain(1.4, 2)
    path = str(tmp_path / "FCIDUMP_H2")
    io.write_fcidump(ham, path, core_energy=enuc)
    ham2, core2 = io.parse_fcidump(path)
    assert abs(core2 - enuc) < 1e-12
    H, _ = dense_fci.build_hamiltonian(
        np.asarray(ham2.hcore), np.asarray(ham2.eris), 2, 1, 1
    )
    e0, _ = dense_fci.ground_state(H)
    assert abs((e0 + core2) - E_H2_FCI_LIT) < 5e-5


def test_h6_chain_frisys_energy():
    """frisys on a real molecule (linear H6, R=1.8 bohr): projected energy
    matches this system's dense FCI within statistics."""
    ham, enuc = sto3g.h_chain(1.8, 6)
    H, basis = dense_fci.build_hamiltonian(
        np.asarray(ham.hcore), np.asarray(ham.eris), 6, 3, 3
    )
    e0, _ = dense_fci.ground_state(H)
    cfg = frisys.FrisysConfig(
        eps=0.05, vec_nonz=150, matr_samp=900, capacity=512,
        spawn_cap=2048, target_norm=300.0,
    )
    step, run_steps, state, aux = frisys.build(ham, cfg, seed=11)
    state, traj = run_steps(
        state, aux["num_keys"], aux["num_vals"], aux["den_keys"],
        aux["den_vals"], aux["ref_key"], 1500,
    )
    assert not bool(np.asarray(traj["overflow"]).any())
    num = np.asarray(traj["proj_num"])[500:]
    den = np.asarray(traj["proj_den"])[500:]
    e_est = float(aux["e_ref"]) + num.sum() / den.sum()
    blocks = np.array_split(num, 10)
    dblocks = np.array_split(den, 10)
    bm = np.array([b.sum() / d.sum() for b, d in zip(blocks, dblocks)])
    sigma = bm.std() / np.sqrt(len(bm))
    assert abs(e_est - e0) < max(5 * sigma, 0.01), (e_est, e0, sigma)


def test_rhf_matches_literature_and_slater_condon():
    """RHF on H2/STO-3G reproduces the Szabo-Ostlund HF energy; the
    HF-determinant Slater-Condon diagonal in the canonical-MO basis equals
    the converged SCF electronic energy (cross-validates rhf() against the
    framework's own matrix elements); FCI is basis-invariant."""
    centers = np.array([[0.0, 0.0, 0.0], [0.0, 0.0, 1.4]])
    s, t, v, eri = sto3g.integrals(centers)
    _, e_el = sto3g.rhf(s, t + v, eri, 2)
    enuc = sto3g.nuclear_repulsion(centers)
    assert abs((e_el + enuc) - (-1.11671)) < 5e-5

    ham, enuc4 = sto3g.h_chain(1.8, 4, basis="rhf")
    hf_diag = float(mol.hf_reference(ham)[2])
    s4, t4, v4, eri4 = sto3g.integrals(
        np.stack([[0.0, 0.0, 1.8 * i] for i in range(4)])
    )
    _, e4 = sto3g.rhf(s4, t4 + v4, eri4, 4)
    assert abs(hf_diag - e4) < 1e-8

    H, _ = dense_fci.build_hamiltonian(
        np.asarray(ham.hcore), np.asarray(ham.eris), 4, 2, 2
    )
    e_rhf_basis, _ = dense_fci.ground_state(H)
    ham_l, _ = sto3g.h_chain(1.8, 4, basis="lowdin")
    H_l, _ = dense_fci.build_hamiltonian(
        np.asarray(ham_l.hcore), np.asarray(ham_l.eris), 4, 2, 2
    )
    e_lowdin_basis, _ = dense_fci.ground_state(H_l)
    assert abs(e_rhf_basis - e_lowdin_basis) < 1e-9
