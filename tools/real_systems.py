"""Cached real-molecule Hamiltonians for benches and science runs.

All five BASELINE.md configurations run on real systems from here:

  h2o_ccpvdz()        H2O eq. geometry (Input_Data/H2O_ccpvdz era)
  n2_ccpvdz()         N2 r=2.068 (flagship)
  n2_stretched()      N2 r=4.2 (Input_Data/N2_str_ccpvdz era), frozen core
  ne_augccpvdz()      Ne aug-cc-pVDZ, 1s frozen
  ne_ccpvqz()         Ne cc-pVQZ (re-derived basis), 1s frozen

Geometries follow the reference's Results.tex sections; each Hamiltonian is
cached under results/realsys/ in the checkout after its first build.
"""

from __future__ import annotations

import os
import sys

import numpy as np

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _REPO)

CACHE_DIR = os.path.join(_REPO, "results", "realsys")


def _cached(name, builder, cache_dir=CACHE_DIR):
    import jax.numpy as jnp
    from fries_tpu.ops import molecule as mol

    os.makedirs(cache_dir, exist_ok=True)
    cache = os.path.join(cache_dir, f"{name}.npz")
    if os.path.exists(cache):
        d = np.load(cache)
        return mol.MolecularHamiltonian(
            hcore=jnp.asarray(d["hcore"]), eris=jnp.asarray(d["eris"]),
            symm=jnp.asarray(d["symm"]), n_orb=int(d["n_orb"]),
            n_elec=int(d["n_elec"]), n_frozen=int(d["n_frozen"]))
    ham = builder()
    np.savez(cache, hcore=np.asarray(ham.hcore), eris=np.asarray(ham.eris),
             symm=np.asarray(ham.symm), n_orb=ham.n_orb, n_elec=ham.n_elec,
             n_frozen=ham.n_frozen)
    return ham


def h2o_ccpvdz():
    def build():
        from fries_tpu import scf
        r, th = 1.84345, np.deg2rad(110.6)
        y, z = r * np.sin(th / 2), r * np.cos(th / 2)
        centers = np.array([[0.0, 0.0, 0.0], [0.0, y, z], [0.0, -y, z]])
        ham, _ = scf.build_molecule(("O", "H", "H"), centers,
                                    basis="cc-pvdz", n_frozen=0)
        return ham
    return _cached("h2o_ccpvdz", build)


def n2_ccpvdz():
    def build():
        from fries_tpu import scf
        r = 2.068
        centers = np.array([[0.0, 0.0, -r / 2], [0.0, 0.0, r / 2]])
        ham, _ = scf.build_molecule(("N", "N"), centers,
                                    basis="cc-pvdz", n_frozen=4)
        return ham
    return _cached("n2_ccpvdz", build)


def n2_stretched():
    """Stretched N2 (r = 4.2 a0, Results.tex:103-110), cc-pVDZ, 4 frozen."""
    def build():
        from fries_tpu import scf
        r = 4.2
        centers = np.array([[0.0, 0.0, -r / 2], [0.0, 0.0, r / 2]])
        ham, _ = scf.build_molecule(("N", "N"), centers,
                                    basis="cc-pvdz", n_frozen=4)
        return ham
    return _cached("n2_stretched", build)


def ne_augccpvdz():
    def build():
        from fries_tpu import scf
        ham, _ = scf.build_molecule(("Ne",), np.zeros((1, 3)),
                                    basis="aug-cc-pvdz", n_frozen=2)
        return ham
    return _cached("ne_augccpvdz", build)


def ne_ccpvqz():
    def build():
        from fries_tpu import scf
        ham, _ = scf.build_molecule(("Ne",), np.zeros((1, 3)),
                                    basis="cc-pvqz", n_frozen=2)
        return ham
    return _cached("ne_ccpvqz", build)


if __name__ == "__main__":
    for name in sys.argv[1:] or ["h2o_ccpvdz", "n2_ccpvdz", "n2_stretched",
                                 "ne_augccpvdz", "ne_ccpvqz"]:
        ham = globals()[name]()
        print(f"{name}: n_orb={ham.n_orb} n_elec={ham.n_elec} "
              f"n_frozen={ham.n_frozen}", flush=True)
