"""frimulti_mol: FRI with multinomial Hamiltonian compression
(FRIES_bin/frimulti_mol.cpp).

Each iteration distributes ``matr_samp`` column samples over the occupied
determinants with one shared systematic grid on |v| (frimulti_mol.cpp:
300-321), then each sample draws one excitation from the near-uniform or
heat-bath multinomial generators (ops.near_uniform) and spawns

    -eps * H_el / p_gen / p_channel / n_samples(det) * v(det) * parity
    / min(1, |v| / sampling_unit)

(frimulti_mol.cpp:351-375).  Death and systematic vector compression are the
standard power-core steps.  Batched redesign: the per-determinant sample counts
come from the same grid-counting kernel as systematic compression, and
sample slots map to parents by searchsorted (as in drivers.fciqmc).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import jax
import jax.numpy as jnp

from fries_tpu import compress, dets
from fries_tpu.drivers import power
from fries_tpu.ops import heat_bath as hb
from fries_tpu.ops import molecule as mol
from fries_tpu.ops import near_uniform as nu
from fries_tpu.drivers import frisys
from fries_tpu.runtime import arena as ar


@dataclass(frozen=True)
class FrimultiConfig:
    eps: float
    vec_nonz: int
    matr_samp: int
    capacity: int
    spawn_cap: int          # >= matr_samp + slack
    init_thresh: float = 0.0
    target_norm: float = 0.0
    shift_interval: int = 10
    shift_damping: float = 0.05
    distribution: str = "NU"   # "NU" | "HB"

    def power(self) -> power.PowerConfig:
        return power.PowerConfig(
            eps=self.eps,
            target_nonz=self.vec_nonz,
            capacity=self.capacity,
            init_thresh=self.init_thresh,
            target_norm=self.target_norm,
            shift_interval=self.shift_interval,
            shift_damping=self.shift_damping,
        )


def make_spawner(ham: mol.MolecularHamiltonian, syminfo: mol.SymmInfo,
                 p_doub: float, cfg: FrimultiConfig, e_ref):
    n_orb, n_elec = ham.n_orb, ham.n_elec
    lookup = jnp.asarray(syminfo.lookup)
    symm = jnp.asarray(syminfo.symm)
    symm_counts = jnp.asarray(syminfo.counts)
    tens = hb.setup(ham) if cfg.distribution == "HB" else None
    a_cap = cfg.spawn_cap
    m_samp = cfg.matr_samp

    def spawn(keys, vals, h_fac, key):
        occ = dets.occ_list(keys, 2 * n_orb, n_elec)
        absv = jnp.abs(vals)
        norm = jnp.sum(absv)
        unit = norm / m_samp
        k_rn, k_split, k_spawn = jax.random.split(key, 3)
        rn = jax.random.uniform(k_rn, dtype=jnp.float64)

        cum = jnp.cumsum(absv) - absv
        from fries_tpu.compress import _grid_count_below

        hits = (
            _grid_count_below(cum + absv, rn, unit)
            - _grid_count_below(cum, rn, unit)
        ).astype(jnp.int64)
        colsamp_wt = jnp.minimum(1.0, absv / jnp.maximum(unit, 1e-300))

        from fries_tpu.drivers.fciqmc import _attempt_parents

        parent, valid, total = _attempt_parents(hits, a_cap)
        overflow_local = total > a_cap

        p_occ = occ[parent]
        p_keys = keys[parent]
        p_bits = dets.unpack_bits(p_keys, 2 * n_orb)
        counts = hb.unocc_symm_counts(n_orb, n_elec, symm, symm_counts, p_occ)

        u = jax.random.uniform(k_split, (a_cap,), dtype=jnp.float64)
        is_doub = u < p_doub
        kd, ks = jax.random.split(k_spawn)
        if cfg.distribution == "HB":
            d = nu.sample_doubles_heat_bath(
                kd, tens, n_orb, n_elec, symm, lookup, p_occ, p_bits
            )
        else:
            d = nu.sample_doubles(
                kd, n_orb, n_elec, symm, lookup, p_occ, p_bits, counts
            )
        s = nu.sample_singles(ks, n_orb, n_elec, symm, lookup, p_occ, p_bits, counts)

        base = (
            vals[parent]
            / jnp.maximum(hits[parent], 1)
            / jnp.maximum(colsamp_wt[parent], 1e-300)
        )
        dmel = mol.doub_matr_el(ham, d["o1"], d["o2"], d["u1"], d["u2"])
        dwords, dsign = dets.double_parity(p_keys, d["o1"], d["o2"], d["u1"], d["u2"])
        damp = h_fac * dmel / d["prob"] / p_doub * base * dsign
        dmask = valid & is_doub & d["valid"]

        smel = mol.sing_matr_el(ham, s["o"], s["u"], p_occ)
        swords, ssign = dets.single_parity(p_keys, s["o"], s["u"])
        samp = h_fac * smel / s["prob"] / (1 - p_doub) * base * ssign
        smask = valid & ~is_doub & s["valid"]

        amps = jnp.where(dmask, damp, jnp.where(smask, samp, 0.0))
        new_words = jnp.where(dmask[:, None], dwords, swords)
        new_words = jnp.where(
            (amps != 0)[:, None], new_words, jnp.asarray(dets.invalid_det(ham.n_words))
        )
        ini = jnp.abs(vals[parent]) > cfg.init_thresh
        return new_words, amps, ini

    return spawn


def build(ham: mol.MolecularHamiltonian, cfg: FrimultiConfig, seed: int,
          init_val: float = 100.0, trial=None, init_vec=None, e_ref=None):
    """trial / init_vec / e_ref mirror frisys.build (reference
    frimulti_mol.cpp:27-33 --trial_vec / --ini_vec / --ham_shift)."""
    syminfo = mol.SymmInfo.build(np.asarray(ham.symm))
    from fries_tpu.drivers import frisys as _frisys

    p_doub = _frisys.hf_p_doub(ham, syminfo)
    hf_words, hf_occ, hf_en = mol.hf_reference(ham)
    if e_ref is not None:
        hf_en = float(e_ref)

    spawn = make_spawner(ham, syminfo, p_doub, cfg, hf_en)
    diag_fn = frisys.make_diag_fn(ham, hf_en)
    step, run_steps = power.make_stepper(
        spawn, diag_fn, cfg.power(), estimator="direct"
    )

    if trial is None:
        trial_keys = np.asarray(hf_words)[None]
        trial_vals = np.ones((1,))
    else:
        trial_keys, trial_vals = np.asarray(trial[0]), np.asarray(trial[1])
    htrial_keys, htrial_vals = _frisys.compute_htrial(ham, trial_keys, trial_vals,
                                                      e_ref=hf_en)

    a = ar.make(cfg.capacity, ham.n_words, 2)
    if init_vec is not None:
        ik = jnp.asarray(np.asarray(init_vec[0]))
        iv = jnp.asarray(np.asarray(init_vec[1]))
        a = ar.from_unsorted(a, ik, jnp.stack([iv, jnp.zeros(iv.shape[0])]))
    else:
        a = ar.from_unsorted(a, hf_words[None], jnp.asarray([[init_val], [0.0]]))
    state = power.fresh_state(a, seed)
    aux = {
        "e_ref": hf_en,
        "num_keys": jnp.asarray(htrial_keys),
        "num_vals": jnp.asarray(htrial_vals),
        "den_keys": jnp.asarray(trial_keys),
        "den_vals": jnp.asarray(trial_vals),
        "ref_key": hf_words,
        "p_doub": p_doub,
    }
    return step, run_steps, state, aux
