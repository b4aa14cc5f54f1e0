"""frisys_mol: systematic FCI-FRI with heat-bath Power-Pitzer factorized
Hamiltonian compression - the flagship workload (FRIES_bin/frisys_mol.cpp).

The reference's apply_HBPP_sys (heat_bathPP.cpp:686-992) interleaves five
``comp_sub`` compressions with per-sample scalar bookkeeping; here each level
is one batched ``compress.comp_sub`` over a statically-shaped sample buffer,
with per-sample probability rows built by the batched kernels in
ops.heat_bath.  Sample metadata (determinant slot, single/double kind, chosen
orbital slots) lives in parallel int32 arrays remapped by gather after every
compression round - the TPU equivalent of the reference's orb_indices1/2 +
det_indices1/2 double-buffering (heat_bathPP.cpp:698-702).

Level structure for doubles (singles in parentheses):
  A. single-vs-double split          [p_doub, 1-p_doub]
  B. first occupied o1 ~ s_tens      (uniform over allowed electrons)
  C. second occupied o2 ~ d_same/d_diff (uniform over allowed virtuals)
  D. first virtual u1 ~ exch_sqrt    (pass-through)
  E. second virtual u2 ~ exch_sqrt over the symmetry-allowed row
Finalization divides the sampled weight by the total selection probability
(calc_norm_wt / calc_unnorm_wt) and multiplies the Slater-Condon element and
fermionic parity (heat_bathPP.cpp:917-989).
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial

import numpy as np
import jax
import jax.numpy as jnp

from fries_tpu import compress, dets, kernels
from fries_tpu.drivers import power
from fries_tpu.ops import heat_bath as hb
from fries_tpu.ops import molecule as mol
from fries_tpu.runtime import arena as ar


@dataclass(frozen=True)
class FrisysConfig:
    eps: float
    vec_nonz: int           # vector compression budget (target_nonz)
    matr_samp: int          # Hamiltonian compression budget per level
    capacity: int
    spawn_cap: int          # static sample-buffer size (>= matr_samp + slack)
    init_thresh: float = 0.0
    target_norm: float = 0.0
    shift_interval: int = 10
    shift_damping: float = 0.05
    shift_tracking: float = 0.0   # see power.PowerConfig.shift_tracking
    unnorm: bool = False    # HB_unnorm distribution variant
    pivotal: bool = False   # pivotal per-stage compression (apply_HBPP_piv,
                            # heat_bathPP.cpp:994-1419) instead of systematic
    spin_parity: int = 0    # time-reversal sector (+1/-1; 0 = off): fold
                            # sampled excitations onto the symmetrized basis
    stage_f32: bool = True  # hold comp_sub probability rows in f32 (halves
                            # the dominant (S, K) stage bandwidth; norms, grid
                            # positions, values and estimators stay f64)
    fuse_ab: bool = True    # fuse levels A (single-vs-double) and B (o1 /
                            # allowed-electron rank) into ONE comp_sub over a
                            # joint (2 n_elec)-column row: same per-chain
                            # masses (see spawn), one fewer serial
                            # fixpoint+emission+remap round, and no budget
                            # spent on singles with zero allowed targets.
                            # False restores the reference's 5-level
                            # structure (apply_HBPP_sys levels 1+2 separate).
    fuse_cd: bool = True    # fuse levels C (o2) and D (u1) into ONE comp_sub
                            # over the joint (n_elec * n_virt)-column outer
                            # product: the HB-PP u1 conditional depends only
                            # on o1 (calc_u1_probs, heat_bathPP.cpp:273-319),
                            # so P(o2, u1 | o1) = P(o2|o1) P(u1|o1) is
                            # available before sampling either.  Singles ride
                            # the same stage as uniform ndiv = n_virt rows
                            # (their old level-C role); level D disappears.
    emit_chunk: int = 0     # chunk comp_sub's output-slot inversion (bounds
                            # the (chunk, K) emission temporaries at 1e6+ S)
    axis_name: str | None = None
    n_shards: int = 1
    exchange_cap: int = 0
    spawn_rows: int = 0     # spawn from only the first spawn_rows arena
                            # rows (power.PowerConfig.spawn_rows): after the
                            # fused compaction the live prefix is
                            # <= vec_nonz + protected rows, so a static
                            # vec_nonz + slack bound halves every
                            # per-arena-row spawner stage at capacity =
                            # 2 * vec_nonz (overflow-flagged if violated)

    def power(self) -> power.PowerConfig:
        return power.PowerConfig(
            eps=self.eps,
            target_nonz=self.vec_nonz,
            capacity=self.capacity,
            init_thresh=self.init_thresh,
            target_norm=self.target_norm,
            shift_interval=self.shift_interval,
            shift_damping=self.shift_damping,
            shift_tracking=self.shift_tracking,
            axis_name=self.axis_name,
            n_shards=self.n_shards,
            exchange_cap=self.exchange_cap,
            spawn_rows=self.spawn_rows,
        )


def _rank_to_index(mask, rank):
    """Column of the rank-th True entry per row (K if out of range)."""
    k = mask.shape[-1]
    cum = kernels.row_cumsum(mask).astype(jnp.int32) - 1
    hit = mask & (cum == rank[..., None])
    idx = jnp.sum(jnp.where(hit, jnp.arange(k, dtype=jnp.int32), 0), axis=-1)
    found = jnp.any(hit, axis=-1)
    return jnp.where(found, idx, k), found


def make_hbpp_spawner(ham: mol.MolecularHamiltonian, tens: hb.HeatBathTensors,
                      syminfo: mol.SymmInfo, p_doub: float, cfg: FrisysConfig,
                      e_ref, determ=None):
    """Stochastically-compressed H application conforming to the power-core
    spawn interface.

    ``determ`` (optional): the semistochastic deterministic subspace
    (frisys_mol.cpp:347-401, 479-485) - dict with keys ``keys`` (D, W) member
    determinants, ``from`` (DH,) member index of each dense H element,
    ``words``/``amp``/``occ``/``diag`` (DH, ...) precomputed target
    determinants and sign-carrying matrix elements.  Member determinants are
    excluded from stochastic sampling; the dense block spawns exactly.
    """
    n_orb = ham.n_orb
    n_elec = ham.n_elec
    half = n_elec // 2
    n_virt = n_orb - half
    lookup = jnp.asarray(syminfo.lookup)
    symm = jnp.asarray(syminfo.symm)
    s_cap = cfg.spawn_cap
    m_samp = cfg.matr_samp
    if determ is not None:
        m_samp = m_samp - int(determ["n_elements"])
        assert m_samp > 0, "matr_samp must exceed the dense H element count"
    unnorm = cfg.unnorm
    _sw = (lambda w: w.astype(jnp.float32)) if cfg.stage_f32 else (lambda w: w)
    _ck = dict(axis_name=cfg.axis_name, emit_chunk=cfg.emit_chunk)
    # systematic fused-CD runs through compress.comp_sub_factored, which
    # recomputes the rank-1 joint on the fly (no (spawn_cap, n_elec*n_virt)
    # materialization) — active at EVERY rung.  The pivotal path still
    # materializes the joint for comp_sub_piv, so it keeps a device-memory
    # gate on that joint's size.
    import os as _os
    _fuse_cd_max = int(_os.environ.get("FRIES_FUSE_CD_MAX_BYTES",
                                       500_000_000))
    fuse_cd = cfg.fuse_cd and (
        not cfg.pivotal
        or s_cap * n_elec * (n_orb - half) * 4 <= _fuse_cd_max)
    # chunk the factored stage's row passes at ~256 MB of (chunk, K) rows
    _stage_item = 4 if cfg.stage_f32 else 8
    _kj_bytes = n_elec * n_virt * _stage_item
    if s_cap * _kj_bytes <= 64_000_000:
        _cd_row_chunk = 0
    else:
        _cd_row_chunk = max(1, (256_000_000 // _kj_bytes) // 8192 * 8192)
    _cd_row_chunk = int(_os.environ.get("FRIES_CD_ROW_CHUNK", _cd_row_chunk))

    def _stage(level, vals_in, ndiv_in, w_in, m_in, rns, keys5, max_ndiv):
        # one compression level: systematic shared-grid (apply_HBPP_sys) or
        # pivotal tree selection (apply_HBPP_piv) per cfg.pivotal
        if cfg.pivotal:
            return compress.comp_sub_piv(
                vals_in, ndiv_in, _sw(w_in), w_in != 0, m_in, keys5[level],
                s_cap, max_ndiv=max_ndiv, axis_name=cfg.axis_name,
            )
        return compress.comp_sub(
            vals_in, ndiv_in, _sw(w_in), w_in != 0, m_in, rns[level], s_cap,
            **_ck,
        )

    def spawn(keys, vals, h_fac, key, thresh=None):
        # ``thresh`` (optional, traced scalar) overrides the static initiator
        # cutoff; the subspace driver passes the norm-relative threshold
        # init_thresh * ||v||_1 / matr_samp (subsp_mol.cpp:522-523).
        c = keys.shape[0]
        # occupied lists recomputed from keys (the arena caches none)
        occ = dets.occ_list(keys, 2 * n_orb, n_elec)
        vals0_full = vals
        if determ is not None:
            dpos, dfound = dets.lookup_dets(keys, determ["keys"])
            is_determ = jnp.zeros((c,), jnp.bool_).at[
                jnp.where(dfound, dpos, c)
            ].set(True, mode="drop")
            vals = jnp.where(is_determ, 0.0, vals)
        absv = jnp.abs(vals)
        rns = jax.random.uniform(key, (6,), dtype=jnp.float64)
        keys5 = jax.random.split(jax.random.fold_in(key, 77), 5)
        overflow = jnp.bool_(False)

        # one consolidated (C, E+W) arena payload: occ + bitcast keys,
        # fetched ONCE after the first stage and then carried through the
        # per-level metadata remaps - one row gather per level total instead
        # of metadata remap + arena re-gather (f64 vals stay out of the
        # i32 payload)
        from jax import lax as _lax

        n_words = keys.shape[1]
        apay = jnp.concatenate(
            [occ, _lax.bitcast_convert_type(keys, jnp.int32)], axis=1
        )

        def unpack_prow(prow):
            s_occ = prow[:, :n_elec]
            s_keys = _lax.bitcast_convert_type(
                prow[:, n_elec : n_elec + n_words], jnp.uint32
            )
            occ_bits = dets.unpack_bits(s_keys, 2 * n_orb)
            return s_occ, s_keys, occ_bits

        def remap(pidx, cols, prow):
            """One packed row gather for all per-sample metadata columns AND
            the carried parent payload."""
            # pin metadata to int32: jnp.sum/take_along promote int32 ->
            # int64 under x64, and an int64 concat would corrupt the
            # bitcast key words carried in prow
            m = jnp.concatenate(
                [jnp.stack(cols, axis=1).astype(jnp.int32), prow], axis=1
            )[pidx]
            nc = len(cols)
            return [m[:, i] for i in range(nc)], m[:, nc:]

        if cfg.fuse_ab:
            # ------------- fused level A+B: joint (kind, o1 / rank) --------
            # One comp_sub over a (C, 2E) row per arena determinant:
            # columns [0, E) carry the double-branch mass
            #   |v_i| * p_doub * P(o1 = slot e)      (calc_o1_probs),
            # columns [E, 2E) the single-branch mass
            #   |v_i| * (1 - p_doub) / n_allowed_i   (rank r < n_allowed_i).
            # Chain masses are identical to the two-stage A->B form, so
            # levels C-E and the finalize weights are untouched; the only
            # statistical difference is one fewer intermediate resampling
            # (never worse in variance) and no budget spent on singles from
            # determinants with zero allowed targets (the two-stage form
            # zeroes those AFTER level A has already charged the budget).
            counts0 = hb.unocc_symm_counts(
                n_orb, n_elec, symm, jnp.asarray(syminfo.counts), occ
            )
            _, n_alw0 = hb.sing_allowed(n_orb, n_elec, symm, counts0, occ)
            probsB0, o1_norm0 = hb.o1_probs(tens, n_orb, occ)
            if unnorm:
                # exclude the first electron (o2 must lie below o1) and fold
                # tot_weight = norm/s_norm into the branch mass
                # (heat_bathPP.cpp:744-750)
                excl = jnp.arange(n_elec, dtype=jnp.int32)[None, :] == 0
                w_doub = jnp.where(excl, 0.0, probsB0 * o1_norm0[:, None]) * (
                    p_doub / tens.s_norm
                )
            else:
                w_doub = probsB0 * p_doub
            r_cols = jnp.arange(n_elec, dtype=jnp.int32)[None, :]
            w_sing = jnp.where(
                r_cols < n_alw0[:, None],
                (1.0 - p_doub)
                / jnp.maximum(n_alw0, 1).astype(jnp.float64)[:, None],
                0.0,
            )
            w_joint = jnp.concatenate([w_doub, w_sing], axis=1)
            ndiv0 = jnp.zeros((c,), jnp.int32)
            val, parent, sub, _, ovf = _stage(
                1, absv, ndiv0, w_joint, m_samp, rns, keys5, 0
            )
            overflow |= ovf
            live = parent >= 0
            det_idx = jnp.where(live, parent, 0)
            is_doub = live & (sub < n_elec)
            o1_idx = jnp.where(is_doub, sub, 0)    # electron slot of o1
            sing_rank = jnp.where(
                ~is_doub & live, sub - n_elec, 0
            )  # allowed-electron rank
            prow = apay[det_idx]
        else:
            # ------------- level A: single vs double -----------------------
            ndiv = jnp.zeros((c,), jnp.int32)
            subw = jnp.tile(jnp.asarray([[p_doub, 1.0 - p_doub]]), (c, 1))
            maskA = jnp.ones((c, 2), bool)
            val, parent, sub, _, ovf = _stage(
                0, absv, ndiv, jnp.where(maskA, subw, 0.0), m_samp, rns,
                keys5, 0
            )
            overflow |= ovf
            det_idx = jnp.where(parent >= 0, parent, 0)
            live = parent >= 0
            is_doub = (sub == 0) & live

            # --------- level B: o1 (doubles) / allowed count (singles) -----
            prow = apay[det_idx]
            s_occ, s_keys, occ_bits = unpack_prow(prow)
            counts = hb.unocc_symm_counts(
                n_orb, n_elec, symm, jnp.asarray(syminfo.counts), s_occ
            )
            per_elec, n_occ_allowed = hb.sing_allowed(
                n_orb, n_elec, symm, counts, s_occ
            )

            probsB, o1_norm_frac = hb.o1_probs(tens, n_orb, s_occ)
            if unnorm:
                # exclude the first electron (o2 must lie below o1); fold the
                # normalization fraction into the value
                # (heat_bathPP.cpp:744-750)
                excl = jnp.arange(n_elec, dtype=jnp.int32)[None, :] == 0
                w = jnp.where(excl, 0.0, probsB * o1_norm_frac[:, None])
                newnorm = jnp.sum(w, axis=-1, keepdims=True)
                probsB = w / jnp.maximum(newnorm, 1e-300)
                # the reference folds tot_weight = norm/s_norm into the value
                # (heat_bathPP.cpp:746-749)
                val = jnp.where(
                    is_doub, val * (newnorm[:, 0] / tens.s_norm), val
                )
            sing_ok = n_occ_allowed > 0
            ndivB = jnp.where(
                is_doub, 0, jnp.maximum(n_occ_allowed, 1)
            ).astype(jnp.int32)
            valB_in = jnp.where(live & (is_doub | sing_ok), val, 0.0)
            maskB = is_doub[:, None] & jnp.ones((s_cap, n_elec), bool)
            val, parent, sub, _, ovf = _stage(
                1, valB_in, ndivB, jnp.where(maskB, probsB, 0.0), m_samp, rns,
                keys5, n_elec,
            )
            overflow |= ovf
            live = parent >= 0
            pidx = jnp.where(live, parent, 0)
            (det_idx, d_i), prow = remap(
                pidx, [det_idx, is_doub.astype(jnp.int32)], prow
            )
            is_doub = (d_i != 0) & live
            o1_idx = jnp.where(is_doub, sub, 0)    # electron slot of o1
            sing_rank = jnp.where(
                ~is_doub & live, sub, 0
            )  # allowed-electron rank

        # ---------------- level C (+D when fused) ----------------
        s_occ, s_keys, occ_bits = unpack_prow(prow)
        counts = hb.unocc_symm_counts(
            n_orb, n_elec, symm, jnp.asarray(syminfo.counts), s_occ
        )
        per_elec, n_occ_allowed = hb.sing_allowed(n_orb, n_elec, symm, counts, s_occ)

        if unnorm:
            probsC, o2_frac = hb.o2_probs_half(tens, n_orb, n_elec, s_occ, o1_idx)
            val = jnp.where(is_doub, val * o2_frac, val)
        else:
            probsC, _ = hb.o2_probs(tens, n_orb, n_elec, s_occ, o1_idx)
        # singles: electron choice from allowed rank
        s_elec, s_found = _rank_to_index(per_elec > 0, sing_rank)
        s_elec = jnp.where(s_found, s_elec, 0)
        s_nvirt = kernels.take_along_small(per_elec, s_elec)
        sing_ok = (~is_doub) & live & s_found & (s_nvirt > 0)

        if fuse_cd:
            # ---- fused C+D: joint (o2, u1) over n_elec * n_virt columns --
            # P(u1 | o1) does not involve o2 (calc_u1_probs reads only the
            # o1 row of exch_sqrt), so the joint conditional is available
            # before sampling either index.  Chain masses are identical to
            # the sequential C -> D form:
            #   norm:   probsC[e] * probsD[v]
            #   unnorm: probsC[e] * w_u1[v] / exch_norms[o1], with the
            #           same-spin first-virtual exclusion per o2 column —
            #           the u1_frac * probsD product telescopes to
            #           w_u1 / exch_norms, so per-variant normalization
            #           cancels out of the joint entirely
            #           (heat_bathPP.cpp:744-790 applies the fractions to
            #           the value; folding them into the branch mass is the
            #           same A+B-fusion trick as tot_weight above).
            # Singles ride the same stage as uniform ndiv = s_nvirt rows
            # (their old level-C role); level D disappears.
            o1_orb = kernels.take_along_small(s_occ, o1_idx)
            w_u1, fracD, _ = hb.u1_probs(tens, n_orb, n_elec, occ_bits,
                                         o1_orb)
            kj = n_elec * n_virt
            if unnorm:
                # recover the unnormalized exch row over exch_norms:
                # u1_probs returns w/norm and frac = norm/exch_norms, so
                # w * frac = w_raw / exch_norms directly
                fac_b = w_u1 * fracD[:, None]
                same_col = (s_occ // n_orb) == (o1_orb // n_orb)[:, None]
                kill_b0 = same_col
            else:
                fac_b = w_u1
                kill_b0 = None
            # rank-1 row sums from the factors (all entries nonnegative, so
            # <= 0 iff the joint row is all zero; the kill_b0 correction
            # subtracts the zeroed (e, v=0) column masses)
            rowsumJ = jnp.sum(probsC, axis=-1) * jnp.sum(fac_b, axis=-1)
            if kill_b0 is not None:
                rowsumJ = rowsumJ - jnp.sum(
                    jnp.where(kill_b0, probsC, 0.0), axis=-1
                ) * fac_b[:, 0]
            fac_a = jnp.where(is_doub[:, None], probsC, 0.0)
            if cfg.stage_f32:
                fac_a = fac_a.astype(jnp.float32)
                fac_b = fac_b.astype(jnp.float32)
            ndivCD = jnp.where(
                is_doub, 0, jnp.maximum(s_nvirt, 1)).astype(jnp.int32)
            valCD_in = jnp.where(is_doub | sing_ok, val, 0.0)
            valCD_in = jnp.where(is_doub & (rowsumJ <= 0), 0.0, valCD_in)
            if cfg.pivotal:
                joint = (fac_a[:, :, None] * fac_b[:, None, :])
                if kill_b0 is not None:
                    joint = jnp.where(
                        kill_b0[:, :, None]
                        & (jnp.arange(n_virt) == 0)[None, None, :],
                        0.0, joint,
                    )
                joint = joint.reshape(joint.shape[0], kj)
                val, parent, sub, _, ovf = _stage(
                    2, valCD_in, ndivCD, joint, m_samp, rns, keys5,
                    max(n_virt, kj),
                )
            else:
                val, parent, sub, _, ovf = compress.comp_sub_factored(
                    valCD_in, ndivCD, fac_a, fac_b, m_samp, rns[2], s_cap,
                    kill_b0=kill_b0, axis_name=cfg.axis_name,
                    emit_chunk=cfg.emit_chunk, row_chunk=_cd_row_chunk,
                )
            overflow |= ovf
            live = parent >= 0
            pidx = jnp.where(live, parent, 0)
            (det_idx, d_i, o1_idx, s_elec), prow = remap(
                pidx,
                [det_idx, is_doub.astype(jnp.int32), o1_idx, s_elec], prow
            )
            is_doub = (d_i != 0) & live
            o2_idx = jnp.where(is_doub, sub // n_virt, 0)
            u1_slot = jnp.where(is_doub, sub % n_virt, 0)
            virt_rank = jnp.where(~is_doub & live, sub, 0)
        else:
            ndivC = jnp.where(
                is_doub, 0, jnp.maximum(s_nvirt, 1)).astype(jnp.int32)
            valC_in = jnp.where(is_doub | sing_ok, val, 0.0)
            rowsum = jnp.sum(probsC, axis=-1)
            valC_in = jnp.where(is_doub & (rowsum <= 0), 0.0, valC_in)
            maskC = is_doub[:, None] & (probsC > 0)
            val, parent, sub, _, ovf = _stage(
                2, valC_in, ndivC, jnp.where(maskC, probsC, 0.0), m_samp,
                rns, keys5, n_virt,
            )
            overflow |= ovf
            live = parent >= 0
            pidx = jnp.where(live, parent, 0)
            (det_idx, d_i, o1_idx, s_elec), prow = remap(
                pidx,
                [det_idx, is_doub.astype(jnp.int32), o1_idx, s_elec], prow
            )
            is_doub = (d_i != 0) & live
            o2_idx = jnp.where(is_doub, sub, 0)
            virt_rank = jnp.where(~is_doub & live, sub, 0)

            # ---------------- level D: u1 (doubles) ----------------
            s_occ, s_keys, occ_bits = unpack_prow(prow)
            o1_orb = kernels.take_along_small(s_occ, o1_idx)
            o2_orb = kernels.take_along_small(s_occ, o2_idx)
            if unnorm:
                same_oo = (o1_orb // n_orb) == (o2_orb // n_orb)
                probsD, u1_frac, virtsD = hb.u1_probs(
                    tens, n_orb, n_elec, occ_bits, o1_orb,
                    exclude_first=same_oo
                )
                val = jnp.where(is_doub, val * u1_frac, val)
            else:
                probsD, _, virtsD = hb.u1_probs(
                    tens, n_orb, n_elec, occ_bits, o1_orb)
            rowsumD = jnp.sum(probsD, axis=-1)
            ndivD = jnp.where(is_doub, 0, 1).astype(jnp.int32)
            valD_in = jnp.where(is_doub & (rowsumD <= 0), 0.0, val)
            maskD = is_doub[:, None] & (probsD > 0)
            val, parent, sub, _, ovf = _stage(
                3, valD_in, ndivD, jnp.where(maskD, probsD, 0.0), m_samp,
                rns, keys5, 1,
            )
            overflow |= ovf
            live = parent >= 0
            pidx = jnp.where(live, parent, 0)
            (det_idx, d_i, o1_idx, o2_idx, s_elec, virt_rank), prow = remap(
                pidx,
                [det_idx, is_doub.astype(jnp.int32), o1_idx, o2_idx, s_elec,
                 virt_rank], prow,
            )
            is_doub = (d_i != 0) & live
            u1_slot = jnp.where(is_doub, sub, 0)

        # ---------------- level E: u2 (doubles) ----------------
        s_occ, s_keys, occ_bits = unpack_prow(prow)
        o1_orb = kernels.take_along_small(s_occ, o1_idx)
        o2_orb = kernels.take_along_small(s_occ, o2_idx)
        spin1 = o1_orb // n_orb
        spin_bits = jnp.where(
            (spin1 == 0)[:, None],
            occ_bits[:, :n_orb],
            occ_bits[:, n_orb : 2 * n_orb],
        )
        virts = hb.virtual_slots(n_orb, n_elec, spin_bits)
        u1_sp = kernels.take_along_small(
            virts, jnp.clip(u1_slot, 0, n_virt - 1)
        )
        u1_orb = jnp.where(u1_sp < n_orb, u1_sp + spin1 * n_orb, 0)
        probsE, u2_frac, orb_rowE = hb.u2_probs(
            tens, n_orb, symm, lookup, o1_orb, o2_orb, u1_orb,
            occ_bits=occ_bits, half=unnorm,
        )
        if unnorm:
            val = jnp.where(is_doub, val * u2_frac, val)
        rowsumE = jnp.sum(probsE, axis=-1)
        ndivE = jnp.where(is_doub, 0, 1).astype(jnp.int32)
        valE_in = jnp.where(is_doub & (rowsumE <= 0), 0.0, val)
        maskE = is_doub[:, None] & (probsE > 0)
        val, parent, sub, _, ovf = _stage(
            4, valE_in, ndivE, jnp.where(maskE, probsE, 0.0), m_samp, rns,
            keys5, 1,
        )
        overflow |= ovf
        live = parent >= 0
        pidx = jnp.where(live, parent, 0)
        (det_idx, d_i, o1_idx, o2_idx, s_elec, virt_rank, u1_slot), prow = (
            remap(
                pidx,
                [det_idx, is_doub.astype(jnp.int32), o1_idx, o2_idx, s_elec,
                 virt_rank, u1_slot], prow,
            )
        )
        is_doub = (d_i != 0) & live
        is_sing = (~is_doub) & live
        u2_slot = jnp.where(is_doub, sub, 0)

        # ---------------- finalize ----------------
        s_occ, s_keys, occ_bits = unpack_prow(prow)
        pval = vals[det_idx]  # one parent-value gather serves sign AND ini
        sign = jnp.sign(pval)

        # doubles
        o1_orb = kernels.take_along_small(s_occ, o1_idx)
        o2_orb = kernels.take_along_small(s_occ, o2_idx)
        spin1 = o1_orb // n_orb
        spin2 = o2_orb // n_orb
        spin_bits1 = jnp.where(
            (spin1 == 0)[:, None], occ_bits[:, :n_orb], occ_bits[:, n_orb : 2 * n_orb]
        )
        virts = hb.virtual_slots(n_orb, n_elec, spin_bits1)
        u1_sp = kernels.take_along_small(
            virts, jnp.clip(u1_slot, 0, n_virt - 1)
        )
        u1_orb = jnp.where(u1_sp < n_orb, u1_sp + spin1 * n_orb, 0)
        g = (
            kernels.take_small(symm, o1_orb % n_orb)
            ^ kernels.take_small(symm, o2_orb % n_orb)
            ^ kernels.take_small(symm, u1_orb % n_orb)
        )
        u2_sp = kernels.take_along_small(
            kernels.take_rows_small(lookup, g),
            jnp.clip(u2_slot, 0, lookup.shape[1] - 1),
        )
        u2_valid = u2_sp < n_orb
        u2_orb = jnp.where(u2_valid, u2_sp, 0) + spin2 * n_orb
        u2_occupied = hb.dets_read(occ_bits, u2_orb[:, None], 2 * n_orb)[:, 0]
        doub_ok = is_doub & u2_valid & ~u2_occupied & (u1_orb != u2_orb)

        # canonical orbital ordering (o1<o2, u1<u2)
        o_lo = jnp.minimum(o1_orb, o2_orb)
        o_hi = jnp.maximum(o1_orb, o2_orb)
        u_lo = jnp.minimum(u1_orb, u2_orb)
        u_hi = jnp.maximum(u1_orb, u2_orb)

        if unnorm:
            tot = hb.unnorm_weight(tens, n_orb, o_lo, o_hi, u_lo, u_hi)
            dval = val / jnp.maximum(tot, 1e-300)
        else:
            tot = hb.norm_weight(
                tens, n_orb, n_elec, symm, lookup, s_occ, occ_bits,
                o_lo, o_hi, u_lo, u_hi,
            )
            dval = val / jnp.maximum(tot, 1e-300)
        dmel = mol.doub_matr_el(ham, o_lo, o_hi, u_lo, u_hi)
        dwords, dsign = dets.double_parity(s_keys, o_lo, o_hi, u_lo, u_hi)
        damp = jnp.where(
            doub_ok & (tot > 0),
            h_fac * dmel * dsign * sign * dval / p_doub,
            0.0,
        )

        # singles
        counts = hb.unocc_symm_counts(
            n_orb, n_elec, symm, jnp.asarray(syminfo.counts), s_occ
        )
        per_elec, n_occ_allowed = hb.sing_allowed(n_orb, n_elec, symm, counts, s_occ)
        so_orb = kernels.take_along_small(s_occ, s_elec)
        so_spin = so_orb // n_orb
        gs = kernels.take_small(symm, so_orb % n_orb)
        orb_row = kernels.take_rows_small(lookup, gs)  # (S, K) same-irrep spatial orbitals
        cand_bit = orb_row + so_spin[:, None] * n_orb
        cand_unocc = (orb_row < n_orb) & ~hb.dets_read(
            occ_bits, jnp.clip(cand_bit, 0, 2 * n_orb - 1), 2 * n_orb
        )
        su_col, su_found = _rank_to_index(cand_unocc, virt_rank)
        su_sp = kernels.take_along_small(
            orb_row, jnp.clip(su_col, 0, orb_row.shape[1] - 1)
        )
        su_orb = jnp.where(su_found & (su_sp < n_orb), su_sp + so_spin * n_orb, 0)
        sing_ok = is_sing & su_found & (su_sp < n_orb)
        s_nvirt = kernels.take_along_small(per_elec, s_elec)
        smel = mol.sing_matr_el(ham, so_orb, su_orb, s_occ)
        swords, ssign = dets.single_parity(s_keys, so_orb, su_orb)
        samp = jnp.where(
            sing_ok,
            h_fac
            * smel
            * ssign
            * sign
            * val
            * n_occ_allowed
            * s_nvirt
            / (1.0 - p_doub),
            0.0,
        )

        if cfg.spin_parity:
            # time-reversal folding of the sampled excitations
            # (apply_HBPP_piv spin_parity branch, heat_bathPP.cpp:1326-1407):
            # combine direct + reverse elements and selection weights
            from fries_tpu.ops import time_reversal as tr_mod

            direct_mel = jnp.where(is_doub, dmel * dsign, smel * ssign)
            w_doub = jnp.maximum(tot, 1e-300) * p_doub
            w_sing = (1.0 - p_doub) / jnp.maximum(
                (n_occ_allowed * s_nvirt).astype(jnp.float64), 1e-300
            )
            direct_w = jnp.where(is_doub, w_doub, w_sing)
            ok = jnp.where(is_doub, doub_ok & (tot > 0), sing_ok)
            target0 = jnp.where(is_doub[:, None], dwords, swords)
            t_words, t_mel, t_w, t_keep = tr_mod.adjust_sampled(
                ham, tens, symm, counts, n_occ_allowed, s_keys, s_occ,
                occ_bits, target0, direct_mel, direct_w, cfg.spin_parity,
                p_doub, unnorm,
            )
            amps = jnp.where(
                ok & t_keep & live,
                h_fac * sign * val * t_mel / jnp.maximum(t_w, 1e-300),
                0.0,
            )
            new_words = t_words
        else:
            amps = jnp.where(is_doub, damp, samp)
            new_words = jnp.where(is_doub[:, None], dwords, swords)
        new_words = jnp.where(
            (amps != 0)[:, None], new_words, jnp.asarray(dets.invalid_det(ham.n_words))
        )
        ini_cut = cfg.init_thresh if thresh is None else thresh
        ini = jnp.abs(pval) >= ini_cut

        if determ is not None:
            # exact multiplication by the dense H block
            # (frisys_mol.cpp:479-485): amp = h_fac * H_elem * v[from]
            v_from = jnp.where(dfound, vals0_full[dpos], 0.0)[determ["from"]]
            d_amp = h_fac * determ["amp"] * v_from
            d_words = jnp.where(
                (d_amp != 0)[:, None],
                determ["words"],
                jnp.asarray(dets.invalid_det(ham.n_words)),
            )
            new_words = jnp.concatenate([new_words, d_words])
            amps = jnp.concatenate([amps, d_amp])
            ini = jnp.concatenate(
                [ini, jnp.ones((d_amp.shape[0],), jnp.bool_)]
            )
        return new_words, amps, ini

    return spawn


def make_diag_fn(ham: mol.MolecularHamiltonian, e_ref, spin_parity: int = 0):
    '''Diagonal closure for the power core: diag_matrel recomputed from keys
    per iteration (replaces the DistVec matr_el_ cache), with the folded-
    basis correction under time reversal (tr_diag, subsp_mol.cpp:122-147).'''
    def diag_fn(keys):
        occ = dets.occ_list(keys, ham.n_bits, ham.n_elec)
        d = mol.diag_matrel_chunked(ham, occ) - e_ref
        if spin_parity:
            from fries_tpu.ops import time_reversal as tr_mod

            delta, forbid = tr_mod.tr_diag(ham, keys, occ, spin_parity)
            d = jnp.where(forbid, d, d + delta)
        return d

    return diag_fn


def hf_p_doub(ham: mol.MolecularHamiltonian, syminfo: mol.SymmInfo):
    """p_doub from the HF determinant's excitation counts
    (frisys_mol.cpp:216-220)."""
    tmpl = mol.ExcitationTemplate.build(ham.n_orb, ham.n_elec)
    hf_words, hf_occ, _ = mol.hf_reference(ham)
    _, _, _, _, dmask = mol.enumerate_doubles(ham, tmpl, hf_words[None], hf_occ[None])
    n_doub = int(jnp.sum(dmask))
    counts = hb.unocc_symm_counts(
        ham.n_orb, ham.n_elec, jnp.asarray(syminfo.symm),
        jnp.asarray(syminfo.counts), hf_occ[None],
    )
    per_elec, _ = hb.sing_allowed(
        ham.n_orb, ham.n_elec, jnp.asarray(syminfo.symm), counts, hf_occ[None]
    )
    n_sing = int(jnp.sum(per_elec))
    return n_doub / (n_doub + n_sing)


def build_determ_block(ham: mol.MolecularHamiltonian, determ_keys):
    """Precompute the dense (deterministic-subspace) H block: every
    symmetry-allowed excitation from each member determinant with its
    sign-carrying matrix element (frisys_mol.cpp:347-401)."""
    determ_keys = jnp.asarray(determ_keys)
    d = determ_keys.shape[0]
    occ = dets.occ_list(determ_keys, ham.n_bits, ham.n_elec)
    tmpl = mol.ExcitationTemplate.build(ham.n_orb, ham.n_elec)
    w, amp, nocc = mol.exact_offdiag_batch(
        ham, tmpl, determ_keys, occ, jnp.ones((d,)), 1.0
    )
    nc = amp.shape[1]
    flat_w = np.asarray(w.reshape(-1, ham.n_words))
    flat_amp = np.asarray(amp.reshape(-1))
    from_idx = np.repeat(np.arange(d, dtype=np.int32), nc)
    # compact ONCE at build time: the template enumerates every (occ-pair,
    # virt-pair) slot, so the flat stream is mostly zero-amplitude rows -
    # carrying them into every per-iteration merge multiplies the sort
    # stream by the dead fraction (measured: the real-N2 flagship block is
    # ~4.7M template slots for ~0.6M nonzero elements)
    live = flat_amp != 0
    n_elements = int(live.sum())
    return {
        "keys": determ_keys,
        "words": jnp.asarray(flat_w[live]),
        "amp": jnp.asarray(flat_amp[live]),
        "from": jnp.asarray(from_idx[live]),
        "n_elements": n_elements,
    }


def compute_htrial(ham: mol.MolecularHamiltonian, trial_keys, trial_vals,
                   e_ref=None):
    """(keys, vals) of (H - hf_en)|trial> by exact application + diagonal
    (frisys_mol.cpp:205-214).  ``e_ref`` overrides the HF diagonal shift
    (--ham_shift)."""
    trial_keys = np.asarray(trial_keys)
    trial_vals = np.asarray(trial_vals)
    live = trial_vals != 0
    tk = trial_keys[live]
    tv = trial_vals[live]
    occ = dets.occ_list(jnp.asarray(tk), ham.n_bits, ham.n_elec)
    tmpl = mol.ExcitationTemplate.build(ham.n_orb, ham.n_elec)
    _, _, hf_en = mol.hf_reference(ham)
    if e_ref is not None:
        hf_en = float(e_ref)
    # chunk the exact application: at production trial sizes (e.g. the
    # ~2k-det N2 CISD trial x ~24k candidates) a single batch exhausts device memory
    chunk = max(1, min(len(tv), (1 << 22) // max(tmpl.n_doub, 1) + 1))
    w_parts, a_parts = [], []
    for s in range(0, len(tv), chunk):
        e = min(s + chunk, len(tv))
        w, amp, _ = mol.exact_offdiag_batch(
            ham, tmpl, jnp.asarray(tk[s:e]), occ[s:e],
            jnp.asarray(tv[s:e]), 1.0
        )
        w = np.asarray(w.reshape(-1, ham.n_words))
        amp = np.asarray(amp.reshape(-1))
        live_c = amp != 0
        w_parts.append(w[live_c])
        a_parts.append(amp[live_c])
    diag = np.asarray(mol.diag_matrel(ham, occ)) - float(hf_en)
    keys_all = np.concatenate([tk] + w_parts)
    vals_all = np.concatenate([tv * diag] + a_parts)
    if dets.packable(ham.n_words):
        packed = np.asarray(dets.pack_key(jnp.asarray(keys_all)))
        uniq, first, inv = np.unique(packed, return_index=True,
                                     return_inverse=True)
        summed = np.bincount(inv, weights=vals_all, minlength=len(uniq))
        return keys_all[first].astype(np.uint32), summed
    merged = {}
    for kk, vv in zip(map(tuple, keys_all), vals_all):
        merged[kk] = merged.get(kk, 0.0) + vv
    return (
        np.asarray(list(merged.keys()), np.uint32),
        np.asarray(list(merged.values())),
    )


def build(ham: mol.MolecularHamiltonian, cfg: FrisysConfig, seed: int,
          init_val: float = 100.0, determ_keys=None, trial=None, init_vec=None,
          e_ref=None):
    """Assemble the flagship frisys workload: HB-PP spawner + power core +
    trial / H-trial estimator vectors.  Returns (step, run_steps, state,
    aux); aux["protected_keys"] carries the deterministic subspace for the
    power core when ``determ_keys`` is given.

    trial: optional (keys (N, W), vals (N,)) estimator trial vector
      (frisys_mol.cpp:159-214; default: the HF unit vector).
    init_vec: optional (keys, vals) starting vector (--ini_vec,
      frisys_mol.cpp:264-275; default: HF * init_val).
    e_ref: optional diagonal shift overriding the HF diagonal energy
      (--ham_shift, frisys_mol.cpp:94-99: hf_en = ham_shift - core_en).
    """
    syminfo = mol.SymmInfo.build(np.asarray(ham.symm))
    tens = hb.setup(ham)
    p_doub = hf_p_doub(ham, syminfo)
    hf_words, hf_occ, hf_en = mol.hf_reference(ham)
    if e_ref is not None:
        hf_en = float(e_ref)

    determ = build_determ_block(ham, determ_keys) if determ_keys is not None else None
    spawn = make_hbpp_spawner(ham, tens, syminfo, p_doub, cfg, hf_en, determ=determ)
    diag_fn = make_diag_fn(ham, hf_en, cfg.spin_parity)
    step, run_steps = power.make_stepper(
        spawn, diag_fn, cfg.power(), estimator="direct"
    )

    if trial is None:
        trial_keys = np.asarray(hf_words)[None]
        trial_vals = np.ones((1,))
    else:
        trial_keys, trial_vals = np.asarray(trial[0]), np.asarray(trial[1])
    htrial_keys, htrial_vals = compute_htrial(ham, trial_keys, trial_vals,
                                              e_ref=hf_en)
    aux = {
        "e_ref": hf_en,
        "num_keys": jnp.asarray(htrial_keys),
        "num_vals": jnp.asarray(htrial_vals),
        "den_keys": jnp.asarray(trial_keys),
        "den_vals": jnp.asarray(trial_vals),
        "ref_key": hf_words,
        "p_doub": p_doub,
        "protected_keys": determ["keys"] if determ is not None else None,
    }

    a = ar.make(cfg.capacity, ham.n_words, 2)
    if init_vec is not None:
        ik = np.asarray(init_vec[0])
        iv = np.asarray(init_vec[1])
        a = ar.from_unsorted(
            a, jnp.asarray(ik),
            jnp.stack([jnp.asarray(iv), jnp.zeros(len(iv))]),
        )
        state = power.fresh_state(a, seed)
        return step, run_steps, state, aux
    if determ is not None:
        # seed the vector with the deterministic-subspace members so the
        # dense block is live from the start (reference init_dense,
        # vec_utils.hpp:858-897); HF keeps its initial amplitude
        dkeys = np.asarray(determ["keys"])
        init_keys = [np.asarray(hf_words)]
        init_vals = [init_val]
        for row in dkeys:
            if not np.array_equal(row, np.asarray(hf_words)):
                init_keys.append(row)
                init_vals.append(0.0)
        init_keys = jnp.asarray(np.stack(init_keys))
        a = ar.from_unsorted(
            a, init_keys,
            jnp.stack([jnp.asarray(init_vals), jnp.zeros(len(init_vals))]),
        )
    else:
        a = ar.from_unsorted(
            a, hf_words[None], jnp.asarray([[init_val], [0.0]]),
        )
    state = power.fresh_state(a, seed)
    return step, run_steps, state, aux


def build_sharded(ham: mol.MolecularHamiltonian, cfg: FrisysConfig, seed: int,
                  mesh, init_val: float = 100.0, trial=None, init_vec=None,
                  e_ref=None, determ_keys=None):
    """Multi-chip frisys: hash-sharded arena over a 1-D mesh with all-to-all
    spawn exchange (the device-mesh analogue of the reference's MPI layout,
    SURVEY.md section 5.8).  ``cfg`` must carry axis_name/n_shards matching
    ``mesh``; capacity and budgets are per shard / global respectively.

    Returns (sharded_step, sharded_run, state, aux).
    """
    from fries_tpu import parallel

    assert cfg.axis_name and cfg.n_shards == mesh.devices.size
    syminfo = mol.SymmInfo.build(np.asarray(ham.symm))
    tens = hb.setup(ham)
    p_doub = hf_p_doub(ham, syminfo)
    hf_words, hf_occ, hf_en = mol.hf_reference(ham)
    if e_ref is not None:
        hf_en = float(e_ref)

    # semistochastic dense block: replicated across shards, members applied
    # exactly by whichever shard owns them (frisys_mol.cpp:347-401 + MPI)
    determ = build_determ_block(ham, determ_keys) if determ_keys is not None else None
    spawn = make_hbpp_spawner(ham, tens, syminfo, p_doub, cfg, hf_en,
                              determ=determ)
    diag_fn = make_diag_fn(ham, hf_en, cfg.spin_parity)
    step, run_steps = power.make_stepper(
        spawn, diag_fn, cfg.power(), estimator="direct"
    )
    sharded_step, sharded_run = parallel.shard_stepper(
        step, run_steps, mesh, cfg.axis_name
    )

    if trial is None:
        trial_keys = np.asarray(hf_words)[None]
        trial_vals = np.ones((1,))
    else:
        trial_keys, trial_vals = np.asarray(trial[0]), np.asarray(trial[1])
    htrial_keys, htrial_vals = compute_htrial(ham, trial_keys, trial_vals,
                                              e_ref=hf_en)

    if init_vec is not None:
        ik = np.asarray(init_vec[0])
        iv = np.asarray(init_vec[1])
        init_keys = jnp.asarray(ik)
        init_vals = jnp.stack([jnp.asarray(iv), jnp.zeros(len(iv))])
    elif determ is not None:
        # seed the dense-subspace members (init_dense, vec_utils.hpp:858-897)
        dkeys = np.asarray(determ["keys"])
        ik = [np.asarray(hf_words)]
        iv = [init_val]
        for row in dkeys:
            if not np.array_equal(row, np.asarray(hf_words)):
                ik.append(row)
                iv.append(0.0)
        init_keys = jnp.asarray(np.stack(ik))
        init_vals = jnp.stack(
            [jnp.asarray(iv), jnp.zeros(len(iv))]
        )
    else:
        init_keys = hf_words[None]
        init_vals = jnp.asarray([[init_val], [0.0]])
    state = parallel.sharded_state(
        init_keys, init_vals, cfg.n_shards, cfg.capacity, seed,
    )
    aux = {
        "e_ref": hf_en,
        "num_keys": jnp.asarray(htrial_keys),
        "num_vals": jnp.asarray(htrial_vals),
        "den_keys": jnp.asarray(trial_keys),
        "den_vals": jnp.asarray(trial_vals),
        "ref_key": hf_words,
        "p_doub": p_doub,
        "protected_keys": determ["keys"] if determ is not None else None,
    }
    return sharded_step, sharded_run, state, aux
