"""Dense linear algebra for subspace iteration.

Re-implements the reference LAPACK wrapper layer (LAPACK/lapack_wrappers.
{hpp,cpp}) on jnp/scipy; the matrices involved are n_trial x n_trial
(n_trial <= ~10), so host round trips are free and device QR is trivial.

  get_svals             <- dgesvd      (lapack_wrappers.cpp:12-38)
  gen_eig               <- dggev       (:40-69, generalized h x = lambda d x)
  inv                   <- dgetrf/i    (:71-88)
  inv_triangular_upper  <- invu_inplace (:90-...)
  inv_r_factor          <- invr_inplace (QR then R^-1, used for subspace
                           orthonormalization restarts, subsp_mol.cpp:480-510)
  qr                    <- dgeqrf+dorgqr (gen_qr, :181-209)
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp
import jax.scipy.linalg as jsl


def get_svals(mat):
    return jnp.linalg.svd(mat, compute_uv=False)


def gen_eig(h_mat, d_mat):
    """Real generalized eigenproblem h x = lambda d x (host-side scipy;
    non-symmetric like the reference's dggev).  Returns (evals, evecs)
    sorted by real part."""
    from scipy.linalg import eig

    evals, evecs = eig(np.asarray(h_mat), np.asarray(d_mat))
    order = np.argsort(evals.real)
    return evals[order], evecs[:, order]


def inv(mat):
    return jnp.linalg.inv(mat)


def inv_triangular_upper(mat):
    """Inverse of an upper-triangular matrix by explicit back-substitution.

    Unrolled over the (static, <= ~10) trial count: plain elementwise ops +
    tiny matvecs inside the jitted subspace step."""
    t = mat.shape[0]
    if t == 1:
        return 1.0 / mat
    inv_diag = 1.0 / jnp.diagonal(mat)
    eye = jnp.eye(t, dtype=mat.dtype)
    x = jnp.zeros_like(mat)
    for i in reversed(range(t)):
        # row i of X: (e_i - R[i, i+1:] @ X[i+1:, :]) / R[i, i]
        acc = eye[i] - mat[i, i + 1:] @ x[i + 1:, :]
        x = x.at[i].set(acc * inv_diag[i])
    return x


def inv_r_factor(mat):
    """R^-1 from the QR factorization of ``mat`` (reference invr_inplace):
    multiplying a vector block by R^-1 orthonormalizes it in the QR sense."""
    _, r = jnp.linalg.qr(mat)
    return inv_triangular_upper(r)


def qr(mat):
    return jnp.linalg.qr(mat)


def lanczos_ground_state(matvec, dim: int, m: int = 80, v0=None,
                         seed: int = 0, tol: float = 1e-10):
    """Matrix-free Lanczos ground-state energy of a symmetric operator.

    ``matvec(v) -> H v`` over f64 vectors of length ``dim``.  Full
    reorthogonalization (the Krylov basis is kept; dim * m floats), so the
    returned lowest Ritz value is reliable to ~machine precision for
    well-separated ground states.  Used by the production-scale accuracy
    anchor (tools/anchor_scale.py) where the FCI space is too large for the
    dense cross-checks in tests/dense_fci.py but H*v is cheap on the device.
    Returns (e0, ritz_vector_in_original_basis).
    """
    rng = np.random.default_rng(seed)
    if v0 is None:
        v0 = rng.standard_normal(dim)
    v = np.asarray(v0, np.float64)
    v /= np.linalg.norm(v)
    vs = [v]
    alphas, betas = [], []
    for j in range(m):
        w = np.asarray(matvec(jnp.asarray(vs[-1])), np.float64)
        a = float(vs[-1] @ w)
        alphas.append(a)
        w = w - a * vs[-1]
        if j > 0:
            w = w - betas[-1] * vs[-2]
        # full reorthogonalization (twice is enough)
        for _ in range(2):
            for u in vs:
                w = w - (u @ w) * u
        b = float(np.linalg.norm(w))
        if b < tol:
            break
        betas.append(b)
        vs.append(w / b)
    from scipy.linalg import eigh_tridiagonal

    evals, evecs = eigh_tridiagonal(alphas, betas[: len(alphas) - 1])
    coeff = evecs[:, 0]
    ritz = np.zeros(dim)
    for c, u in zip(coeff, vs):
        ritz += c * u
    return float(evals[0]), ritz


def subspace_energies(h_traj, d_traj, burn_in: int = 0):
    """Post-process subspace-iteration h/d matrix trajectories into state
    energies: averages the matrices over iterations (after burn_in) and
    solves the generalized eigenproblem (the reference's offline analysis of
    the npy/txt h_mat/d_mat outputs, docs/running.dox)."""
    h_avg = np.mean(np.asarray(h_traj)[burn_in:], axis=0)
    d_avg = np.mean(np.asarray(d_traj)[burn_in:], axis=0)
    evals, _ = gen_eig(h_avg, d_avg)
    return np.sort(evals.real)
