"""Block subspace iteration (solvers/subspace.py): top-k eigenpairs with
one multi-RHS SpMM per step."""

import numpy as np
import jax.numpy as jnp

from sparsematrixvectormultiplication_tpu.formats.coo import COOMatrix
from sparsematrixvectormultiplication_tpu.formats.csr import CSRMatrix
from sparsematrixvectormultiplication_tpu.ops.xla import (
    csr_spmm,
    device_put_csr,
)
from sparsematrixvectormultiplication_tpu.solvers import subspace_iteration


def _gapped_sym(n, k):
    """Sparse symmetric matrix with a strong spectral gap: dominant
    diagonal entries 2k, 2k-2, ..., 2 on the first k rows, a weak
    tridiagonal coupling elsewhere — top-k eigenvalues are within O(0.01)
    of the big diagonal entries and well separated (power-type methods
    converge fast)."""
    diag = np.full(n, 0.5)
    diag[:k] = 2.0 * np.arange(k, 0, -1)
    rows = [np.arange(n)]
    cols = [np.arange(n)]
    vals = [diag]
    off = np.full(n - 1, 0.01)
    rows += [np.arange(n - 1), np.arange(1, n)]
    cols += [np.arange(1, n), np.arange(n - 1)]
    vals += [off, off]
    coo = COOMatrix(n, n, np.concatenate(rows).astype(np.int64),
                    np.concatenate(cols).astype(np.int64),
                    np.concatenate(vals))
    return CSRMatrix.from_coo(coo)


def test_subspace_matches_dense_eigvals():
    n, k = 512, 4
    csr = _gapped_sym(n, k)
    d = device_put_csr(csr, dtype=jnp.float32)

    def matmat(V):
        return csr_spmm(d.values, d.col_idx, d.row_ids, V, nrows=n)

    Q0 = jnp.asarray(
        np.random.default_rng(0).standard_normal((n, k)), jnp.float32)
    w, Q, iters, res = subspace_iteration(matmat, Q0, tol=1e-5,
                                          maxiter=300)
    # dense ground truth
    A = np.zeros((n, n))
    A[csr_rows(csr), csr.col_idx] = csr.values
    dense = np.sort(np.linalg.eigvalsh(A))[::-1]
    np.testing.assert_allclose(np.sort(np.asarray(w))[::-1], dense[:k],
                               rtol=1e-4)
    assert float(res) <= 1e-5
    assert int(iters) < 300
    QtQ = np.asarray(Q).T @ np.asarray(Q)
    np.testing.assert_allclose(QtQ, np.eye(k), atol=1e-4)


def csr_rows(csr):
    return np.repeat(np.arange(csr.nrows), np.diff(csr.row_ptr))


def test_subspace_dense_operator():
    """Any jit matmat works — dense A as the simplest case."""
    n, k = 256, 2
    csr = _gapped_sym(n, k)
    A = np.zeros((n, n))
    A[csr_rows(csr), csr.col_idx] = csr.values
    Aj = jnp.asarray(A, jnp.float32)
    w, Q, iters, res = subspace_iteration(
        lambda V: Aj @ V,
        jnp.asarray(np.random.default_rng(1).standard_normal((n, k)),
                    jnp.float32),
        tol=1e-5, maxiter=300)
    dense = np.sort(np.linalg.eigvalsh(A))[::-1]
    np.testing.assert_allclose(np.sort(np.asarray(w))[::-1], dense[:k],
                               rtol=1e-4)
    assert int(iters) < 300
