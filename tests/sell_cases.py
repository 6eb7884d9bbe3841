"""Matrices and the error bound shared by the SELL operator tests.

Every synthetic family of ``models/synthetic.py`` at a small size, plus the
edge cases a slot-major slicing can get wrong."""

import numpy as np

from sparsematrixvectormultiplication_tpu.formats.coo import COOMatrix
from sparsematrixvectormultiplication_tpu.formats.csr import CSRMatrix
from sparsematrixvectormultiplication_tpu.models import synthetic as syn

FAMILIES = {
    "random_general": lambda: syn.random_general(600, 500, 0.01, seed=1),
    "random_symmetric": lambda: syn.random_symmetric(500, 0.01, seed=2),
    "random_pattern": lambda: syn.random_pattern(400, 700, 0.01, seed=3),
    "banded": lambda: syn.banded(1000, 9, 40, seed=4),
    "fem_3d": lambda: syn.fem_3d(5, 5, 5, dof=3, seed=5),
    "hpcg_stencil": lambda: syn.hpcg_stencil(6, 6, 6),
    "power_law": lambda: syn.power_law(2000, 4, seed=6),
    "webbase_like": lambda: syn.webbase_like(2000, 3, seed=7),
    "road_network": lambda: syn.road_network(3000, seed=8),
    "diagonal_dominant": lambda: syn.diagonal_dominant(1500, 7, seed=9),
    "dense_rows_mix": lambda: syn.dense_rows_mix(2000, seed=10),
    "kkt_saddle": lambda: syn.kkt_saddle(8, seed=11),
    "copurchase_graph": lambda: syn.copurchase_graph(3000, seed=12),
    "econ_sectors": lambda: syn.econ_sectors(3000, sector=100, seed=13),
    "unstructured_fem": lambda: syn.unstructured_fem(1000, seed=14),
    "cfd_multidof": lambda: syn.cfd_multidof(12, 12, dof=5, seed=15),
}


def _coo(nrows, ncols, rows, cols, seed=0):
    rows = np.asarray(rows, np.int64)
    cols = np.asarray(cols, np.int64)
    vals = np.random.default_rng(seed).standard_normal(rows.size)
    return COOMatrix(nrows, ncols, rows, cols, vals).sum_duplicates()


def _empty_rows():
    rng = np.random.default_rng(20)
    rows = rng.choice(np.arange(0, 400, 3), 900)   # two rows in three empty
    return _coo(400, 300, rows, rng.integers(0, 300, rows.size), seed=20)


def _heavy_row():
    rng = np.random.default_rng(21)
    rows = np.concatenate([np.full(5000, 7), rng.integers(0, 500, 1500)])
    return _coo(500, 6000, rows, rng.integers(0, 6000, rows.size), seed=21)


def _sigma_mix():
    """Rows of very different lengths interleaved, so sorting pays."""
    rng = np.random.default_rng(22)
    lens = np.where(np.arange(2048) % 2 == 0, 1, 40)
    rows = np.repeat(np.arange(2048), lens)
    return _coo(2048, 2048, rows, rng.integers(0, 2048, rows.size), seed=22)


EDGES = {
    "empty_matrix": lambda: COOMatrix(8, 8, np.zeros(0, np.int32),
                                      np.zeros(0, np.int32), np.zeros(0)),
    "no_rows": lambda: COOMatrix(0, 5, np.zeros(0, np.int32),
                                 np.zeros(0, np.int32), np.zeros(0)),
    "no_columns": lambda: COOMatrix(5, 0, np.zeros(0, np.int32),
                                    np.zeros(0, np.int32), np.zeros(0)),
    "empty_rows": _empty_rows,
    "rows_not_multiple_of_c": lambda: syn.random_general(130, 90, 0.05,
                                                         seed=23),
    "wide": lambda: syn.random_general(50, 3000, 0.01, seed=24),
    "tall": lambda: syn.random_general(3000, 40, 0.05, seed=25),
    "single_heavy_row": _heavy_row,
    "sigma_permutation": _sigma_mix,
}

DTYPES = ("float32", "bfloat16", "float64")


def oracle_and_bound(csr: CSRMatrix, x: np.ndarray, dtype: str):
    """fp64 oracle and a per-row bound on ``|y - oracle|``.

    bf16 values are compared with the oracle on the bf16-rounded values.
    The bound is twice the forward-error bound of a k-term dot product,
    ``(k + 2) eps (|A| |x|)`` with ``k`` the longest row and ``eps`` the
    accumulation type's machine epsilon (+2 covers rounding the inputs)."""
    import jax.numpy as jnp

    vals = csr.values
    if dtype == "bfloat16":
        vals = vals.astype(jnp.bfloat16).astype(np.float64)
    q = CSRMatrix(csr.nrows, csr.ncols, csr.row_ptr, csr.col_idx, vals)
    k = int(csr.row_nnz().max(initial=0))
    eps = np.finfo(np.float64 if dtype == "float64" else np.float32).eps
    scale = CSRMatrix(csr.nrows, csr.ncols, csr.row_ptr, csr.col_idx,
                      np.abs(vals)).spmv(np.abs(x))
    return q.spmv(x), 2 * (k + 2) * eps * scale


def check_product(y, csr: CSRMatrix, x: np.ndarray, dtype: str):
    ref, bound = oracle_and_bound(csr, x, dtype)
    y = np.asarray(y, np.float64)
    assert y.shape == (csr.nrows,)
    excess = np.abs(y - ref) - bound
    assert np.all(excess <= 0), (
        f"{int((excess > 0).sum())} rows beyond the bound, worst "
        f"{float(excess.max()):.3e}")
