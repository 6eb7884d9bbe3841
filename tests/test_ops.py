"""Device operator tests: the XLA CSR / ELL kernels and the SELL-C-σ
operator vs the numpy fp64 golden reference — the differential strategy of SURVEY §4,
automated."""

import jax.numpy as jnp
import numpy as np
import pytest

from sparsematrixvectormultiplication_tpu import CSRMatrix, HLLMatrix, SellMatrix
from sparsematrixvectormultiplication_tpu.ops.sell import (
    device_put_sell,
    sell_spmv,
)
from sparsematrixvectormultiplication_tpu.ops.xla import (
    device_put_csr,
    device_put_ell,
)
from sparsematrixvectormultiplication_tpu.utils.validation import (
    difference_metrics,
    difference_metrics_mean,
)


@pytest.fixture
def problem(make_random_coo):
    coo, s = make_random_coo(3000, 2500, 0.01)
    x = np.random.default_rng(7).standard_normal(2500)
    return coo, s, x


def test_xla_csr_f64(problem):
    coo, s, x = problem
    dcsr = device_put_csr(CSRMatrix.from_coo(coo))
    y = np.asarray(dcsr.spmv(jnp.asarray(x)))
    assert np.allclose(y, s.tocsr() @ x, rtol=1e-12, atol=1e-12)


def test_xla_ell_f64(problem):
    coo, s, x = problem
    dell = device_put_ell(HLLMatrix.from_coo(coo))
    y = np.asarray(dell.spmv(jnp.asarray(x)))
    assert np.allclose(y, s.tocsr() @ x, rtol=1e-12, atol=1e-12)


def test_xla_sell_f64(problem):
    coo, s, x = problem
    dsell = device_put_sell(SellMatrix.from_coo(coo), jnp.float64)
    y = np.asarray(sell_spmv(dsell, jnp.asarray(x)))
    assert np.allclose(y, s.tocsr() @ x, rtol=1e-12, atol=1e-12)


def test_sell_f32_accuracy(problem):
    coo, s, x = problem
    dsell = device_put_sell(SellMatrix.from_coo(coo), jnp.float32)
    y = np.asarray(sell_spmv(dsell, jnp.asarray(x, jnp.float32)))
    dm = difference_metrics_mean(s.tocsr() @ x, y)
    assert dm.mean_rel_err < 1e-5  # f32 with ~25 nnz/row


@pytest.mark.parametrize("shape,density", [
    ((1024, 1024), 0.02),
    ((1030, 777), 0.03),     # partial last slice, odd N
    ((100, 100), 0.05),      # single slice, tiny
    ((4096, 131072), 0.0005),  # wide: x far larger than any slice's reach
])
def test_sell_shapes(make_random_coo, shape, density):
    coo, s = make_random_coo(*shape, density)
    x = np.random.default_rng(3).standard_normal(shape[1])
    dsell = device_put_sell(SellMatrix.from_coo(coo), jnp.float64)
    y = np.asarray(sell_spmv(dsell, jnp.asarray(x)))
    assert np.allclose(y, s.tocsr() @ x, rtol=1e-11, atol=1e-11)


def test_empty_matrix():
    from sparsematrixvectormultiplication_tpu import COOMatrix

    coo = COOMatrix(8, 8, np.zeros(0, np.int32), np.zeros(0, np.int32), np.zeros(0))
    dsell = device_put_sell(SellMatrix.from_coo(coo), jnp.float64)
    y = np.asarray(sell_spmv(dsell, jnp.ones(8)))
    assert y.shape == (8,) and np.allclose(y, 0.0)


def test_validation_metrics_reference_formula():
    ref = np.array([1.0, 2.0, 3.0, 0.0])
    res = np.array([1.0, 2.1, 3.0, 0.5])
    dm = difference_metrics(ref, res, abs_tol=1e-5, rel_tol=1e-4)
    # entries 1 and 3 differ significantly
    assert dm.significant_diffs == 2
    exp1 = 0.1 / 2.1
    exp3 = 0.5 / 0.5
    assert np.isclose(dm.mean_rel_err, (exp1 + exp3) / 2)
    assert dm.mean_abs_err == 0.0  # reference hardwires 0

    dm2 = difference_metrics_mean(ref, res)
    assert np.isclose(dm2.mean_abs_err, (0.0 + 0.1 + 0.0 + 0.5) / 4)


def test_validation_identical_is_zero():
    y = np.random.default_rng(0).standard_normal(100)
    dm = difference_metrics(y, y.copy())
    assert dm.significant_diffs == 0 and dm.mean_rel_err == 0.0


def test_sell_multi_bin():
    """Matrix engineered to span several widths: every bin scatters its
    sums into the output the previous bins wrote."""
    import scipy.sparse as sp

    from sparsematrixvectormultiplication_tpu import COOMatrix

    rng = np.random.default_rng(5)
    M, N = 4096, 4096
    rows, cols = [], []
    for g, k in [(0, 2), (1, 30), (2, 100), (3, 7)]:
        for r in range(g * 1024, (g + 1) * 1024, 16):
            rows.extend([r] * k)
            cols.extend(rng.choice(N, size=k, replace=False).tolist())
    s = sp.coo_matrix((rng.standard_normal(len(rows)), (rows, cols)),
                      shape=(M, N))
    sell = SellMatrix.from_coo(COOMatrix(M, N, s.row, s.col, s.data))
    assert len(sell.bins) >= 3
    x = rng.standard_normal(N)
    y = np.asarray(sell_spmv(device_put_sell(sell, jnp.float64),
                                    jnp.asarray(x)))
    assert np.allclose(y, s.tocsr() @ x, rtol=1e-11, atol=1e-11)


def test_csr_spmm_xla_matches_scipy(rng):
    """The multi-RHS CSR SpMM (the solvers' matmat) against scipy."""
    from sparsematrixvectormultiplication_tpu.models import synthetic as syn
    from sparsematrixvectormultiplication_tpu.ops.xla import csr_spmm

    csr = CSRMatrix.from_coo(syn.dense_rows_mix(400, seed=10))
    X = rng.standard_normal((csr.ncols, 6))
    y = np.asarray(csr_spmm(
        jnp.asarray(csr.values), jnp.asarray(csr.col_idx),
        jnp.asarray(csr.row_ids()), jnp.asarray(X), nrows=csr.nrows))
    np.testing.assert_allclose(y, csr.to_scipy() @ X, rtol=1e-10, atol=1e-10)
