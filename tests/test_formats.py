"""Format conversion tests: COO -> CSR/HLL/SELL vs scipy (SURVEY §4 pytest
units for parser/converters against scipy + property tests)."""

import numpy as np
import pytest
import scipy.sparse as sp

from sparsematrixvectormultiplication_tpu import (
    COOMatrix,
    CSRMatrix,
    HLLMatrix,
    SellMatrix,
)


@pytest.mark.parametrize("shape,density", [
    ((100, 80), 0.05),
    ((1, 1), 1.0),
    ((1024, 1024), 0.01),
    ((1030, 999), 0.02),   # non-multiple of group size
    ((3, 5000), 0.01),     # wide
    ((5000, 3), 0.3),      # tall, dense-ish rows
])
def test_csr_matches_scipy(make_random_coo, shape, density):
    coo, s = make_random_coo(*shape, density)
    csr = CSRMatrix.from_coo(coo)
    ref = s.tocsr()
    ref.sort_indices()
    assert np.array_equal(csr.row_ptr, ref.indptr)
    assert np.array_equal(csr.col_idx, ref.indices)
    assert np.allclose(csr.values, ref.data)


def test_csr_rows_column_sorted(make_random_coo):
    coo, _ = make_random_coo(200, 150, 0.1)
    csr = CSRMatrix.from_coo(coo)
    for i in range(csr.nrows):
        cols = csr.col_idx[csr.row_ptr[i]:csr.row_ptr[i + 1]]
        assert np.all(np.diff(cols) > 0)


def test_csr_spmv_oracle(make_random_coo):
    coo, s = make_random_coo(300, 270, 0.05)
    csr = CSRMatrix.from_coo(coo)
    x = np.random.default_rng(0).standard_normal(270)
    assert np.allclose(csr.spmv(x), s.tocsr() @ x, rtol=1e-13, atol=1e-13)


def test_csr_empty_rows():
    # rows 0 and 2 empty
    coo = COOMatrix(4, 4, np.array([1, 3]), np.array([0, 2]), np.array([2.0, 5.0]))
    csr = CSRMatrix.from_coo(coo)
    y = csr.spmv(np.ones(4))
    assert np.allclose(y, [0.0, 2.0, 0.0, 5.0])


@pytest.mark.parametrize("hack", [1, 7, 32, 64])
def test_hll_roundtrip(make_random_coo, hack):
    coo, s = make_random_coo(217, 190, 0.06)
    hll = HLLMatrix.from_coo(coo, hack_size=hack)
    x = np.random.default_rng(0).standard_normal(190)
    assert np.allclose(hll.spmv(x), s.tocsr() @ x, rtol=1e-13, atol=1e-13)


def test_hll_reference_semantics(make_random_coo):
    """Per-block MAXNZ, row-major layout, last-valid-col padding
    (reference hll_matrix.c:86-92, :235, :241-246)."""
    coo, s = make_random_coo(70, 50, 0.1)
    csr = CSRMatrix.from_coo(coo)
    hll = HLLMatrix.from_csr(csr, hack_size=32)
    row_nnz = csr.row_nnz()
    for b in range(hll.num_blocks):
        ja, as_ = hll.block(b)
        r0 = b * hll.hack_size
        rows = ja.shape[0]
        expected_maxnz = max(1, int(row_nnz[r0:r0 + rows].max()))
        assert hll.maxnz[b] == expected_maxnz
        for lr in range(rows):
            r = r0 + lr
            k = int(row_nnz[r])
            cols = csr.col_idx[csr.row_ptr[r]:csr.row_ptr[r + 1]]
            vals = csr.values[csr.row_ptr[r]:csr.row_ptr[r + 1]]
            assert np.array_equal(ja[lr, :k], cols)
            assert np.allclose(as_[lr, :k], vals)
            pad_col = cols[-1] if k else 0
            assert np.all(ja[lr, k:] == pad_col)       # last valid col
            assert np.all(as_[lr, k:] == 0.0)          # zero values


def test_hll_rect_view(make_random_coo):
    coo, s = make_random_coo(100, 90, 0.05)
    hll = HLLMatrix.from_coo(coo)
    ja, as_ = hll.to_rect()
    x = np.random.default_rng(0).standard_normal(90)
    y = (as_ * x[ja]).sum(axis=1)[:100]
    assert np.allclose(y, s.tocsr() @ x, rtol=1e-13, atol=1e-13)
    assert ja.min() >= 0 and ja.max() < 90


def test_hll_rect_memory_guard(make_random_coo):
    coo, _ = make_random_coo(2000, 2000, 0.01)
    hll = HLLMatrix.from_coo(coo)
    with pytest.raises(MemoryError):
        hll.to_rect(max_elements=10)


@pytest.mark.parametrize("shape,density", [
    ((100, 80), 0.05),
    ((1024, 1024), 0.01),
    ((2050, 1999), 0.02),
    pytest.param((5000, 200000), 0.0005,  # wide: x far beyond any slice
                 marks=pytest.mark.slow),
])
def test_sell_spmv_oracle(make_random_coo, shape, density):
    coo, s = make_random_coo(*shape, density)
    sell = SellMatrix.from_coo(coo)
    x = np.random.default_rng(0).standard_normal(shape[1])
    assert np.allclose(sell.spmv(x), s.tocsr() @ x, rtol=1e-12, atol=1e-12)


def test_sell_padding_ratio_sane(make_random_coo):
    coo, _ = make_random_coo(4096, 4096, 0.01)  # ~41 nnz/row uniform
    sell = SellMatrix.from_coo(coo)
    assert sell.padding_ratio < 2.5


def test_duplicate_coalescing():
    coo = COOMatrix(
        3, 3,
        np.array([0, 0, 1, 1, 1]),
        np.array([1, 1, 2, 2, 0]),
        np.array([1.0, 2.0, 3.0, 4.0, 5.0]),
    )
    out = coo.sum_duplicates()
    assert out.nnz == 3
    dense = out.to_dense()
    assert dense[0, 1] == 3.0 and dense[1, 2] == 7.0 and dense[1, 0] == 5.0


def test_memory_stats(make_random_coo):
    coo, _ = make_random_coo(500, 400, 0.03)
    csr = CSRMatrix.from_coo(coo)
    st = csr.memory_stats()
    assert st["nnz"] == coo.nnz
    assert st["bytes_total"] == st["bytes_row_ptr"] + st["bytes_col_idx"] + st["bytes_values"]
    hst = HLLMatrix.from_csr(csr).memory_stats()
    assert hst["padded_nnz"] >= hst["nnz"]
    sst = SellMatrix.from_csr(csr).memory_stats()
    assert sst["padded_nnz"] >= sst["nnz"]


def test_sell_sigma_sort_powerlaw():
    """SELL-sigma collapses padding on power-law matrices: the conversion
    chooses a sort window, pads far less than unsorted slices would, and
    still writes every row to its own slot."""
    import scipy.sparse as sp

    from sparsematrixvectormultiplication_tpu.formats.sell import (
        _slice_widths,
        heavy_row_cap,
    )
    from sparsematrixvectormultiplication_tpu.models.synthetic import power_law

    coo = power_law(20000, 5, seed=11)
    s = sp.coo_matrix((coo.val, (coo.row, coo.col)), shape=coo.shape).tocsr()
    sigma = SellMatrix.from_coo(coo)
    assert sigma.sigma > 1
    csr = CSRMatrix.from_coo(coo)
    ext, _ = csr.split_heavy_rows(heavy_row_cap(csr.row_nnz()))
    unsorted = _slice_widths(ext.row_nnz(), sigma.c).sum() * sigma.c
    assert sigma.padded_nnz < unsorted * 0.7
    x = np.random.default_rng(0).standard_normal(coo.ncols)
    assert np.allclose(sigma.spmv(x), s @ x, rtol=1e-12, atol=1e-12)


def test_split_heavy_rows():
    """Power-law-head fix: rows > cap split into segments (zero-copy) and
    recombine exactly via the segment map."""
    import scipy.sparse as sp

    rng = np.random.default_rng(9)
    # one 5000-nnz row, one 1500, rest small
    rows = np.concatenate([np.zeros(5000, np.int64),
                           np.full(1500, 7, np.int64),
                           rng.integers(1, 2000, 4000)])
    cols = rng.integers(0, 3000, rows.size)
    key = rows * 3000 + cols
    _, idx = np.unique(key, return_index=True)
    rows, cols = rows[idx], cols[idx]
    vals = rng.standard_normal(rows.size)
    from sparsematrixvectormultiplication_tpu import COOMatrix, CSRMatrix

    coo = COOMatrix(2000, 3000, rows, cols, vals)
    csr = CSRMatrix.from_coo(coo)
    ext, seg = csr.split_heavy_rows(cap=1024)
    assert seg is not None
    assert ext.nnz == csr.nnz
    assert (np.diff(ext.row_ptr) <= 1024).all()
    # zero-copy: same underlying entry arrays
    assert ext.col_idx is csr.col_idx and ext.values is csr.values
    x = rng.standard_normal(3000)
    y_ext = ext.spmv(x)
    y = np.bincount(seg, weights=y_ext, minlength=csr.nrows)
    assert np.allclose(y, csr.spmv(x), rtol=1e-12, atol=1e-12)
    # no-op path
    same, none = ext.split_heavy_rows(cap=1024)
    assert none is None and same is ext


def test_harness_splits_heavy_rows():
    from sparsematrixvectormultiplication_tpu import COOMatrix
    from sparsematrixvectormultiplication_tpu.bench.harness import (
        BenchConfig,
        run_matrix,
    )

    rng = np.random.default_rng(11)
    rows = np.concatenate([np.zeros(4000, np.int64),
                           rng.integers(1, 3000, 6000)])
    cols = rng.integers(0, 4000, rows.size)
    key = rows * 4000 + cols
    _, idx = np.unique(key, return_index=True)
    coo = COOMatrix(3000, 4000, rows[idx], cols[idx],
                    rng.standard_normal(idx.size))
    cfg = BenchConfig(iterations=2, rounds=1,
                      kernels=("serial_csr", "sell", "sell_f64"),
                      flush_between_stages=False)
    res = run_matrix("heavy", coo, cfg, log=lambda *a: None)
    assert res.format_stats["sell"]["heavy_row_segments"] > 0
    assert res.stage("sell").diff.significant_diffs == 0
    assert res.stage("sell_f64").diff.significant_diffs == 0


def test_native_csr_converter_matches_numpy(make_random_coo):
    """native/fast_csr.cpp counting sort == the numpy lexsort path."""
    from sparsematrixvectormultiplication_tpu.native.build import load_fast_csr

    if load_fast_csr() is None:
        pytest.skip("native toolchain unavailable")
    coo, s = make_random_coo(5000, 4000, 0.01)
    a = CSRMatrix.from_coo(coo, native=True)
    b = CSRMatrix.from_coo(coo, native=False)
    assert np.array_equal(a.row_ptr, b.row_ptr)
    assert np.array_equal(a.col_idx, b.col_idx)
    x = np.random.default_rng(3).standard_normal(4000)
    assert np.allclose(a.spmv(x), b.spmv(x), rtol=1e-14, atol=1e-14)


def test_native_csr_empty_and_single():
    from sparsematrixvectormultiplication_tpu.native.build import coo_to_csr_native

    out = coo_to_csr_native(np.zeros(0, np.int32), np.zeros(0, np.int32),
                            np.zeros(0, np.float64), nrows=3)
    if out is None:
        pytest.skip("native toolchain unavailable")
    row_ptr, col, val = out
    assert np.array_equal(row_ptr, [0, 0, 0, 0]) and col.size == 0

    out = coo_to_csr_native(np.array([1], np.int32), np.array([2], np.int32),
                            np.array([7.5]), nrows=3)
    row_ptr, col, val = out
    assert np.array_equal(row_ptr, [0, 0, 1, 1])
    assert col[0] == 2 and val[0] == 7.5


def test_scipy_interop_roundtrip():
    """from_scipy/to_scipy adapters (migration surface for reference users
    whose oracle workflow is scipy, SURVEY §2 component 29)."""
    import scipy.sparse as sp

    from sparsematrixvectormultiplication_tpu.formats.coo import COOMatrix
    from sparsematrixvectormultiplication_tpu.formats.csr import CSRMatrix

    rng = np.random.default_rng(0)
    m = sp.random(300, 200, density=0.02, random_state=rng, format="coo")
    coo = COOMatrix.from_scipy(m)
    assert coo.shape == (300, 200) and coo.nnz == m.nnz
    back = coo.to_scipy()
    assert (back != m.tocoo()).nnz == 0
    csr = CSRMatrix.from_scipy(m)
    x = rng.standard_normal(200)
    np.testing.assert_allclose(csr.spmv(x), m @ x, rtol=1e-12, atol=1e-14)
    np.testing.assert_allclose(
        np.asarray((csr.to_scipy() @ x)), m @ x, rtol=1e-12, atol=1e-14)
