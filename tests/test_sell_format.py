"""Properties of the SELL-C-σ conversion (formats/sell.py): every entry
lands exactly once, slices are slot-major with a static width per bin,
every row has exactly one destination slot, and the slicing geometry
follows the row-length statistics."""

import numpy as np
import pytest
from sell_cases import EDGES, FAMILIES

from sparsematrixvectormultiplication_tpu.formats.csr import CSRMatrix
from sparsematrixvectormultiplication_tpu.formats.sell import (
    SLICE_HEIGHTS,
    SellGeometry,
    SellMatrix,
    _MAX_BINS,
    choose_slicing,
    heavy_row_cap,
)

CASES = {**FAMILIES, **EDGES}


def _entries(sell: SellMatrix):
    """(destination row, column, value) of every stored real entry."""
    out = []
    for b in sell.bins:
        rows = np.broadcast_to(b.rows[:, None, :], b.cols.shape)
        real = (b.vals != 0) & (rows < sell.n_dest)
        out.append(np.stack([rows[real], b.cols[real], b.vals[real]], 1))
    return np.concatenate(out) if out else np.zeros((0, 3))


@pytest.mark.parametrize("case", sorted(CASES))
def test_every_entry_lands_once(case):
    """Bins hold exactly the CSR entries (zeros aside), each once, in the
    destination slot of its row or of one of its row's segments."""
    csr = CSRMatrix.from_coo(CASES[case]())
    sell = SellMatrix.from_csr(csr)
    got = _entries(sell)
    owner = np.concatenate([np.arange(sell.nrows), sell.seg_owner])
    row = owner[got[:, 0].astype(np.int64)] if got.size else got[:, 0]
    got = np.stack([row, got[:, 1], got[:, 2]], 1) if got.size else got
    want = np.stack([np.repeat(np.arange(csr.nrows), csr.row_nnz()),
                     csr.col_idx, csr.values], 1)
    want = want[want[:, 2] != 0]
    key = lambda a: a[np.lexsort(a.T[::-1])]
    np.testing.assert_array_equal(key(got), key(want))


@pytest.mark.parametrize("case", sorted(CASES))
def test_slices_slot_major_and_rows_unique(case):
    """Per bin: (n, k, c) planes with c the slice height, int32 indices in
    range, zero-valued padding; the destination plane covers every slot
    0..n_dest-1 exactly once, and padding rows point past the end, each to
    its own slot (the device scatter is declared unique)."""
    csr = CSRMatrix.from_coo(CASES[case]())
    sell = SellMatrix.from_csr(csr)
    assert sell.c in SLICE_HEIGHTS
    seen = []
    for b in sell.bins:
        n, k, c = b.cols.shape
        assert (k, c) == (b.k, sell.c) and b.vals.shape == b.cols.shape
        assert b.rows.shape == (n, c)
        assert b.cols.dtype == np.int32 and b.rows.dtype == np.int32
        assert b.cols.min() >= 0 and b.cols.max() < max(csr.ncols, 1)
        pad = b.rows >= sell.n_dest
        assert np.all(b.vals.transpose(0, 2, 1)[pad] == 0)
        seen.append(b.rows.reshape(-1))
    seen = np.sort(np.concatenate(seen)) if seen else np.zeros(0, np.int32)
    np.testing.assert_array_equal(seen, np.arange(seen.size))
    assert len(sell.bins) <= _MAX_BINS
    assert len({b.k for b in sell.bins}) == len(sell.bins)


@pytest.mark.parametrize("case", sorted(CASES))
def test_layout_spmv_matches_csr(case):
    csr = CSRMatrix.from_coo(CASES[case]())
    x = np.random.default_rng(1).standard_normal(csr.ncols)
    np.testing.assert_allclose(SellMatrix.from_csr(csr).spmv(x), csr.spmv(x),
                               rtol=1e-12, atol=1e-12)


def test_sigma_windows_sorted_by_length():
    """Inside each sort window the slices' widths never increase: rows are
    sorted by descending length before slicing."""
    csr = CSRMatrix.from_coo(EDGES["sigma_permutation"]())
    sell = SellMatrix.from_csr(csr)
    assert sell.sigma > 1
    assert sell.padding_ratio < 1.2   # unsorted, every slice would pad to 40
    lengths = csr.row_nnz()
    # short (1-entry) and long rows share a slice only where a window's
    # sorted run turns from long to short: at most once per window
    mixed = 0
    for b in sell.bins:
        for sl in b.rows:
            ln = lengths[sl[sl < sell.n_dest]]
            mixed += int(ln.min() <= 1 < ln.max())
    assert mixed <= -(-csr.nrows // sell.sigma)


def test_uniform_rows_are_not_sorted():
    """Equal-length rows gain nothing from sorting: no window, tallest
    slice."""
    c, sigma = choose_slicing(np.full(10_000, 27))
    assert (c, sigma) == (SLICE_HEIGHTS[0], 1)


def test_mixed_rows_choose_a_window_and_short_slices():
    rng = np.random.default_rng(3)
    lengths = rng.integers(1, 200, 20_000)
    c, sigma = choose_slicing(lengths)
    assert sigma > 1
    assert c in SLICE_HEIGHTS


@pytest.mark.parametrize("median,cap", [(2, 16), (24, 96), (25, 256),
                                        (81, 324), (300, 1200)])
def test_heavy_row_cap(median, cap):
    assert heavy_row_cap(np.full(11, median)) == cap


def test_geometry_of_shards_matches_whole_matrix():
    """Row shards converted with the whole matrix's geometry share its
    slice height, window and bin widths."""
    csr = CSRMatrix.from_coo(FAMILIES["dense_rows_mix"]())
    g = SellGeometry.of(csr)
    half = csr.nrows // 2
    p = int(csr.row_ptr[half])
    top = CSRMatrix(half, csr.ncols, csr.row_ptr[:half + 1], csr.col_idx[:p],
                    csr.values[:p])
    s = SellMatrix.from_csr(top, g)
    assert (s.c, s.sigma) == (g.c, g.sigma)
    assert {b.k for b in s.bins} <= set(g.edges.tolist())
    x = np.random.default_rng(0).standard_normal(csr.ncols)
    np.testing.assert_allclose(s.spmv(x), top.spmv(x), rtol=1e-12, atol=1e-12)


def test_memory_stats_report_geometry():
    csr = CSRMatrix.from_coo(FAMILIES["power_law"]())
    st = SellMatrix.from_csr(csr).memory_stats()
    assert st["slice_rows"] in SLICE_HEIGHTS and st["sigma"] >= 1
    assert st["padded_nnz"] >= st["nnz"] and st["bytes_total"] > 0
    assert st["heavy_row_segments"] > 0
    assert sum(b["n_slices"] for b in st["bins"]) > 0
