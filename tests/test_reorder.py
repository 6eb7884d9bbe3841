"""RCM reordering (formats/reorder.py): permutation algebra, bandwidth
reduction on shuffled-band / road graphs, harness integration.

The reference has no preprocessing stage (main.c:25-44); reordering is a
locality lever, so these tests anchor on workload equivalence:
(P A Pᵀ)(P x) == P (A x) exactly in fp64.
"""

import numpy as np
import pytest

from sparsematrixvectormultiplication_tpu.formats.coo import COOMatrix
from sparsematrixvectormultiplication_tpu.formats.csr import CSRMatrix
from sparsematrixvectormultiplication_tpu.formats.reorder import (
    _rcm_numpy,
    bandwidth_stats,
    permute_csr,
    rcm_permutation,
    reorder_rcm,
)
from sparsematrixvectormultiplication_tpu.models.synthetic import (
    banded,
    road_network,
)


def _random_square(rng, n=400, density=0.01):
    import scipy.sparse as sp

    a = sp.random(n, n, density=density, random_state=np.random.RandomState(7),
                  format="coo")
    coo = COOMatrix(n, n, a.row.astype(np.int64), a.col.astype(np.int64),
                    a.data.astype(np.float64))
    return CSRMatrix.from_coo(coo)


def _shuffled_band(rng, n=2000, half=6):
    csr = CSRMatrix.from_coo(banded(n, 2 * half + 1, half, seed=3))
    shuf = np.asarray(rng.permutation(n), dtype=np.int64)
    return permute_csr(csr, shuf), csr


def test_permute_csr_spmv_equivalence(rng):
    csr = _random_square(rng)
    n = csr.nrows
    perm = np.asarray(rng.permutation(n), dtype=np.int64)
    x = np.asarray(rng.normal(size=n))
    ap = permute_csr(csr, perm)
    # (P A Pt)(P x) = P (A x) — exact in fp64 up to summation order
    np.testing.assert_allclose(ap.spmv(x[perm]), csr.spmv(x)[perm],
                               rtol=1e-12, atol=1e-12)


def test_permute_csr_identity(rng):
    csr = _random_square(rng, n=100)
    ident = np.arange(100, dtype=np.int64)
    ap = permute_csr(csr, ident)
    np.testing.assert_array_equal(ap.row_ptr, csr.row_ptr)
    np.testing.assert_array_equal(ap.col_idx, csr.col_idx)
    np.testing.assert_array_equal(ap.values, csr.values)


def test_permute_preserves_csr_invariants(rng):
    csr = _random_square(rng)
    perm = np.asarray(rng.permutation(csr.nrows), dtype=np.int64)
    ap = permute_csr(csr, perm)
    assert ap.nnz == csr.nnz
    # columns sorted within each row (the converters rely on it)
    for r in range(0, ap.nrows, 37):
        seg = ap.col_idx[ap.row_ptr[r]:ap.row_ptr[r + 1]]
        assert np.all(np.diff(seg) > 0) or seg.size <= 1


def test_rcm_recovers_shuffled_band(rng):
    shuffled, original = _shuffled_band(rng)
    b_shuf = bandwidth_stats(shuffled)
    perm = rcm_permutation(shuffled)
    recovered = permute_csr(shuffled, perm)
    b_rec = bandwidth_stats(recovered)
    # a destroyed band (p98 ~ n/3) must come back to near the original width
    assert b_shuf["p98"] > 200
    assert b_rec["p98"] <= 4 * bandwidth_stats(original)["p98"] + 8


def test_rcm_on_road_network():
    """The synthetic road generator (models/synthetic.py road_network) is a
    grid WITH random long-range shortcuts: its p50 bandwidth is already
    ~tens (grid locality) while shortcuts pin p98 high — RCM measured on it
    barely moves p98 and *worsens* the median, so the auto gate must
    decline, and forcing mode='rcm' must still be workload-equivalent."""
    csr = CSRMatrix.from_coo(road_network(20_000, seed=5))
    out_a, perm_a, stats_a = reorder_rcm(csr, mode="auto")
    assert not stats_a["applied"]          # measured: p98 gain ~1.1x < 2x
    assert stats_a["p98_gain"] < 2.0
    out, perm, stats = reorder_rcm(csr, mode="rcm")
    assert stats["applied"]
    x = np.asarray(np.random.default_rng(0).normal(size=csr.nrows))
    np.testing.assert_allclose(out.spmv(x[perm]), csr.spmv(x)[perm],
                               rtol=1e-12, atol=1e-12)


def test_reorder_auto_skips_banded():
    csr = CSRMatrix.from_coo(banded(5000, 9, 4, seed=2))
    out, perm, stats = reorder_rcm(csr, mode="auto")
    assert not stats["applied"]
    assert perm is None and out is csr


def test_reorder_rejects_rectangular(rng):
    coo = COOMatrix(4, 6, np.array([0, 1]), np.array([0, 5]),
                    np.array([1.0, 2.0]))
    csr = CSRMatrix.from_coo(coo)
    with pytest.raises(ValueError):
        rcm_permutation(csr)
    out, perm, stats = reorder_rcm(csr, mode="rcm")
    assert not stats["applied"] and perm is None


def test_rcm_numpy_fallback_quality(rng):
    """The scipy-free BFS fallback must also collapse a shuffled band."""
    shuffled, original = _shuffled_band(rng, n=600, half=4)
    n = shuffled.nrows
    rows = np.repeat(np.arange(n, dtype=np.int64), np.diff(shuffled.row_ptr))
    cols = shuffled.col_idx.astype(np.int64)
    r2 = np.concatenate([rows, cols])
    c2 = np.concatenate([cols, rows])
    order = np.lexsort((c2, r2))
    r2, c2 = r2[order], c2[order]
    keep = np.ones(r2.size, dtype=bool)
    keep[1:] = (r2[1:] != r2[:-1]) | (c2[1:] != c2[:-1])
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(np.bincount(r2[keep], minlength=n), out=indptr[1:])
    perm = _rcm_numpy(indptr, c2[keep], n)
    assert sorted(perm) == list(range(n))
    rec = bandwidth_stats(permute_csr(shuffled, perm))
    assert rec["p98"] <= 6 * bandwidth_stats(original)["p98"] + 8


def test_harness_reorder_integration():
    """run_matrix(reorder='rcm') must validate every stage (the oracle and
    the kernels all see the permuted problem)."""
    from sparsematrixvectormultiplication_tpu.bench.harness import (
        BenchConfig,
        run_matrix,
    )

    coo = road_network(4000, seed=5)
    cfg = BenchConfig(iterations=2, rounds=1, skip=1,
                      kernels=("serial_csr", "xla_csr", "sell"),
                      reorder="rcm")
    res = run_matrix("road_rcm", coo, cfg, log=lambda *a, **k: None)
    assert res.format_stats["reorder"]["applied"]
    for s in ("xla_csr", "sell"):
        assert res.stages[s].diff.significant_diffs == 0, s
