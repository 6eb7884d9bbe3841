"""Tests for the synthetic matrix families, metric store, scheduler report,
and timing utilities."""

import numpy as np
import pytest

from sparsematrixvectormultiplication_tpu.models.synthetic import (
    banded,
    dense_rows_mix,
    diagonal_dominant,
    power_law,
    random_general,
    random_pattern,
    random_symmetric,
    road_network,
    write_suite,
    SuiteEntry,
)
from sparsematrixvectormultiplication_tpu.utils.metrics import (
    MetricStore,
    calculate_flops,
    format_bytes,
    format_flops,
)
from sparsematrixvectormultiplication_tpu.utils.validation import DiffMetrics


def test_random_general_density():
    m = random_general(200, 300, 0.05, seed=1)
    assert m.shape == (200, 300)
    assert 0.7 * 3000 <= m.nnz <= 3000  # dedup may reduce slightly


def test_random_symmetric_is_symmetric():
    m = random_symmetric(100, 0.1, seed=2)
    d = m.to_dense()
    assert np.allclose(d, d.T)


def test_random_pattern_values_one():
    m = random_pattern(50, 50, 0.1, seed=3)
    assert np.all(m.val == 1.0)


def test_banded_locality():
    m = banded(1000, 10, 50, seed=4)
    assert np.all(np.abs(m.row.astype(int) - m.col.astype(int)) <= 50)
    counts = m.row_counts()
    assert counts.max() <= 10


def test_power_law_degree_skew():
    m = power_law(10000, 5, seed=5)
    counts = m.row_counts()
    assert counts.max() > 10 * max(np.median(counts), 1)  # heavy tail


def test_road_network_sparse_rows():
    m = road_network(5000, seed=6)
    assert m.row_counts().max() <= 8


def test_dense_rows_mix_has_hot_rows():
    m = dense_rows_mix(10000, seed=7)
    counts = m.row_counts()
    assert counts.max() > 20 * max(np.median(counts), 1)


def test_diagonal_dominant_shapes():
    m = diagonal_dominant(2000, 7, seed=8)
    assert m.shape == (2000, 2000)


def test_write_suite_roundtrip(tmp_path):
    entries = [SuiteEntry("tiny", "t", lambda: random_general(40, 40, 0.1, seed=9))]
    paths = write_suite(str(tmp_path), entries)
    assert len(paths) == 1
    from sparsematrixvectormultiplication_tpu import COOMatrix

    back = COOMatrix.from_mtx(paths[0])
    orig = random_general(40, 40, 0.1, seed=9)
    assert np.allclose(back.to_dense(), orig.to_dense())


# ---------------- metrics ----------------

def test_metric_store_accumulation():
    st = MetricStore()
    for v in [1.0, 2.0, 3.0]:
        st["stage"].update(v)
    assert st.mean("stage") == 2.0
    assert np.isclose(st["stage"].variance, 2.0 / 3.0)
    assert st["stage"].min == 1.0 and st["stage"].max == 3.0
    st.reset()
    assert "stage" not in st


def test_metric_store_errors_average():
    st = MetricStore()
    st["k"].accumulate_errors(DiffMetrics(mean_abs_err=0.2, mean_rel_err=0.4))
    st["k"].accumulate_errors(DiffMetrics(mean_abs_err=0.4, mean_rel_err=0.6))
    avg = st["k"].average_errors()
    assert np.isclose(avg.mean_abs_err, 0.3)
    assert np.isclose(avg.mean_rel_err, 0.5)
    # reference-compatible mode divides by count + skip (performance_calculate.c:62)
    avg_ref = st["k"].average_errors(extra_skip=2)
    assert np.isclose(avg_ref.mean_rel_err, 1.0 / 4)


def test_flops_helpers():
    assert calculate_flops(1000, 2.0) == 1000.0
    assert calculate_flops(1000, 0.0) == 0.0
    assert format_flops(1234) == "1.234 KFLOPS"
    assert format_flops(5.3e9).endswith("GFLOPS")
    assert format_bytes(2048) == "2.00 KiB"


def test_timing_batched_rounds():
    import jax.numpy as jnp

    from sparsematrixvectormultiplication_tpu.utils.timing import (
        time_device_fn_batched,
    )

    best, rounds = time_device_fn_batched(lambda a: a * 2, jnp.ones(8), reps=4, rounds=2)
    assert best > 0 and len(rounds) == 2


def test_fem_3d_structure():
    import scipy.sparse as sp

    from sparsematrixvectormultiplication_tpu.models.synthetic import fem_3d

    m = fem_3d(6, 5, 4, dof=2, seed=0)
    n = 6 * 5 * 4 * 2
    assert m.shape == (n, n)
    d = m.to_dense()
    # structurally symmetric (27-point stencil)
    assert np.array_equal(d != 0, (d != 0).T)
    # interior node has full 27-neighborhood * dof
    counts = m.row_counts()
    assert counts.max() == 27 * 2
    # corner node couples to 8 nodes * dof
    assert counts.min() == 8 * 2


def test_webbase_like_locality():
    """webbase_like must have the locality powerlaw_web destroys: markedly
    more entries per (row-group, column-slab) pair (the quantity that sets
    the broadcast-kernel floor; docs/DESIGN.md round-3 facts)."""
    import numpy as np

    from sparsematrixvectormultiplication_tpu.models.synthetic import (
        power_law, webbase_like)

    def density(coo):
        g = (coo.row.astype(np.int64) // 1024)
        slab = coo.col.astype(np.int64) // 128
        pairs = np.unique(g * (1 << 20) + slab).size
        return coo.nnz / pairs

    web = webbase_like(100_000, 3, seed=9)
    plaw = power_law(100_000, 3, seed=6)
    # ratio grows with n (2.9x at the suite's 1M rows); 1.4x at this size
    assert density(web) > 1.4 * density(plaw)
    # power-law degree structure retained
    deg = np.bincount(web.row)
    assert deg.max() > 20 * np.median(deg[deg > 0])


def test_new_reference_class_generators():
    """mac_econ / cop20k / PR02R structure analogues:
    row-length and locality signatures in class-distinct ranges."""
    import numpy as np

    from sparsematrixvectormultiplication_tpu.models.synthetic import (
        cfd_multidof, econ_sectors, unstructured_fem,
    )

    econ = econ_sectors(20_000, seed=1)
    rc = np.bincount(econ.row, minlength=econ.nrows)
    assert 4 <= econ.nnz / econ.nrows <= 9        # short rows (~6.2 ref)
    assert rc.max() <= 44                         # mac_econ max row nnz
    d = np.abs(econ.col.astype(np.int64) - econ.row)
    # two-scale locality: most entries sector-local, a cross-sector tail
    assert np.median(d) < 1000 < np.percentile(d, 95)

    cop = unstructured_fem(12_000, seed=2)
    assert 15 <= cop.nnz / cop.nrows <= 27        # ~21.7 ref
    d = np.abs(cop.col.astype(np.int64) - cop.row)
    assert np.percentile(d, 90) > 400             # shuffled-id scattering

    cfd = cfd_multidof(40, 40, dof=5, seed=3)
    rc = np.bincount(cfd.row, minlength=cfd.nrows)
    assert 35 <= cfd.nnz / cfd.nrows <= 55        # long rows (~50.8 ref)
    assert rc.max() == 45                         # 9-pt x 5 dof dense blocks
    # oracle sanity: symmetric-pattern SpMV equals scipy
    import scipy.sparse as sp

    from sparsematrixvectormultiplication_tpu.formats.csr import CSRMatrix

    csr = CSRMatrix.from_coo(cfd)
    x = np.random.default_rng(0).standard_normal(cfd.ncols)
    y = csr.spmv(x)
    m = sp.coo_matrix((cfd.val, (cfd.row, cfd.col)),
                      shape=(cfd.nrows, cfd.ncols)).tocsr()
    assert np.allclose(y, m @ x)
