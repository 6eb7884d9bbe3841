"""Multi-device sharding tests on the virtual 8-device CPU mesh
(SURVEY §4 implication: multi-device tests on forced CPU meshes)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from sparsematrixvectormultiplication_tpu import CSRMatrix, HLLMatrix
from sparsematrixvectormultiplication_tpu.parallel.scheduler import (
    balanced_partition,
    partition_report,
)
from sparsematrixvectormultiplication_tpu.parallel.sharding import (
    col_sharded_spmv,
    make_mesh,
    row_sharded_spmv,
    shard_ell_2d,
    shard_ell_rows,
    sharded_spmv_2d,
)


def test_eight_devices_available():
    assert len(jax.devices()) == 8


# ---------------- scheduler ----------------

def test_balanced_partition_uniform():
    w = np.ones(100, dtype=np.int64)
    p = balanced_partition(w, 4)
    assert p.num_parts == 4
    assert np.all(p.loads == 25)
    assert p.imbalance == 1.0


def test_balanced_partition_skewed():
    # one huge item + many small: greedy must isolate the hot range
    w = np.ones(100, dtype=np.int64)
    w[10] = 1000
    p = balanced_partition(w, 8)
    assert p.num_parts <= 8
    assert p.loads.sum() == w.sum()
    # ranges are contiguous and cover everything
    assert p.starts[0] == 0 and p.ends[-1] == 100
    assert np.all(p.starts[1:] == p.ends[:-1])


def test_balanced_partition_more_parts_than_items():
    w = np.array([5, 3, 2], dtype=np.int64)
    p = balanced_partition(w, 10)
    assert p.num_parts <= 3  # capped (≙ csr_matrix.c:173)
    assert p.loads.sum() == 10


def test_balanced_partition_empty():
    p = balanced_partition(np.zeros(0, np.int64), 4)
    assert p.loads.sum() == 0


def test_partition_report():
    p = balanced_partition(np.ones(10, np.int64), 2)
    rep = partition_report(p, "rows")
    assert "rows" in rep and "part 0" in rep


# ---------------- sharded SpMV ----------------

@pytest.fixture
def problem(make_random_coo):
    coo, s = make_random_coo(3000, 2600, 0.01)
    x = np.random.default_rng(3).standard_normal(2600)
    hll = HLLMatrix.from_coo(coo)
    return hll, s, x


def test_row_sharded_spmv(problem):
    hll, s, x = problem
    mesh = make_mesh(8, ("rows",))
    sh = shard_ell_rows(hll, mesh)
    y = np.asarray(row_sharded_spmv(sh, jnp.asarray(x), mesh))
    assert np.allclose(y, s.tocsr() @ x, rtol=1e-12, atol=1e-12)


def test_row_sharded_output_sharding(problem):
    hll, s, x = problem
    mesh = make_mesh(8, ("rows",))
    sh = shard_ell_rows(hll, mesh)
    # the ELL rectangle really is distributed over all 8 devices
    assert len(sh.as_.sharding.device_set) == 8


def test_2d_sharded_spmv(problem):
    hll, s, x = problem
    mesh = make_mesh(8, ("rows", "cols"), shape=(4, 2))
    sh = shard_ell_2d(hll, mesh)
    y = np.asarray(sharded_spmv_2d(sh, jnp.asarray(x), mesh))
    assert np.allclose(y, s.tocsr() @ x, rtol=1e-12, atol=1e-12)


def test_col_sharded_spmv(problem):
    hll, s, x = problem
    mesh = make_mesh(8, ("cols",))
    y = np.asarray(col_sharded_spmv(hll, jnp.asarray(x), mesh))
    assert np.allclose(y, s.tocsr() @ x, rtol=1e-12, atol=1e-12)


def test_2d_mesh_4x2_vs_2x4(problem):
    hll, s, x = problem
    y_ref = s.tocsr() @ x
    for shape in [(2, 4), (8, 1), (1, 8)]:
        mesh = make_mesh(8, ("rows", "cols"), shape=shape)
        sh = shard_ell_2d(hll, mesh)
        y = np.asarray(sharded_spmv_2d(sh, jnp.asarray(x), mesh))
        assert np.allclose(y, y_ref, rtol=1e-12, atol=1e-12), shape


# ---------------- SELL operator under shard_map ----------------

def _csr_of(s):
    sc = s.tocsr()
    return CSRMatrix(nrows=s.shape[0], ncols=s.shape[1],
                     row_ptr=sc.indptr.astype(np.int64),
                     col_idx=sc.indices.astype(np.int32), values=sc.data)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_spmd_sell_shard_map(problem, dtype):
    """The SELL operator under shard_map on the 8-device CPU mesh; within
    each shard every destination slot, padding included, is distinct."""
    from sparsematrixvectormultiplication_tpu.parallel.spmd_sell import (
        build_spmd_sell,
        sell_spmv_spmd,
    )

    hll, s, x = problem
    mesh = make_mesh(8, ("rows",))
    spmd = build_spmd_sell(_csr_of(s), 8, mesh=mesh, dtype=jnp.dtype(dtype))
    assert spmd.n_shards == 8
    # every stacked leaf carries the shard axis
    for leaf in jax.tree_util.tree_leaves(spmd.stacked):
        assert leaf.shape[0] == 8 and len(leaf.sharding.device_set) == 8
    slots = np.concatenate([np.asarray(r).reshape(8, -1)
                            for _, _, r in spmd.stacked.bins], axis=1)
    for shard in slots:
        assert np.unique(shard).size == shard.size
    y = sell_spmv_spmd(spmd, jnp.asarray(x, dtype), mesh)
    assert y.shape == (s.shape[0],)
    tol = 1e-11 if dtype == "float64" else 1e-4
    assert np.allclose(y, s.tocsr() @ x, rtol=tol, atol=tol)


def test_spmd_sell_unbalanced_shards():
    """Shards with different bin populations and heavy-row segments pad to
    one static shape; rows stay balanced by nnz."""
    from sparsematrixvectormultiplication_tpu.models.synthetic import (
        dense_rows_mix,
    )
    from sparsematrixvectormultiplication_tpu.parallel.spmd_sell import (
        build_spmd_sell,
        sell_spmv_spmd,
    )

    csr = CSRMatrix.from_coo(dense_rows_mix(9000, seed=3))
    mesh = make_mesh(4, ("rows",))
    spmd = build_spmd_sell(csr, 4, mesh=mesh, dtype=jnp.float64)
    nnz = [int(csr.row_ptr[b] - csr.row_ptr[a])
           for a, b in zip(spmd.row_starts[:-1], spmd.row_starts[1:])]
    assert max(nnz) < 3 * (sum(nnz) / len(nnz))  # roughly balanced
    assert spmd.stacked.seg_owner.shape[1] > 0   # heavy rows were split
    x = np.random.default_rng(5).standard_normal(csr.ncols)
    y = sell_spmv_spmd(spmd, x, mesh)
    assert np.allclose(y, csr.spmv(x), rtol=1e-11, atol=1e-11)


def test_spmd_sell_more_shards_than_rows():
    """Shards beyond the matrix's rows are empty and still stack."""
    from sparsematrixvectormultiplication_tpu.models.synthetic import banded
    from sparsematrixvectormultiplication_tpu.parallel.spmd_sell import (
        build_spmd_sell,
        sell_spmv_spmd,
    )

    csr = CSRMatrix.from_coo(banded(300, 4, 10, seed=2))
    mesh = make_mesh(8, ("rows",))
    spmd = build_spmd_sell(csr, 8, mesh=mesh, dtype=jnp.float64)
    assert spmd.n_shards == 8 and spmd.row_starts[-1] == csr.nrows
    x = np.random.default_rng(6).standard_normal(csr.ncols)
    np.testing.assert_allclose(sell_spmv_spmd(spmd, x, mesh), csr.spmv(x),
                               rtol=1e-12, atol=1e-12)
