"""bf16 values: the SELL operator with bfloat16 value storage.

Values are stored bf16 on the device (a third of the fp64 value bytes)
while x and the accumulation stay f32 — values are widened as they load.
The downward end of the precision ladder (bf16 / f32 / f64); the reference
benchmarks fp64 only (cuda_src/csr_matrix_cuda.cu:96-148).
"""

import numpy as np
import jax.numpy as jnp
import pytest

from sparsematrixvectormultiplication_tpu.models import synthetic as syn
from sparsematrixvectormultiplication_tpu.formats.csr import CSRMatrix
from sparsematrixvectormultiplication_tpu.formats.sell import SellMatrix
from sparsematrixvectormultiplication_tpu.ops.sell import (
    device_put_sell,
    sell_spmv,
)

MATRICES = [
    ("banded", lambda: syn.banded(2500, 9, 30, seed=1)),
    ("banded_wide", lambda: syn.banded(2500, 9, 120, seed=4)),
    ("banded_long", lambda: syn.banded(2500, 27, 60, seed=2)),
    ("fem_3d", lambda: syn.fem_3d(7, 7, 7, dof=3, seed=5)),
    ("power_law", lambda: syn.power_law(2000, 8, 2.1, seed=3)),
]


def _spmv_bf16(csr, x):
    d = device_put_sell(SellMatrix.from_csr(csr), jnp.bfloat16)
    return np.asarray(sell_spmv(d, jnp.asarray(x, jnp.float32)), np.float64)


@pytest.mark.parametrize("name,gen", MATRICES, ids=[n for n, _ in MATRICES])
def test_bf16_within_precision_bar(name, gen):
    """bf16 values vs the fp64 oracle: within eps(bf16) x log-depth."""
    csr = CSRMatrix.from_coo(gen())
    x = np.random.default_rng(0).standard_normal(csr.ncols)
    y = _spmv_bf16(csr, x)
    yref = csr.spmv(x)
    rel = np.abs(y - yref) / np.maximum(np.abs(yref), 1.0)
    assert rel.max() < 6e-2, rel.max()


@pytest.mark.parametrize("name,gen", MATRICES, ids=[n for n, _ in MATRICES])
def test_bf16_exact_on_representable_values(name, gen):
    """With bf16-representable values (small ints) and integer x the whole
    computation is exact — a strong differential for the widening-cast
    path: any dropped/duplicated entry or wrong-dtype accumulation shows
    as a nonzero integer diff."""
    csr = CSRMatrix.from_coo(gen())
    rng = np.random.default_rng(7)
    csr = CSRMatrix(csr.nrows, csr.ncols, csr.row_ptr, csr.col_idx,
                    rng.integers(-8, 9, csr.nnz).astype(np.float64))
    x = rng.integers(-4, 5, csr.ncols).astype(np.float64)
    np.testing.assert_array_equal(_spmv_bf16(csr, x), csr.spmv(x))


def test_bf16_device_dtypes():
    """Value planes upload as bf16, index planes as int32; the output is
    f32."""
    csr = CSRMatrix.from_coo(syn.banded(600, 5, 12, seed=0))
    d = device_put_sell(SellMatrix.from_csr(csr), jnp.bfloat16)
    assert all(v.dtype == jnp.bfloat16 for _, v, _ in d.bins)
    assert all(c.dtype == jnp.int32 and r.dtype == jnp.int32
               for c, _, r in d.bins)
    x = jnp.ones(csr.ncols, jnp.float32)
    assert sell_spmv(d, x).dtype == jnp.float32


def test_bf16_f32_path_unchanged():
    """The dtype plumbing must not disturb the f32 path: f32 results stay
    within normal f32 bounds of the fp64 oracle."""
    csr = CSRMatrix.from_coo(syn.banded(2500, 9, 30, seed=1))
    x = np.random.default_rng(1).standard_normal(csr.ncols)
    d = device_put_sell(SellMatrix.from_csr(csr), jnp.float32)
    y = np.asarray(sell_spmv(d, jnp.asarray(x, jnp.float32)), np.float64)
    yref = csr.spmv(x)
    rel = np.abs(y - yref) / np.maximum(np.abs(yref), 1.0)
    assert rel.max() < 1e-5, rel.max()


def test_bf16_harness_stage():
    """The sell_bf16 bench stage runs and validates cleanly against the
    bf16-rounded fp64 oracle (kernel correctness isolated from storage
    rounding: default f32-level tolerances apply)."""
    from sparsematrixvectormultiplication_tpu.bench.harness import (
        BenchConfig,
        run_matrix,
    )

    coo = syn.banded(1500, 8, 64, seed=0)
    cfg = BenchConfig(
        iterations=2, rounds=1, skip=1,
        kernels=("serial_csr", "sell", "sell_bf16"),
        flush_between_stages=False,
    )
    res = run_matrix("bf16_banded", coo, cfg, log=lambda *a, **k: None)
    assert "sell_bf16" in res.stages
    assert res.stages["sell_bf16"].diff.significant_diffs == 0
    assert res.stages["sell"].diff.significant_diffs == 0
