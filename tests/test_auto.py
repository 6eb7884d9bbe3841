"""The one-call user surface (ops/auto.py): convert, upload, operate.

auto_device_op's operator must validate against the fp64 oracle on every
regime the reference covered — long rows, short scattered rows, random
rows, dense rows split into segments.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from sparsematrixvectormultiplication_tpu.formats.coo import COOMatrix
from sparsematrixvectormultiplication_tpu.formats.csr import CSRMatrix
from sparsematrixvectormultiplication_tpu.models import synthetic as syn
from sparsematrixvectormultiplication_tpu.ops.auto import auto_device_op


def _band_tail(n=6000, seed=0):
    rng = np.random.default_rng(seed)
    coo = syn.banded(n, 4, 60, seed=seed)
    nf = coo.row.size // 20
    return CSRMatrix.from_coo(COOMatrix(
        n, n,
        np.concatenate([coo.row, rng.integers(0, n, nf).astype(np.int32)]),
        np.concatenate([coo.col, rng.integers(0, n, nf).astype(np.int32)]),
        np.concatenate([coo.val, rng.standard_normal(nf)])).sum_duplicates())


BUILDERS = {
    "banded": lambda: CSRMatrix.from_coo(syn.banded(3000, 9, 60, seed=3)),
    "band_tail": _band_tail,
    "random": lambda: CSRMatrix.from_coo(
        syn.random_general(4000, 4000, 0.002, seed=4)),
    "fem_3d": lambda: CSRMatrix.from_coo(syn.fem_3d(6, 6, 6, dof=3, seed=2)),
}


@pytest.mark.parametrize("kind", sorted(BUILDERS))
def test_auto_device_op_validates(kind):
    csr = BUILDERS[kind]()
    op = auto_device_op(csr)
    x = np.random.default_rng(5).standard_normal(csr.ncols)
    y = op.matvec(x)
    ref = csr.spmv(x)
    rel = np.abs(y - ref) / np.maximum(1.0, np.abs(ref))
    assert y.shape == (csr.nrows,)
    assert rel.max() < 1e-5, f"{kind}: max rel {rel.max():.2e}"


def test_auto_device_op_f64_deterministic():
    """The f64 operator reproduces the fp64 oracle to round-off, and
    twice the same product bit for bit (no atomics in the scatter)."""
    csr = BUILDERS["band_tail"]()
    x = np.random.default_rng(1).standard_normal(csr.ncols)
    a = auto_device_op(csr, jnp.float64).matvec(x)
    b = auto_device_op(csr, jnp.float64).matvec(x)
    np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(a, csr.spmv(x), rtol=1e-12, atol=1e-12)


def test_auto_device_op_dense_rows_heavy_split():
    """Dense rows are split into segments and summed back on the device."""
    rng = np.random.default_rng(7)
    n = 3000
    coo = syn.random_general(n, n, 0.001, seed=7)
    hot = rng.choice(n, 4, replace=False)
    fr = np.repeat(hot, 1200).astype(np.int32)
    fc = rng.integers(0, n, fr.size).astype(np.int32)
    csr = CSRMatrix.from_coo(COOMatrix(
        n, n, np.concatenate([coo.row, fr]), np.concatenate([coo.col, fc]),
        np.concatenate([coo.val, rng.standard_normal(fr.size)]))
        .sum_duplicates())
    op = auto_device_op(csr, jnp.float64)
    assert op.host.seg_owner.size > 0
    x = rng.standard_normal(n)
    np.testing.assert_allclose(op.matvec(x), csr.spmv(x), rtol=1e-12,
                               atol=1e-12)


def test_auto_device_op_call_inside_jit():
    """The operator's __call__ composes with jitted code (the solvers)."""
    csr = BUILDERS["banded"]()
    op = auto_device_op(csr, jnp.float64)
    x = np.random.default_rng(2).standard_normal(csr.ncols)
    y = jax.jit(lambda v: 2.0 * op(v))(jnp.asarray(x))
    np.testing.assert_allclose(np.asarray(y), 2.0 * csr.spmv(x),
                               rtol=1e-12, atol=1e-12)
