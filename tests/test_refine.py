"""Mixed-precision iterative refinement (solvers/refine.py): bf16/f32
inner solves + fp64 residuals converge to fp64-level accuracy — the
composition the precision ladder (bf16 / f32 / f64) exists for.
"""

import numpy as np
import jax.numpy as jnp

from sparsematrixvectormultiplication_tpu.formats.coo import COOMatrix
from sparsematrixvectormultiplication_tpu.formats.csr import CSRMatrix
from sparsematrixvectormultiplication_tpu.formats.sell import SellMatrix
from sparsematrixvectormultiplication_tpu.ops.sell import (
    device_put_sell,
    sell_spmv,
)
from sparsematrixvectormultiplication_tpu.solvers import (
    cg,
    iterative_refinement,
)


def _spd_laplacian(n, shift=4.0):
    rows = np.repeat(np.arange(n), 3)[1:-1]
    cols = (rows + np.tile([-1, 0, 1], n)[1:-1])
    keep = (cols >= 0) & (cols < n)
    vals = np.tile([-1.0, 2.0 + shift, -1.0], n)[1:-1]
    coo = COOMatrix(n, n, rows[keep].astype(np.int64),
                    cols[keep].astype(np.int64), vals[keep])
    return CSRMatrix.from_coo(coo)


def test_refinement_bf16_inner_reaches_fp64_accuracy():
    """CG over the bf16 value planes (~4e-3 operator perturbation) can
    never solve past ~1e-3 alone; refinement with fp64 residuals drives
    it to 1e-12."""
    csr = _spd_laplacian(1536)
    dbf = device_put_sell(SellMatrix.from_csr(csr), jnp.bfloat16)

    def matvec_bf16(v):
        return sell_spmv(dbf, v)

    def inner(r):
        x, _, _ = cg(matvec_bf16, jnp.asarray(r, jnp.float32),
                     tol=1e-3, maxiter=100)
        return x

    b = np.random.default_rng(0).standard_normal(csr.nrows)
    x, sweeps, resnorms = iterative_refinement(inner, csr.spmv, b,
                                               tol=1e-12)
    assert resnorms[-1] <= 1e-12, resnorms
    assert sweeps <= 10
    # each sweep contracts (the documented behavior)
    assert all(b < a for a, b in zip(resnorms, resnorms[1:]))


def test_refinement_direct_f32_inner():
    """Works with any contracting inner solve — plain f32 CG included."""
    csr = _spd_laplacian(1024)
    d32 = device_put_sell(SellMatrix.from_csr(csr), jnp.float32)

    def inner(r):
        x, _, _ = cg(lambda v: sell_spmv(d32, v),
                     jnp.asarray(r, jnp.float32), tol=1e-4, maxiter=200)
        return x

    b = np.random.default_rng(1).standard_normal(csr.nrows)
    x, sweeps, resnorms = iterative_refinement(inner, csr.spmv, b,
                                               tol=1e-13)
    assert resnorms[-1] <= 1e-13


def test_refinement_stagnation_guard():
    """An inner solve that returns zero corrections stops after the
    stagnation check instead of burning max_sweeps."""
    csr = _spd_laplacian(256)
    b = np.ones(csr.nrows)
    x, sweeps, resnorms = iterative_refinement(
        lambda r: np.zeros_like(r), csr.spmv, b, tol=1e-14, max_sweeps=20)
    assert sweeps <= 3
    assert len(resnorms) <= 4


def test_refinement_zero_rhs():
    csr = _spd_laplacian(128)
    x, sweeps, resnorms = iterative_refinement(
        lambda r: r, csr.spmv, np.zeros(csr.nrows))
    assert np.all(x == 0) and sweeps == 0


def test_refinement_slow_contraction_not_aborted():
    """Regression (code review): an inner solve contracting only ~1.5x per
    sweep reduces the residual monotonically and must NOT trip the
    stagnation guard — "any solver that reduces the error works"."""
    csr = _spd_laplacian(512)
    b = np.random.default_rng(2).standard_normal(csr.nrows)

    # crude inner solve: 3 fixed Jacobi sweeps (slow, steady contraction)
    dinv = 1.0 / 6.0

    def inner(r):
        x = dinv * r
        for _ in range(2):
            x = x + dinv * (r - csr.spmv(x))
        return x

    x, sweeps, resnorms = iterative_refinement(inner, csr.spmv, b,
                                               tol=1e-10, max_sweeps=60)
    assert resnorms[-1] <= 1e-10, resnorms[-1]


def test_refinement_f64_residual_on_device():
    """The all-on-device composition: f32 inner CG + native fp64 residuals
    from the SELL operator — no host fp64 matvec needed."""
    csr = _spd_laplacian(1024)
    sell = SellMatrix.from_csr(csr)
    d32 = device_put_sell(sell, jnp.float32)
    d64 = device_put_sell(sell, jnp.float64)

    def inner(r):
        x, _, _ = cg(lambda v: sell_spmv(d32, v),
                     jnp.asarray(r, jnp.float32), tol=1e-4, maxiter=200)
        return x

    def matvec_f64(v):
        return np.asarray(sell_spmv(d64, jnp.asarray(v)), np.float64)

    b = np.random.default_rng(3).standard_normal(csr.nrows)
    x, sweeps, resnorms = iterative_refinement(inner, matvec_f64, b,
                                               tol=1e-12)
    assert resnorms[-1] <= 1e-12, resnorms
    # and the host fp64 residual agrees
    r_true = b - csr.spmv(x)
    assert np.linalg.norm(r_true) / np.linalg.norm(b) <= 1e-11
