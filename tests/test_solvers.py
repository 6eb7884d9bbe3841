"""CG solver over the framework matvecs (solvers/cg.py).

The solve runs as ONE jitted program (lax.while_loop body = matvec +
vector updates); these tests check convergence against a dense direct
solve on an SPD matrix assembled from the suite generators."""

import numpy as np
import pytest
import scipy.sparse as sp

from sparsematrixvectormultiplication_tpu.formats.coo import COOMatrix
from sparsematrixvectormultiplication_tpu.formats.csr import CSRMatrix
from sparsematrixvectormultiplication_tpu.models.synthetic import banded


def _spd_csr(n=1500, seed=3):
    """A = B + B^T + c I with c > row sums — symmetric diagonally dominant
    (hence SPD)."""
    coo = banded(n, 9, 40, seed=seed)
    m = sp.coo_matrix((coo.val, (coo.row, coo.col)), shape=(n, n))
    a = m + m.T
    a = a + sp.eye(n) * (np.abs(a).sum(axis=1).max() + 1.0)
    a = a.tocoo()
    c = COOMatrix(n, n, a.row.astype(np.int32), a.col.astype(np.int32),
                  a.data.astype(np.float64))
    return CSRMatrix.from_coo(c), a.toarray()


def test_cg_xla_csr_fp64():
    import jax.numpy as jnp

    from sparsematrixvectormultiplication_tpu.ops.xla import device_put_csr
    from sparsematrixvectormultiplication_tpu.solvers import cg_sell

    csr, dense = _spd_csr()
    rng = np.random.default_rng(0)
    b = rng.standard_normal(csr.nrows)
    x_ref = np.linalg.solve(dense, b)

    d = device_put_csr(csr, dtype=jnp.float64)
    x, iters, res = cg_sell(d, jnp.asarray(b, jnp.float64), tol=1e-10,
                            maxiter=500)
    assert int(iters) < 500, "CG did not converge"
    np.testing.assert_allclose(np.asarray(x), x_ref, rtol=1e-6, atol=1e-8)


def _nonsym_dd_csr(n=900, seed=7):
    """General banded + dominant diagonal: nonsingular, NOT symmetric."""
    coo = banded(n, 7, 25, seed=seed)
    m = sp.coo_matrix((coo.val, (coo.row, coo.col)), shape=(n, n))
    a = (m + sp.eye(n) * (np.abs(m).sum(axis=1).max() + 1.0)).tocoo()
    c = COOMatrix(n, n, a.row.astype(np.int32), a.col.astype(np.int32),
                  a.data.astype(np.float64))
    return CSRMatrix.from_coo(c), a.toarray()


def test_bicgstab_nonsymmetric_fp64():
    import jax.numpy as jnp

    from sparsematrixvectormultiplication_tpu.ops.xla import (
        csr_spmv,
        device_put_csr,
    )
    from sparsematrixvectormultiplication_tpu.solvers import bicgstab

    csr, dense = _nonsym_dd_csr()
    assert not np.allclose(dense, dense.T), "fixture must be nonsymmetric"
    rng = np.random.default_rng(2)
    b = rng.standard_normal(csr.nrows)
    x_ref = np.linalg.solve(dense, b)

    d = device_put_csr(csr, dtype=jnp.float64)

    def matvec(v):
        return csr_spmv(d.values, d.col_idx, d.row_ids, v, nrows=d.nrows)

    x, iters, res = bicgstab(matvec, jnp.asarray(b, jnp.float64),
                             tol=1e-10, maxiter=500)
    assert int(iters) < 500, "BiCGSTAB did not converge"
    np.testing.assert_allclose(np.asarray(x), x_ref, rtol=1e-6, atol=1e-8)


def test_cg_multi_over_csr_spmm():
    """k systems share one multi-RHS SpMM per iteration (solvers/cg.py
    cg_multi over ops/xla.py csr_spmm)."""
    import jax.numpy as jnp

    from sparsematrixvectormultiplication_tpu.ops.xla import (
        csr_spmm,
        device_put_csr,
    )
    from sparsematrixvectormultiplication_tpu.solvers import cg_multi

    csr, dense = _spd_csr(n=800, seed=9)
    rng = np.random.default_rng(3)
    k = 5
    B = rng.standard_normal((csr.nrows, k))
    x_ref = np.linalg.solve(dense, B)

    d = device_put_csr(csr, dtype=jnp.float32)

    def matmat(V):
        return csr_spmm(d.values, d.col_idx, d.row_ids, V, nrows=d.nrows)

    X, iters, res = cg_multi(matmat, jnp.asarray(B, jnp.float32),
                             tol=1e-5, maxiter=400)
    assert int(iters) < 400, "multi-RHS CG did not converge"
    rel = np.abs(np.asarray(X, np.float64) - x_ref) / np.maximum(
        1.0, np.abs(x_ref))
    assert rel.max() < 5e-3, f"{rel.max():.2e}"


def _cg_sell(dtype, tol, bar):
    """CG over the SELL operator at ``dtype``."""
    import jax.numpy as jnp

    from sparsematrixvectormultiplication_tpu.formats.sell import SellMatrix
    from sparsematrixvectormultiplication_tpu.ops.sell import device_put_sell
    from sparsematrixvectormultiplication_tpu.solvers import cg_sell

    csr, dense = _spd_csr(n=1200, seed=5)
    rng = np.random.default_rng(1)
    b = rng.standard_normal(csr.nrows)
    x_ref = np.linalg.solve(dense, b)

    d = device_put_sell(SellMatrix.from_csr(csr), jnp.dtype(dtype))
    x, iters, res = cg_sell(d, jnp.asarray(b, dtype), tol=tol,
                            maxiter=400)
    assert int(iters) < 400, "CG did not converge"
    # f32 matvec + f32 recurrences: expect ~1e-3 relative on a
    # well-conditioned diagonally-dominant system; f64 far tighter
    rel = np.abs(np.asarray(x, np.float64) - x_ref) / np.maximum(
        1.0, np.abs(x_ref))
    assert rel.max() < bar, f"{rel.max():.2e}"


def test_cg_sell_f32():
    _cg_sell("float32", 1e-5, 5e-3)


def test_cg_sell_f64():
    """Native fp64: the solve reaches a tolerance f32 cannot."""
    _cg_sell("float64", 1e-12, 1e-9)


def test_cg_sell_rejects_non_square_and_unknown():
    import jax.numpy as jnp

    from sparsematrixvectormultiplication_tpu.formats.sell import SellMatrix
    from sparsematrixvectormultiplication_tpu.models.synthetic import (
        random_general,
    )
    from sparsematrixvectormultiplication_tpu.ops.sell import device_put_sell
    from sparsematrixvectormultiplication_tpu.solvers import cg_sell

    rect = SellMatrix.from_coo(random_general(40, 30, 0.1, seed=1))
    with pytest.raises(ValueError, match="square"):
        cg_sell(device_put_sell(rect, jnp.float64), jnp.ones(40))
    with pytest.raises(TypeError):
        cg_sell(object(), jnp.ones(40))


def test_cg_jacobi_preconditioner_converges_faster():
    import jax.numpy as jnp

    from sparsematrixvectormultiplication_tpu.ops.xla import (
        csr_spmv,
        device_put_csr,
    )
    from sparsematrixvectormultiplication_tpu.solvers import (
        cg,
        jacobi_preconditioner,
    )

    # wildly varying diagonal: the regime Jacobi exists for
    csr, dense = _spd_csr(n=1000, seed=11)
    scale = np.exp(np.linspace(0, 8, csr.nrows))
    dense = dense * scale[:, None] * scale[None, :]
    from sparsematrixvectormultiplication_tpu.formats.coo import COOMatrix as C
    a = sp.coo_matrix(dense)
    csr = CSRMatrix.from_coo(C(csr.nrows, csr.nrows, a.row, a.col, a.data))

    rng = np.random.default_rng(4)
    b = rng.standard_normal(csr.nrows)
    d = device_put_csr(csr, dtype=jnp.float64)

    def matvec(v):
        return csr_spmv(d.values, d.col_idx, d.row_ids, v, nrows=d.nrows)

    x_ref = np.linalg.solve(dense, b)
    bj = jnp.asarray(b, jnp.float64)
    x_p, it_p, _ = cg(matvec, bj, tol=1e-10, maxiter=3000,
                      minv=jacobi_preconditioner(csr, jnp.float64))
    x_n, it_n, _ = cg(matvec, bj, tol=1e-10, maxiter=3000)
    np.testing.assert_allclose(np.asarray(x_p), x_ref, rtol=1e-5, atol=1e-8)
    assert int(it_p) < int(it_n), f"PCG {int(it_p)} !< CG {int(it_n)}"


def test_csr_transpose_roundtrip():
    from sparsematrixvectormultiplication_tpu.models.synthetic import power_law

    coo = power_law(800, 6, seed=13)
    csr = CSRMatrix.from_coo(coo)
    t = csr.transpose()
    assert t.shape == (csr.ncols, csr.nrows)
    np.testing.assert_array_equal(t.to_dense(), csr.to_dense().T)
    np.testing.assert_array_equal(t.transpose().to_dense(), csr.to_dense())


def test_power_iteration_dominant_eigenpair():
    import jax.numpy as jnp

    csr, dense = _spd_csr(n=400, seed=15)
    from sparsematrixvectormultiplication_tpu.ops.xla import (
        csr_spmv,
        device_put_csr,
    )
    from sparsematrixvectormultiplication_tpu.solvers import power_iteration

    d = device_put_csr(csr, dtype=jnp.float64)
    v0 = jnp.asarray(np.random.default_rng(6).standard_normal(csr.nrows))
    lam, v, it = power_iteration(
        lambda u: csr_spmv(d.values, d.col_idx, d.row_ids, u, nrows=d.nrows),
        v0, tol=1e-12, maxiter=5000)
    w = np.linalg.eigvalsh(dense)
    assert abs(float(lam) - w[-1]) / abs(w[-1]) < 1e-6
    # eigenvector residual
    r = dense @ np.asarray(v) - float(lam) * np.asarray(v)
    assert np.linalg.norm(r) < 1e-4 * abs(w[-1])


def test_pagerank_power_law_graph():
    """PageRank through the framework transpose + XLA matvec vs a dense
    fp64 Google-matrix power iteration."""
    import jax.numpy as jnp

    from sparsematrixvectormultiplication_tpu.models.synthetic import power_law
    from sparsematrixvectormultiplication_tpu.ops.xla import (
        csr_spmv,
        device_put_csr,
    )
    from sparsematrixvectormultiplication_tpu.solvers import (
        pagerank,
        pagerank_operator,
    )

    coo = power_law(500, 5, seed=17)
    coo = COOMatrix(coo.nrows, coo.ncols, coo.row, coo.col, np.abs(coo.val))
    csr = CSRMatrix.from_coo(coo)
    t, dangling = pagerank_operator(csr)
    d = device_put_csr(t, dtype=jnp.float64)

    p, it, delta = pagerank(
        lambda u: csr_spmv(d.values, d.col_idx, d.row_ids, u, nrows=d.nrows),
        jnp.asarray(dangling), alpha=0.85, tol=1e-12, maxiter=500)
    p = np.asarray(p)
    assert abs(p.sum() - 1.0) < 1e-9 and (p > 0).all()

    # dense fp64 reference (weighted random-surfer chain)
    n = csr.nrows
    A = csr.to_dense()
    w = A.sum(axis=1)
    P = (A / np.where(w == 0, 1.0, w)[:, None]).T
    ref = np.full(n, 1.0 / n)
    for _ in range(400):
        ref = 0.85 * (P @ ref + ref[w == 0].sum() / n) + 0.15 / n
    np.testing.assert_allclose(p, ref, rtol=1e-8, atol=1e-12)


def test_power_iteration_breakdown_is_clean():
    """A @ v == 0 (nilpotent A) must stop cleanly, never return NaNs
    (review finding: NaN delta silently ended the loop)."""
    import jax.numpy as jnp

    from sparsematrixvectormultiplication_tpu.solvers import power_iteration

    A = np.zeros((4, 4))
    A[0, 1] = 1.0  # strictly upper triangular: A @ (A @ e1) = 0
    lam, v, it = power_iteration(lambda u: jnp.asarray(A) @ u,
                                 jnp.asarray(np.array([0., 1., 0., 0.])),
                                 maxiter=50)
    assert np.isfinite(np.asarray(v)).all()
    assert np.isfinite(float(lam))


def test_gmres_nonsymmetric_fp64():
    """GMRES(m) over the framework's XLA CSR matvec vs a dense direct
    solve (solvers/gmres.py; same system class as the BiCGSTAB test)."""
    import jax.numpy as jnp

    from sparsematrixvectormultiplication_tpu.ops.xla import device_put_csr
    from sparsematrixvectormultiplication_tpu.solvers import gmres

    csr, dense = _nonsym_dd_csr()
    rng = np.random.default_rng(1)
    b = rng.standard_normal(csr.nrows)
    x_ref = np.linalg.solve(dense, b)

    d = device_put_csr(csr, dtype=jnp.float64)
    mv = d.spmv
    x, iters, res = gmres(mv, jnp.asarray(b, jnp.float64), tol=1e-10,
                          restart=24, maxiter=600)
    assert 0 < int(iters) < 600, "GMRES did not converge"
    np.testing.assert_allclose(np.asarray(x), x_ref, rtol=1e-6, atol=1e-8)


def test_gmres_restart_tradeoff_and_warm_start():
    """Larger restart must not converge SLOWER in total Arnoldi steps, and
    an exact warm start must exit with zero iterations."""
    import jax.numpy as jnp

    from sparsematrixvectormultiplication_tpu.solvers import gmres

    rng = np.random.default_rng(2)
    n = 150
    a = np.eye(n) * 4 + rng.normal(size=(n, n)) * 0.25
    b = rng.standard_normal(n)
    ad, bd = jnp.asarray(a), jnp.asarray(b)
    mv = lambda v: ad @ v  # noqa: E731
    _, k_small, _ = gmres(mv, bd, restart=8, tol=1e-9, maxiter=2000)
    x, k_big, _ = gmres(mv, bd, restart=64, tol=1e-9, maxiter=2000)
    assert int(k_big) <= int(k_small)
    np.testing.assert_allclose(np.asarray(x), np.linalg.solve(a, b),
                               rtol=1e-6, atol=1e-8)
    x0 = jnp.asarray(np.linalg.solve(a, b))
    _, k0, res0 = gmres(mv, bd, x0=x0, restart=16, tol=1e-8)
    assert int(k0) == 0 and float(res0) < 1e-8 * np.linalg.norm(b) * 10


def test_gmres_f32_tolerance():
    """f32 path: converges to f32-level residual."""
    import jax.numpy as jnp

    from sparsematrixvectormultiplication_tpu.solvers import gmres

    rng = np.random.default_rng(3)
    n = 200
    a = np.eye(n) * 5 + rng.normal(size=(n, n)) * 0.2
    b = rng.standard_normal(n)
    ad = jnp.asarray(a, jnp.float32)
    bd = jnp.asarray(b, jnp.float32)
    mv = lambda v: ad @ v  # noqa: E731
    x, iters, res = gmres(mv, bd, tol=1e-5, restart=32, maxiter=400)
    rel = np.linalg.norm(a @ np.asarray(x, np.float64) - b) / np.linalg.norm(b)
    assert rel < 1e-4, rel


# ---------------------------------------------------------------------------
# Chebyshev polynomial preconditioner (solvers/chebyshev.py)


def _cheb_T(m, x):
    """Chebyshev T_m on/off [-1,1] via the cos/cosh closed form — an oracle
    independent of the solver's three-term rho recurrence."""
    x = np.asarray(x, np.float64)
    out = np.empty_like(x)
    inside = np.abs(x) <= 1.0
    out[inside] = np.cos(m * np.arccos(x[inside]))
    big = ~inside
    out[big] = np.sign(x[big]) ** m * np.cosh(m * np.arccosh(np.abs(x[big])))
    return out


def test_chebyshev_error_polynomial_matches_closed_form():
    """I - p_m(A) A must have eigenvalues T_m((theta-l)/delta)/T_m(theta/delta)
    — the defining minimax property, checked against the cos/cosh closed form
    (not the recurrence)."""
    import jax.numpy as jnp

    from sparsematrixvectormultiplication_tpu.solvers import (
        chebyshev_preconditioner,
    )

    rng = np.random.default_rng(7)
    n, m = 40, 5
    q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    lam = np.linspace(0.5, 12.0, n)
    dense = (q * lam) @ q.T

    lmin, lmax = 0.5, 12.0
    theta, delta = (lmax + lmin) / 2, (lmax - lmin) / 2
    mv = lambda v: jnp.asarray(dense, jnp.float64) @ v  # noqa: E731
    apply_m = chebyshev_preconditioner(mv, lmin, lmax, degree=m)

    # assemble p_m(A) by applying to the identity, columnwise
    cols = [np.asarray(apply_m(jnp.asarray(np.eye(n)[:, j]))) for j in range(n)]
    pa = np.stack(cols, axis=1)
    assert np.allclose(pa, pa.T, atol=1e-10), "p_m(A) must be symmetric"

    err_eigs = np.sort(np.linalg.eigvalsh(np.eye(n) - pa @ dense))
    expect = np.sort(_cheb_T(m, (theta - lam) / delta) / _cheb_T(m, theta / delta))
    np.testing.assert_allclose(err_eigs, expect, atol=1e-9)
    # and the minimax bound itself: uniformly small error on [lmin, lmax]
    assert np.max(np.abs(err_eigs)) < 1.0 / _cheb_T(m, theta / delta) + 1e-9


def test_chebyshev_pcg_beats_plain_cg():
    import jax.numpy as jnp

    from sparsematrixvectormultiplication_tpu.ops.xla import (
        csr_spmv,
        device_put_csr,
    )
    from sparsematrixvectormultiplication_tpu.solvers import (
        cg,
        chebyshev_preconditioner,
        gershgorin_bounds,
    )

    csr, dense = _spd_csr(n=1200, seed=13)
    rng = np.random.default_rng(5)
    b = rng.standard_normal(csr.nrows)
    d = device_put_csr(csr, dtype=jnp.float64)

    def matvec(v):
        return csr_spmv(d.values, d.col_idx, d.row_ids, v, nrows=d.nrows)

    lmin, lmax = gershgorin_bounds(csr)
    assert lmax >= np.linalg.eigvalsh(dense).max() - 1e-8
    prec = chebyshev_preconditioner(matvec, lmin, lmax, degree=4)

    bj = jnp.asarray(b, jnp.float64)
    x_p, it_p, _ = cg(matvec, bj, tol=1e-10, maxiter=3000, prec=prec)
    x_n, it_n, _ = cg(matvec, bj, tol=1e-10, maxiter=3000)
    x_ref = np.linalg.solve(dense, b)
    np.testing.assert_allclose(np.asarray(x_p), x_ref, rtol=1e-6, atol=1e-8)
    assert int(it_p) < int(it_n), f"Cheb-PCG {int(it_p)} !< CG {int(it_n)}"


def test_chebyshev_smooth_reduces_residual_from_x0():
    import jax.numpy as jnp

    from sparsematrixvectormultiplication_tpu.solvers import chebyshev_smooth

    csr, dense = _spd_csr(n=300, seed=17)
    rng = np.random.default_rng(6)
    b = rng.standard_normal(csr.nrows)
    x0 = rng.standard_normal(csr.nrows)
    lam = np.linalg.eigvalsh(dense)
    mv = lambda v: jnp.asarray(dense) @ v  # noqa: E731
    x1 = np.asarray(chebyshev_smooth(mv, jnp.asarray(b), jnp.asarray(x0),
                                     lmin=float(lam[0]), lmax=float(lam[-1]),
                                     degree=6))
    r0 = np.linalg.norm(b - dense @ x0)
    r1 = np.linalg.norm(b - dense @ x1)
    assert r1 < 0.05 * r0, (r0, r1)


def test_gershgorin_bounds_empty_rows_and_validation():
    import pytest

    from sparsematrixvectormultiplication_tpu.formats.coo import COOMatrix
    from sparsematrixvectormultiplication_tpu.solvers import gershgorin_bounds
    from sparsematrixvectormultiplication_tpu.solvers.chebyshev import (
        chebyshev_coefficients,
    )

    # rows 1 and 3 empty; row-abs sums are [3, 0, 7, 0]
    coo = COOMatrix(4, 4,
                    np.array([0, 0, 2, 2], np.int32),
                    np.array([0, 1, 2, 3], np.int32),
                    np.array([1.0, -2.0, 4.0, -3.0]))
    lmin, lmax = gershgorin_bounds(CSRMatrix.from_coo(coo))
    assert lmax == 7.0 and lmin == pytest.approx(7.0 / 30.0)

    with pytest.raises(ValueError):
        chebyshev_coefficients(1.0, 0.5, 3)
    with pytest.raises(ValueError):
        chebyshev_coefficients(0.1, 1.0, 0)


def test_lanczos_extremal_matches_dense_eigh():
    """m-step Lanczos Ritz extremes vs numpy dense eigh on an SPD matrix
    (solvers/lanczos.py — beyond-reference eigensolver capability)."""
    import jax.numpy as jnp

    from sparsematrixvectormultiplication_tpu.ops.xla import (csr_spmv,
                                                               device_put_csr)
    from sparsematrixvectormultiplication_tpu.solvers import lanczos_extremal

    csr, dense = _spd_csr(n=800, seed=11)
    w = np.linalg.eigvalsh(dense)
    d = device_put_csr(csr, dtype=jnp.float64)
    mv = lambda v: csr_spmv(d.values, d.col_idx, d.row_ids, v, nrows=d.nrows)  # noqa: E731

    rng = np.random.default_rng(1)
    v0 = jnp.asarray(rng.standard_normal(csr.nrows), jnp.float64)
    lmin, lmax = lanczos_extremal(mv, v0, m=60)
    # lmax converges fast from above the spectrum's interior; lmin of an
    # SPD-shifted operator converges a little slower — generous rtol there
    np.testing.assert_allclose(lmax, w[-1], rtol=1e-8)
    np.testing.assert_allclose(lmin, w[0], rtol=1e-2)
    # Ritz values are interior to the true spectrum (reorthogonalized)
    assert lmin >= w[0] - 1e-8 * abs(w[0])
    assert lmax <= w[-1] + 1e-8 * abs(w[-1])


def test_lanczos_reorth_keeps_basis_orthogonal():
    import jax.numpy as jnp

    from sparsematrixvectormultiplication_tpu.ops.xla import (csr_spmv,
                                                               device_put_csr)
    from sparsematrixvectormultiplication_tpu.solvers import lanczos

    csr, _ = _spd_csr(n=600, seed=5)
    d = device_put_csr(csr, dtype=jnp.float64)
    rng = np.random.default_rng(2)
    v0 = jnp.asarray(rng.standard_normal(csr.nrows), jnp.float64)
    mv = lambda v: csr_spmv(d.values, d.col_idx, d.row_ids, v, nrows=d.nrows)  # noqa: E731
    _, _, V = lanczos(mv, v0, m=40, reorth=True)
    G = np.asarray(V @ V.T)
    np.testing.assert_allclose(G, np.eye(40), atol=1e-10)


def test_lanczos_breakdown_invariant_subspace():
    """Start vector inside a 2-dim invariant subspace -> breakdown at
    step 2 must freeze cleanly (no NaNs) and still report both
    eigenvalues of the subspace."""
    import jax.numpy as jnp

    from sparsematrixvectormultiplication_tpu.solvers import lanczos_extremal

    n = 64
    diag = np.arange(1.0, n + 1.0)
    A = jnp.asarray(np.diag(diag))
    # v0 spans e_3 and e_7 only -> Krylov space is 2-dimensional
    v0 = np.zeros(n)
    v0[3] = 1.0
    v0[7] = 2.0
    lmin, lmax = lanczos_extremal(lambda v: A @ v, jnp.asarray(v0), m=10)
    np.testing.assert_allclose(lmin, diag[3], rtol=1e-12)
    np.testing.assert_allclose(lmax, diag[7], rtol=1e-12)


def test_lanczos_bounds_feed_chebyshev_pcg():
    """lanczos_bounds must bracket the true spectrum and produce a working
    Chebyshev-PCG setup (tighter than Gershgorin on banded SPD)."""
    import jax.numpy as jnp

    from sparsematrixvectormultiplication_tpu.ops.xla import (csr_spmv,
                                                               device_put_csr)
    from sparsematrixvectormultiplication_tpu.solvers import (
        gershgorin_bounds, lanczos_bounds)

    csr, dense = _spd_csr(n=700, seed=9)
    w = np.linalg.eigvalsh(dense)
    d = device_put_csr(csr, dtype=jnp.float64)
    mv = lambda v: csr_spmv(d.values, d.col_idx, d.row_ids, v, nrows=d.nrows)  # noqa: E731
    lmin, lmax = lanczos_bounds(mv, csr.nrows, m=50, dtype=jnp.float64)
    assert lmax >= w[-1] * 0.999 and lmax <= w[-1] * 1.1
    assert lmin <= w[0] * 1.001
    g_lmin, g_lmax = gershgorin_bounds(csr)
    # the Lanczos lmax bound is tighter than Gershgorin's on this matrix
    assert lmax < g_lmax
