"""Conjugate-gradient solver over the framework's SpMV kernels.

A user of the reference project gets SpMV kernels and a benchmark; a
production framework should also show the kernel as a building block. This
CG runs entirely under ``jit`` — the iteration is a ``lax.while_loop``
whose body is one matvec plus vector updates, so the whole solve is a
single device program (no host round-trip per iteration).

``cg`` takes any jit-compatible matvec; ``cg_sell`` wires in the SELL-C-σ
operator or the XLA CSR kernel by device container type, in the container's
precision (f32, bf16 values, or native f64). CG requires A symmetric
positive-definite — the classic use for the FEM/thermal regimes of the
suite (models/synthetic.py).
"""

from __future__ import annotations

import functools
from typing import Callable

import jax
import jax.numpy as jnp

__all__ = ["cg", "cg_sell", "cg_multi", "jacobi_preconditioner"]


@functools.partial(jax.jit, static_argnames=("matvec", "maxiter", "prec"))
def cg(matvec: Callable, b, x0=None, *, tol: float = 1e-6,
       maxiter: int = 1000, minv=None, prec: Callable | None = None):
    """Solve ``A @ x = b`` for SPD ``A`` given ``matvec(v) -> A @ v``.

    Preconditioning (standard PCG recurrences): pass ``minv`` — a
    diagonal-inverse ARRAY (``z = minv * r``; see
    :func:`jacobi_preconditioner`) traced as a jit argument rather than
    baked into the program as a constant — or ``prec``, an arbitrary
    callable for non-diagonal M^-1 (small captures only). Returns ``(x, iters, resnorm)``; stops when
    ``||r|| <= tol * ||b||`` or after ``maxiter``. All state stays on
    device; the loop compiles once per (shape, dtype, maxiter).
    """
    if x0 is None:
        x0 = jnp.zeros_like(b)
    bnorm = jnp.sqrt(jnp.vdot(b, b).real)
    atol2 = (tol * bnorm) ** 2
    if minv is not None:
        apply_m = lambda r: r * minv.astype(r.dtype)  # noqa: E731
    elif prec is not None:
        apply_m = prec
    else:
        apply_m = lambda r: r  # noqa: E731

    r0 = b - matvec(x0)
    z0 = apply_m(r0)
    p0 = z0
    rz0 = jnp.vdot(r0, z0).real
    rr0 = jnp.vdot(r0, r0).real

    def cond(state):
        _, _, _, _, rr, k = state
        return jnp.logical_and(k < maxiter, rr > atol2)

    def body(state):
        x, r, p, rz, _, k = state
        ap = matvec(p)
        alpha = rz / jnp.vdot(p, ap).real
        x = x + alpha * p
        r = r - alpha * ap
        z = apply_m(r)
        rz_new = jnp.vdot(r, z).real
        p = z + (rz_new / rz) * p
        return x, r, p, rz_new, jnp.vdot(r, r).real, k + 1

    x, r, _, _, rr, k = jax.lax.while_loop(
        cond, body, (x0, r0, p0, rz0, rr0, 0))
    return x, k, jnp.sqrt(rr)


def jacobi_preconditioner(csr, dtype=None):
    """Diagonal (Jacobi) inverse ``1 / diag(A)`` from a host CSRMatrix as
    a device array — pass as ``cg(..., minv=...)`` so it is traced as a
    jit argument, not a closure constant. Zero or
    missing diagonal entries fall back to 1 (identity on those rows)."""
    import numpy as np

    diag = np.zeros(csr.nrows)
    rows = np.repeat(np.arange(csr.nrows), np.diff(csr.row_ptr))
    on_diag = rows == csr.col_idx
    diag[rows[on_diag]] = csr.values[on_diag]
    diag[diag == 0.0] = 1.0
    return jnp.asarray(1.0 / diag, dtype)


@functools.partial(jax.jit, static_argnames=("matmat", "maxiter"))
def cg_multi(matmat: Callable, B, X0=None, *, tol: float = 1e-6,
             maxiter: int = 1000):
    """Solve ``A @ X = B`` for ``B`` of shape (n, k): k independent CG
    iterations sharing ONE multi-RHS matmat per step.

    Every iteration's dominant op is a single ``A @ P`` over all k search
    directions (e.g. ``ops.xla.csr_spmm``), which streams A once instead of
    in k separate memory-bound SpMV sweeps. Per-column
    alpha/beta keep the k systems mathematically independent; converged
    columns freeze (their updates multiply by 0) so one lagging column
    never perturbs the others.

    Returns ``(X, iters, resnorms)`` with ``resnorms`` per column.
    """
    if X0 is None:
        X0 = jnp.zeros_like(B)
    bnorm2 = jnp.sum(B * B, axis=0)
    atol2 = (tol ** 2) * bnorm2

    R0 = B - matmat(X0)
    P0 = R0
    rs0 = jnp.sum(R0 * R0, axis=0)

    def cond(state):
        _, _, _, rs, k = state
        return jnp.logical_and(k < maxiter, jnp.any(rs > atol2))

    def body(state):
        X, R, P, rs, k = state
        live = rs > atol2                       # per-column freeze mask
        AP = matmat(P)
        pap = jnp.sum(P * AP, axis=0)
        alpha = jnp.where(live, rs / jnp.where(pap == 0, 1.0, pap), 0.0)
        X = X + alpha[None, :] * P
        R = R - alpha[None, :] * AP
        rs_new = jnp.sum(R * R, axis=0)
        beta = jnp.where(live, rs_new / jnp.where(rs == 0, 1.0, rs), 0.0)
        P = jnp.where(live[None, :], R + beta[None, :] * P, P)
        rs = jnp.where(live, rs_new, rs)
        return X, R, P, rs, k + 1

    X, R, _, rs, k = jax.lax.while_loop(cond, body, (X0, R0, P0, rs0, 0))
    return X, k, jnp.sqrt(rs)


def cg_sell(dmat, b, x0=None, *, tol: float = 1e-6, maxiter: int = 1000):
    """CG with the framework's device matvecs.

    ``dmat`` is a :class:`..ops.sell.DeviceSell` (the SELL-C-σ operator)
    or a :class:`..ops.xla.DeviceCSR` (XLA segment-sum kernel). ``b`` is a
    dense 1-D array of length ``nrows`` (= ``ncols``: CG needs a square SPD
    matrix); its dtype is the solve's working precision.
    """
    from ..ops.sell import DeviceSell, sell_spmv
    from ..ops.xla import DeviceCSR

    if not isinstance(dmat, (DeviceSell, DeviceCSR)):
        raise TypeError(f"unsupported device matrix {type(dmat).__name__}")
    if dmat.nrows != dmat.ncols:
        raise ValueError("CG needs a square matrix")
    if isinstance(dmat, DeviceSell):
        def matvec(v):
            return sell_spmv(dmat, v).astype(b.dtype)
    else:
        def matvec(v):
            return dmat.spmv(v).astype(b.dtype)

    return cg(matvec, b, x0, tol=tol, maxiter=maxiter)
