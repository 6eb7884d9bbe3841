"""Power iteration and PageRank over the framework matvecs.

PageRank is the production workload of the scattered short-row matrices
(power-law web graphs ≙ webbase-1M in the
reference's sweep, result/result_cuda.csv:11): every iteration is one
SpMV against a column-stochastic operator plus vector work. Same design
rules as the other solvers: one jitted ``lax.while_loop``, static
shapes, no host round-trips per step.
"""

from __future__ import annotations

import functools
from typing import Callable

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["power_iteration", "pagerank", "pagerank_operator"]


@functools.partial(jax.jit, static_argnames=("matvec", "maxiter"))
def power_iteration(matvec: Callable, v0, *, tol: float = 1e-9,
                    maxiter: int = 1000):
    """Dominant eigenpair of ``A`` by normalized power iteration.

    Returns ``(eigval, v, iters)``; stops when the iterate moves less
    than ``tol`` in 2-norm (sign-aligned) or at ``maxiter``.
    """
    v0 = v0 / jnp.linalg.norm(v0)

    def cond(state):
        _, _, delta, k = state
        return jnp.logical_and(k < maxiter, delta > tol)

    def body(state):
        v, _, _, k = state
        w = matvec(v)
        lam = jnp.vdot(v, w).real
        wn = jnp.linalg.norm(w)
        # breakdown guard: A @ v exactly zero (nilpotent A / v in the
        # nullspace) would make w/wn NaN and the NaN delta would end the
        # loop silently — keep v, report lam=0, delta=0 (clean stop)
        broke = wn == 0
        w = jnp.where(broke, v, w / jnp.where(broke, 1.0, wn))
        w = jnp.where(jnp.vdot(w, v).real < 0, -w, w)  # sign-align
        return (w, jnp.where(broke, 0.0, lam),
                jnp.where(broke, 0.0, jnp.linalg.norm(w - v)), k + 1)

    v, lam, _, k = jax.lax.while_loop(
        cond, body, (v0, jnp.zeros((), v0.dtype), jnp.asarray(jnp.inf), 0))
    return lam, v, k


def pagerank_operator(csr, dtype=np.float64):
    """Column-stochastic transition data for :func:`pagerank`.

    Returns ``(csr_t_scaled, dangling)``: ``A^T`` with each original
    row's entries scaled by its WEIGHTED out-degree (so
    ``csr_t_scaled.spmv(p)`` is ``P @ p`` of the weighted random-surfer
    chain), plus the dangling-node mask. Edge weights must be
    non-negative. Host-side, reusing the framework's transpose + CSR
    machinery (formats/csr.py) — upload the result to any kernel layout.
    """
    if np.any(csr.values < 0):
        raise ValueError("pagerank_operator needs non-negative edge "
                         "weights (got negative values; pass |A|)")
    rows = np.repeat(np.arange(csr.nrows), np.diff(csr.row_ptr))
    out_w = np.bincount(rows, weights=csr.values,
                        minlength=csr.nrows).astype(dtype)
    dangling = out_w == 0
    t = csr.transpose()
    # scale every entry by 1/out_weight of its ORIGINAL row = t's column
    vals = t.values / np.where(out_w[t.col_idx] == 0, 1.0, out_w[t.col_idx])
    t = type(t)(t.nrows, t.ncols, t.row_ptr, t.col_idx, vals.astype(dtype))
    return t, dangling


@functools.partial(jax.jit, static_argnames=("matvec", "maxiter"))
def pagerank(matvec: Callable, dangling, *, alpha: float = 0.85,
             tol: float = 1e-10, maxiter: int = 500):
    """PageRank by power iteration on the Google matrix.

    ``matvec(p) -> P @ p`` is the column-stochastic transition operator
    (from :func:`pagerank_operator`, through any framework kernel);
    ``dangling`` is its boolean mask. Returns ``(p, iters, delta)`` with
    ``p`` summing to 1; stops at L1 movement ``<= tol``.
    """
    n = dangling.shape[0]
    p0 = jnp.full((n,), 1.0 / n)
    teleport = (1.0 - alpha) / n
    d = dangling.astype(p0.dtype)

    def cond(state):
        _, delta, k = state
        return jnp.logical_and(k < maxiter, delta > tol)

    def body(state):
        p, _, k = state
        leaked = jnp.vdot(d, p)  # dangling mass redistributes uniformly
        q = alpha * (matvec(p) + leaked / n) + teleport
        return q, jnp.sum(jnp.abs(q - p)), k + 1

    p, delta, k = jax.lax.while_loop(
        cond, body, (p0, jnp.asarray(jnp.inf, p0.dtype), 0))
    return p, k, delta
