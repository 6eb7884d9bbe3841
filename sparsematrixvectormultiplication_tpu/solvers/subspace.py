"""Block subspace (orthogonal) iteration: top-k eigenpairs via SpMM.

``power_iteration`` (solvers/power.py) finds the single dominant
eigenpair with one SpMV per step. Subspace iteration generalizes to the
top ``k``: iterate ``Q <- orth(A @ Q)`` and read the eigenvalues off the
Rayleigh quotient ``Q^T A Q``. Every step's dominant cost is ONE
multi-RHS SpMM over all k basis vectors (``ops.xla.csr_spmm``) — A is
streamed once per step instead of k times.

The reference project has no eigensolver surface at all (its scope ends
at the SpMV benchmark, main.c); this extends the solver layer the same
way cg_multi extends cg.

The iteration runs under ``jit`` as a ``lax.while_loop`` whose body is
one matmat + one thin-QR (jnp.linalg.qr on the (n, k) tall matrix —
XLA-native) + a convergence test on the Ritz-value drift, so the whole
solve is a single device program.
"""

from __future__ import annotations

import functools
from typing import Callable

import jax
import jax.numpy as jnp

__all__ = ["subspace_iteration"]


@functools.partial(jax.jit, static_argnames=("matmat", "maxiter"))
def subspace_iteration(matmat: Callable, Q0, *, tol: float = 1e-9,
                       maxiter: int = 300):
    """Top-k eigenpairs of symmetric ``A`` given ``matmat(V) -> A @ V``.

    ``Q0``: (n, k) starting block (e.g. random normal); it is
    orthonormalized internally. Returns ``(eigvals, Q, iters, res)``
    with ``eigvals`` the k Ritz values (descending |.|), ``Q`` the (n, k)
    orthonormal Ritz basis, and ``res`` the final relative block
    residual ``||A Q - Q H||_F / ||A Q||_F`` (``H = Q^T A Q``) —
    converged when ``res <= tol``. The residual test is honest for
    clustered eigenvalues, where Ritz-value drift goes quiet long before
    the subspace has converged.

    Convergence rate per step for the j-th pair is ``|λ_{k+1}/λ_j|`` —
    like all power-type methods, this wants a spectral gap below the
    sought block.

    For nonsymmetric ``A`` the Ritz values still converge to the dominant
    eigenvalue moduli but lose their variational meaning; use with care.
    """
    Q0, _ = jnp.linalg.qr(Q0)

    def rayleigh(Q, AQ):
        H = Q.T @ AQ
        return 0.5 * (H + H.T)

    def block_res(Q, AQ, H):
        num = jnp.linalg.norm(AQ - Q @ H)
        return num / jnp.maximum(jnp.linalg.norm(AQ), 1e-300)

    AQ0 = matmat(Q0)
    H0 = rayleigh(Q0, AQ0)

    def cond(state):
        Q, AQ, H, it = state
        return jnp.logical_and(it < maxiter, block_res(Q, AQ, H) > tol)

    def body(state):
        Q, AQ, H, it = state
        Q_next, _ = jnp.linalg.qr(AQ)
        AQ_next = matmat(Q_next)
        return Q_next, AQ_next, rayleigh(Q_next, AQ_next), it + 1

    Q, AQ, H, iters = jax.lax.while_loop(cond, body, (Q0, AQ0, H0, 0))
    w = jnp.linalg.eigvalsh(H)
    w = w[jnp.argsort(-jnp.abs(w))]
    return w, Q, iters, block_res(Q, AQ, H)
