"""Lanczos tridiagonalization and extremal-eigenvalue estimation.

Beyond-reference capability (the reference stops at SpMV itself): the
m-step Lanczos process is the canonical *consumer* of a fast symmetric
SpMV — every step is one matvec plus vector work, so the SELL operator
is the hot path. Extremal Ritz values converge far faster
than power iteration (``solvers/power.py``) and give much tighter
spectral bounds for the Chebyshev preconditioner than Gershgorin discs
(``solvers/chebyshev.py:37``), which over-estimate ``lmax`` by the full
off-diagonal mass.

Same design rules as the other solvers: one jitted ``lax.scan`` with a
STATIC step count (XLA traces once; no data-dependent Python control
flow), static shapes throughout, no host round-trips per step. Full
reorthogonalization is a flag — it keeps the Krylov basis resident as an
``(m, n)`` buffer updated with ``lax.dynamic_update_slice`` and costs one
(m, n) @ (n,) matmul per step (cheap next to the SpMV for the sparse
operators this framework targets).
"""

from __future__ import annotations

import functools
from typing import Callable

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["lanczos", "lanczos_extremal", "lanczos_bounds"]


@functools.partial(jax.jit, static_argnames=("matvec", "m", "reorth"))
def lanczos(matvec: Callable, v0, *, m: int = 30, reorth: bool = True):
    """m-step Lanczos: ``A @ V[:k] ≈ V[:k] @ T`` with T tridiagonal.

    Parameters
    ----------
    matvec : the symmetric operator ``v -> A @ v`` (any framework matvec:
        a SELL operator, a ``DeviceCSR.spmv`` closure, ...).
    v0 : start vector, any nonzero vector of size n.
    m : number of Lanczos steps (static — the scan is traced once).
    reorth : full reorthogonalization against the stored basis each step.
        Off, the classic three-term recurrence loses orthogonality once
        Ritz values converge; on, the basis stays orthogonal to fp eps.

    Returns ``(alpha, beta, V)``: diagonal ``alpha (m,)``, off-diagonal
    ``beta (m,)`` (``beta[m-1]`` is the residual norm of the last step),
    and the basis ``V (m, n)``.
    """
    n = v0.shape[0]
    dt = v0.dtype
    v = v0 / jnp.linalg.norm(v0)
    V0 = jnp.zeros((m, n), dt).at[0].set(v)

    def step(carry, k):
        V, v, v_prev, beta_prev = carry
        w = matvec(v)
        alpha = jnp.vdot(v, w)
        w = w - alpha * v - beta_prev * v_prev
        if reorth:
            # project out the whole stored basis (rows >= k+1 are zero,
            # so the masked matmul is safe at every step)
            coeffs = V @ w
            w = w - V.T @ coeffs
        beta = jnp.linalg.norm(w)
        # guard breakdown (invariant subspace found): keep the basis
        # frozen instead of dividing by ~0
        safe = beta > 10 * jnp.finfo(dt).eps * jnp.abs(alpha)
        v_next = jnp.where(safe, w / jnp.where(safe, beta, 1.0), v)
        V = jax.lax.cond(
            k + 1 < m,
            lambda V: jax.lax.dynamic_update_slice(V, v_next[None, :], (k + 1, 0)),
            lambda V: V,
            V,
        )
        return (V, v_next, v, beta), (alpha, beta)

    (V, _, _, _), (alphas, betas) = jax.lax.scan(
        step, (V0, v, jnp.zeros_like(v), jnp.zeros((), dt)), jnp.arange(m))
    return alphas, betas, V


def lanczos_extremal(matvec: Callable, v0, *, m: int = 30,
                     reorth: bool = True):
    """Extremal eigenvalue estimates ``(lmin, lmax)`` of symmetric A.

    Runs m Lanczos steps and takes the extremal eigenvalues of the
    tridiagonal Rayleigh quotient (host-side ``eigh_tridiagonal`` on the
    tiny (m, m) system — the device does only the m SpMVs).
    """
    alphas, betas, _ = lanczos(matvec, v0, m=m, reorth=reorth)
    a = np.asarray(alphas, np.float64)
    b = np.asarray(betas, np.float64)[:-1]
    # a breakdown step freezes the recurrence; truncate T there so the
    # repeated frozen alphas don't duplicate Ritz values
    eps = np.finfo(np.float64).eps
    cut = np.nonzero(b <= 10 * eps * np.abs(a[:-1]))[0]
    if cut.size:
        k = int(cut[0]) + 1
        a, b = a[:k], b[: k - 1]
    import scipy.linalg as sla

    w = sla.eigh_tridiagonal(a, b, eigvals_only=True)
    return float(w[0]), float(w[-1])


def lanczos_bounds(matvec: Callable, n: int, *, m: int = 30, seed: int = 0,
                   dtype=jnp.float32, safety: float = 1.05):
    """Chebyshev-ready spectral bounds from a short Lanczos run.

    Drop-in alternative to ``gershgorin_bounds`` (chebyshev.py:37) that
    needs only the operator, not the CSR: returns ``(lmin, lmax)`` with a
    multiplicative ``safety`` margin on ``lmax`` and the matching
    division on ``lmin`` (Ritz values under-estimate the true extremes).
    ``lmin`` is floored at ``lmax / 1e6`` so the bounds stay usable for
    indefinite-looking estimates on nearly-singular SPD operators.
    """
    rng = np.random.default_rng(seed)
    v0 = jnp.asarray(rng.standard_normal(n), dtype)
    lmin, lmax = lanczos_extremal(matvec, v0, m=m)
    lmax = lmax * safety
    lmin = max(lmin / safety, lmax / 1e6)
    return lmin, lmax
