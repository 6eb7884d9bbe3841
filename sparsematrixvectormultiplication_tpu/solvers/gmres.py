"""Restarted GMRES(m) — general nonsymmetric systems, fully jitted.

Completes the Krylov family next to :mod:`.cg` (SPD) and
:mod:`.bicgstab` (nonsymmetric, short recurrence): GMRES minimizes the
residual over the full Krylov subspace, the standard choice when
BiCGSTAB's irregular convergence is a problem.  Same design rules as the
other solvers (docs/DESIGN.md XLA semantics): one device program — an
outer ``lax.while_loop`` over restart cycles whose body runs ``m``
Arnoldi steps in a ``lax.fori_loop`` with STATIC shapes — the basis
``V`` is a fixed ``(m+1, n)`` array, orthogonalization is a masked
matmul against the whole basis (two (m+1,n)×(n,) products per step),
and the Hessenberg least-squares is carried by Givens
rotations so the in-cycle residual is available as ``|g[j+1]|`` with no
extra matvec.

Early convergence inside a cycle freezes further updates by flag
(``lax.cond``-free ``where`` masking keeps every step identical for the
compiler); the final triangular solve pads frozen columns with an
identity diagonal and a zero rhs so their solution components vanish.
"""

from __future__ import annotations

import functools
from typing import Callable

import jax
import jax.numpy as jnp

__all__ = ["gmres"]

_EPS = 1e-30


def _cycle(matvec, x0, r0, m, atol):
    """One GMRES(m) cycle from residual ``r0``. Returns (x, resnorm, steps)."""
    n = r0.shape[0]
    dt = r0.dtype
    beta = jnp.sqrt(jnp.vdot(r0, r0).real).astype(dt)
    unit = r0 / jnp.maximum(beta, _EPS)

    V = jnp.zeros((m + 1, n), dt).at[0].set(unit)
    H = jnp.zeros((m + 1, m), dt)          # rotated columns (R factor + 0s)
    cs = jnp.zeros((m,), dt)
    sn = jnp.zeros((m,), dt)
    g = jnp.zeros((m + 1,), dt).at[0].set(beta)
    active0 = beta > atol                   # x0 may already be converged

    def step(j, carry):
        V, H, cs, sn, g, active, steps = carry
        w = matvec(V[j])
        # modified-Gram-Schmidt as two masked full-basis products: rows of V
        # beyond j are zero (never written), so the mask only has to stop
        # REUSE of stale slots, which are zero too — one product suffices.
        h = V @ w                                       # (m+1,)
        rowmask = jnp.arange(m + 1) <= j
        h = jnp.where(rowmask, h, 0.0)
        w = w - h @ V
        # one re-orthogonalization pass (classical GS is unstable unrepeated)
        h2 = jnp.where(rowmask, V @ w, 0.0)
        w = w - h2 @ V
        h = h + h2
        hj1 = jnp.sqrt(jnp.vdot(w, w).real).astype(dt)
        V = V.at[j + 1].set(jnp.where(active, w / jnp.maximum(hj1, _EPS),
                                      V[j + 1]))
        # apply the j previous Givens rotations to the new column
        def rot(i, hc):
            hi, hi1 = hc[i], hc[i + 1]
            return hc.at[i].set(cs[i] * hi + sn[i] * hi1) \
                     .at[i + 1].set(-sn[i] * hi + cs[i] * hi1)
        hcol = jax.lax.fori_loop(0, j, rot, h.at[j + 1].set(hj1))
        # new rotation annihilating hcol[j+1]
        denom = jnp.sqrt(hcol[j] ** 2 + hcol[j + 1] ** 2)
        c = jnp.where(denom > _EPS, hcol[j] / jnp.maximum(denom, _EPS), 1.0)
        s = jnp.where(denom > _EPS, hcol[j + 1] / jnp.maximum(denom, _EPS), 0.0)
        hcol = hcol.at[j].set(c * hcol[j] + s * hcol[j + 1]).at[j + 1].set(0.0)
        gj = g[j]
        g_new = g.at[j].set(c * gj).at[j + 1].set(-s * gj)

        H = H.at[:, j].set(jnp.where(active, hcol, H[:, j]))
        cs = cs.at[j].set(jnp.where(active, c, cs[j]))
        sn = sn.at[j].set(jnp.where(active, s, sn[j]))
        g = jnp.where(active, g_new, g)
        steps = steps + jnp.where(active, 1, 0)
        # converged or happy breakdown (hj1 ~ 0): freeze remaining steps
        active = active & (jnp.abs(g[j + 1]) > atol) & (hj1 > _EPS * 10)
        return V, H, cs, sn, g, active, steps

    V, H, cs, sn, g, _, steps = jax.lax.fori_loop(
        0, m, step, (V, H, cs, sn, g, active0, jnp.zeros((), jnp.int32)))

    # R y = g over the active leading block; frozen columns get an identity
    # diagonal and zero rhs, so y vanishes there.
    taken = jnp.arange(m) < steps
    R = H[:m, :]
    R = jnp.where(jnp.logical_or(taken[None, :], taken[:, None]), R,
                  jnp.eye(m, dtype=dt))
    R = R + jnp.where(jnp.abs(jnp.diagonal(R)) < _EPS,
                      _EPS, 0.0) * jnp.eye(m, dtype=dt)
    rhs = jnp.where(taken, g[:m], 0.0)
    y = jax.scipy.linalg.solve_triangular(R, rhs, lower=False)
    x = x0 + y @ V[:m]
    return x, jnp.abs(g[jnp.minimum(steps, m)]), steps


@functools.partial(jax.jit, static_argnames=("matvec", "restart", "maxiter"))
def gmres(matvec: Callable, b, x0=None, *, tol: float = 1e-6,
          restart: int = 32, maxiter: int = 1000):
    """Solve ``A @ x = b`` for general ``A`` given ``matvec(v) -> A @ v``.

    Returns ``(x, iters, resnorm)``; stops when ``||r|| <= tol * ||b||``
    or after ``maxiter`` total Arnoldi steps. ``restart`` is the cycle
    length ``m`` (memory: an ``(m+1, n)`` basis stays device-resident).
    """
    if x0 is None:
        x0 = jnp.zeros_like(b)
    m = int(restart)
    bnorm = jnp.sqrt(jnp.vdot(b, b).real)
    atol = (tol * bnorm).astype(b.dtype)

    r0 = b - matvec(x0)

    def cond(state):
        _, r, k = state
        rn = jnp.sqrt(jnp.vdot(r, r).real)
        return jnp.logical_and(k < maxiter, rn > atol)

    def body(state):
        x, r, k = state
        x, _, steps = _cycle(matvec, x, r, m, atol)
        r = b - matvec(x)  # recomputed: restarts must not inherit drift
        return x, r, k + jnp.maximum(steps, 1)

    x, r, k = jax.lax.while_loop(cond, body, (x0, r0, jnp.zeros((), jnp.int32)))
    return x, k, jnp.sqrt(jnp.vdot(r, r).real)
