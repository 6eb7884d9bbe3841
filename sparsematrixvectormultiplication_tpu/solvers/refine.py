"""Mixed-precision iterative refinement: low-precision solves, full
accuracy.

The classic Wilkinson scheme in its modern mixed-precision form (Carson &
Higham, SIAM J. Sci. Comput. 2018): solve ``A @ x = b`` by repeating

    r_k = b - A @ x_k          (HIGH precision)
    d_k = inner_solve(r_k)     (LOW precision — cheap, approximate)
    x_{k+1} = x_k + d_k

The error contracts by roughly the inner solve's relative accuracy each
sweep, so a handful of sweeps over a crude solver reach the residual
precision's accuracy floor.

This is the composition the framework's precision ladder exists for:

- **inner**: CG over bf16 or f32 values (``device_put_sell(sell,
  jnp.bfloat16)`` streams a quarter of the fp64 value bytes) at a loose
  tolerance;
- **residual**: the SELL operator in native fp64 on the device
  (``device_put_sell(sell, jnp.float64)``, with ``jax_enable_x64``) or the
  host fp64 oracle (formats/csr.py CSRMatrix.spmv).

The reference project runs everything in fp64 (cuda_src/csr_matrix_cuda.cu:
96-148); refinement buys fp64-level answers while most products stream
fewer bytes.

The outer loop runs on the host: refinement converges in a few sweeps and
each inner solve is already one compiled device program (solvers/cg.py),
so there is no per-iteration launch overhead worth fusing.
"""

from __future__ import annotations

from typing import Callable

import numpy as np

__all__ = ["iterative_refinement"]


def iterative_refinement(
    inner_solve: Callable,
    matvec_hi: Callable,
    b,
    x0=None,
    *,
    tol: float = 1e-12,
    max_sweeps: int = 20,
):
    """Solve ``A @ x = b`` by iterative refinement.

    ``inner_solve(r) -> d``: approximate correction solve in working (low)
    precision — e.g. ``lambda r: cg(matvec_bf16, jnp.asarray(r,
    jnp.float32), tol=1e-2, maxiter=50)[0]``. Accuracy only affects the
    contraction RATE; any solver that reduces the error works.

    ``matvec_hi(x) -> A @ x``: residual-precision matvec. The refinement
    floor is set by THIS precision (the fp64 device operator or the host
    fp64 CSR oracle).

    ``b``, ``x0``, and all outer-loop state are numpy fp64.

    Returns ``(x, sweeps, resnorms)`` — ``resnorms[k]`` is
    ``||b - A x_k|| / ||b||`` BEFORE sweep ``k`` (so ``resnorms[0]`` is
    the starting residual and the last entry is the final one). Stops
    when the relative residual reaches ``tol``, after ``max_sweeps``, or
    when a sweep fails to shrink the residual (stagnation at the
    precision floor).
    """
    b = np.asarray(b, np.float64)
    bnorm = float(np.linalg.norm(b))
    if bnorm == 0.0:
        return np.zeros_like(b), 0, [0.0]
    x = (np.zeros_like(b) if x0 is None
         else np.asarray(x0, np.float64).copy())

    resnorms = []
    for sweep in range(max_sweeps):
        r = b - np.asarray(matvec_hi(x), np.float64)
        rel = float(np.linalg.norm(r)) / bnorm
        resnorms.append(rel)
        if rel <= tol:
            return x, sweep, resnorms
        if sweep >= 2 and rel >= 0.9 * resnorms[-2]:
            # stagnated: <10% improvement over a full sweep means the
            # residual-precision floor (or a non-contracting inner solve);
            # slow-but-steady inner solves (any contraction >=1.12x/sweep)
            # keep refining — "any solver that reduces the error works"
            return x, sweep, resnorms
        d = np.asarray(inner_solve(r), np.float64)
        x = x + d

    r = b - np.asarray(matvec_hi(x), np.float64)
    resnorms.append(float(np.linalg.norm(r)) / bnorm)
    return x, max_sweeps, resnorms
