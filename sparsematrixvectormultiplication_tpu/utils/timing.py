"""Device timing — the analogue of the reference's cudaEvent pairs
(main_cuda.cu:88-90,163-180).

Dispatch is asynchronous, so every timed region ends in
``jax.block_until_ready``. :func:`time_device_fn_batched` runs ``reps``
calls chained inside one jitted loop, so one product's time is not
dominated by the host's per-call dispatch cost — the framework's version
of the reference's 100-iteration loops (main.c:20 NUM_ITERATION).
"""

from __future__ import annotations

import time

import jax
import jax.numpy as jnp

__all__ = ["time_device_fn_batched", "chained_calls", "run_device_validated",
           "ITERATION_SKIP"]

ITERATION_SKIP = 5  # warm-up iterations to skip (≙ reference utility.h:7)

# a NaN payload no kernel produces: comparing against it is false at run
# time, but the compiler cannot know that
_IMPOSSIBLE = 0x7F123457


def _chain_leaf(flat) -> int | None:
    """Index of the argument leaf the loop perturbs: the last inexact array
    (for ``(matrix, x)`` that is ``x``), else the last numeric one."""
    for kinds in (jnp.inexact, jnp.number):
        for i in range(len(flat) - 1, -1, -1):
            leaf = flat[i]
            if hasattr(leaf, "dtype") and getattr(leaf, "ndim", 0) > 0 \
                    and jnp.issubdtype(leaf.dtype, kinds):
                return i
    return None


def _runtime_zero(out):
    """0 computed from ``out`` in a way the compiler cannot fold."""
    out0 = out[0] if isinstance(out, tuple) else out
    s = out0.reshape(-1)[0]
    bits = jax.lax.bitcast_convert_type(s.astype(jnp.float32), jnp.int32)
    return s, jnp.where(bits == _IMPOSSIBLE, 1, 0)


def chained_calls(fn, *args, reps: int):
    """The jitted loop :func:`time_device_fn_batched` times: ``reps`` calls
    of ``fn(*args)`` in one ``fori_loop``, returning the last output.

    A loop whose body ignored its carry would let XLA hoist the
    loop-invariant call out of the loop; so each iteration adds a runtime
    zero derived from the previous output to element 0 of one input (for
    ``(matrix, x)`` that is ``x``). The update is in place on the loop's
    carried copy of that input: the one copy of it is made before the loop,
    not in every iteration (``tests/test_bench.py`` checks the compiled
    program). This makes the chain sequential and leaves results
    bit-identical. The whole output is carried through the loop and
    returned, so no part of any call's work is dead code XLA could drop.
    """
    flat, treedef = jax.tree_util.tree_flatten(args)
    idx = _chain_leaf(flat)

    @jax.jit
    def chained(*a):
        flat0, _ = jax.tree_util.tree_flatten(a)
        leaf0 = flat0[idx] if idx is not None else jnp.zeros(1)
        out0 = jax.tree_util.tree_map(lambda s: jnp.zeros(s.shape, s.dtype),
                                      jax.eval_shape(fn, *a))

        def body(_, carry):
            leaf, _ = carry
            cur = list(flat0)
            if idx is not None:
                cur[idx] = leaf
            out = fn(*jax.tree_util.tree_unflatten(treedef, cur))
            _, z = _runtime_zero(out)
            return leaf.at[0].add(z.astype(leaf.dtype)), out

        return jax.lax.fori_loop(0, reps, body, (leaf0, out0))[1]

    return chained


def time_device_fn_batched(fn, *args, reps: int = 20, rounds: int = 3):
    """Seconds per call of ``fn(*args)``, best of ``rounds``.

    Each round runs :func:`chained_calls` once (``reps`` calls) and ends
    in ``block_until_ready``. Returns ``(best_seconds_per_call, per-round
    list)``.
    """
    chained = chained_calls(fn, *args, reps=reps)
    jax.block_until_ready(chained(*args))  # compile + warm up
    times = []
    for _ in range(rounds):
        t0 = time.perf_counter()
        jax.block_until_ready(chained(*args))
        times.append((time.perf_counter() - t0) / reps)
    return min(times), times


def run_device_validated(fn, *args, y_ref, reps: int = 16):
    """Per-iteration validation without host copies (≙ the reference's
    in-loop ``checkResult`` on every timed iteration, main_cuda.cu:183-188):
    ``reps`` chained calls keep the running max ``|out - y_ref|`` on the
    device and one scalar is read back at the end.

    Returns ``(max_abs_diff_across_reps, seconds_per_rep)``; the seconds
    include the compare, so callers can report its overhead against the
    plain timed chain.
    """
    y_ref = jnp.asarray(y_ref)
    flat, treedef = jax.tree_util.tree_flatten(args)
    idx = _chain_leaf(flat)

    @jax.jit
    def chained(y_r, *a):
        flat0, _ = jax.tree_util.tree_flatten(a)
        leaf0 = flat0[idx] if idx is not None else jnp.zeros(1)

        def body(_, carry):
            leaf, worst = carry
            cur = list(flat0)
            if idx is not None:
                cur[idx] = leaf
            out = fn(*jax.tree_util.tree_unflatten(treedef, cur))
            out0 = out[0] if isinstance(out, tuple) else out
            d = jnp.max(jnp.abs(out0.reshape(-1)[: y_r.size]
                                - y_r.reshape(-1).astype(out0.dtype)))
            # worst >= 0, so this is a runtime zero the compiler cannot fold
            z = jnp.where(worst < -1.0, 1, 0)
            leaf = leaf.at[0].add(z.astype(leaf.dtype))
            return leaf, jnp.maximum(worst, d.astype(jnp.float32))

        return jax.lax.fori_loop(0, reps, body, (leaf0, jnp.float32(0)))[1]

    jax.block_until_ready(chained(y_ref, *args))  # compile
    t0 = time.perf_counter()
    worst = float(jax.block_until_ready(chained(y_ref, *args)))
    return worst, (time.perf_counter() - t0) / reps
