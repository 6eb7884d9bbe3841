"""Profiling hooks — the analogue of the reference's `-lineinfo` + nvprof
workflow (CMakeLists.txt:49, SURVEY §5 tracing).

Wraps `jax.profiler` so any bench stage can emit a TensorBoard-readable trace:

    with profile_trace("/tmp/spmv_trace"):
        sell_spmv(dsell, x)

The CLI exposes this as ``--profile-dir`` (one trace per matrix).
"""

from __future__ import annotations

import contextlib
import os

__all__ = ["profile_trace", "annotate"]


@contextlib.contextmanager
def profile_trace(log_dir: str | None):
    """Capture a device trace into ``log_dir`` (no-op when None)."""
    if not log_dir:
        yield
        return
    import jax

    os.makedirs(log_dir, exist_ok=True)
    with jax.profiler.trace(log_dir):
        yield


def annotate(name: str):
    """Named trace span (≙ a labeled cudaEvent region)."""
    import jax

    return jax.profiler.TraceAnnotation(name)
