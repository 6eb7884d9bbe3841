"""The one place that decides what the device platform allows.

* The library itself is plain XLA and runs on any backend; nothing in it
  branches on the platform.
* Measurement entry points (``bench.py``, the sweep CLI, the device-scale
  sweeps, ``chip_smoke.py``) refuse any device but a GPU, so a CPU run can
  never print a number under a device metric's name.
* The persistent compilation cache lives where ``JAX_COMPILATION_CACHE_DIR``
  says, else in ``.jax_cache/`` at the repository root.
"""

from __future__ import annotations

import os

__all__ = ["require_gpu", "enable_compile_cache", "REPO_ROOT"]

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def require_gpu(what: str) -> None:
    """Exit non-zero unless the default device is a GPU."""
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(
            f"{what}: no GPU found (default device is {dev.platform}, "
            f"{dev.device_kind!r}); measurements run on a GPU only")


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compilation cache and return its directory.

    ``JAX_COMPILATION_CACHE_DIR``, when set, is used as it is; JAX reads it
    itself. Otherwise the cache is ``.jax_cache/`` in the checkout, a fixed
    path so that later runs hit it."""
    import jax

    path = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if not path:
        path = os.path.join(REPO_ROOT, ".jax_cache")
        jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    return path
