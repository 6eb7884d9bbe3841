"""Test configuration: the CPU backend with 8 virtual devices, and x64.

Multi-device CPU meshes come from jax_num_cpu_devices (SURVEY §4:
multi-device tests on virtual CPU meshes). ``JAX_PLATFORMS``, when set,
picks the backend instead, so the GPU tests run on a machine with a GPU:

    JAX_PLATFORMS=cuda python -m pytest tests/ -m gpu

Those tests carry the ``gpu`` marker and take the ``gpu`` fixture, which
skips them when the process has no GPU; the check runs when a test runs,
never while a module is imported.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

if not os.environ.get("JAX_PLATFORMS"):
    jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_num_cpu_devices", 8)
jax.config.update("jax_enable_x64", True)
# persistent compile cache for the CPU test compilations
jax.config.update("jax_compilation_cache_dir",
                  os.path.join(os.path.dirname(os.path.dirname(
                      os.path.abspath(__file__))), ".jax_cache_cpu"))
jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def rng():
    return np.random.default_rng(1234)


def random_coo(rng, nrows, ncols, density=0.05):
    """Random COO with duplicate-free coordinates."""
    import scipy.sparse as sp

    from sparsematrixvectormultiplication_tpu import COOMatrix

    s = sp.random(
        nrows,
        ncols,
        density=density,
        random_state=np.random.RandomState(int(rng.integers(0, 2**31))),
        format="coo",
    )
    return COOMatrix(nrows, ncols, s.row, s.col, s.data), s


@pytest.fixture
def make_random_coo(rng):
    def _make(nrows, ncols, density=0.05):
        return random_coo(rng, nrows, ncols, density)

    return _make


@pytest.fixture
def gpu():
    """Skip the test unless the default device is a GPU."""
    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs a GPU: JAX_PLATFORMS=cuda python -m pytest -m gpu")
