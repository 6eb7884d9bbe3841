"""The SELL operator as XLA compiles it for the card, against the fp64
oracle. These tests skip without a GPU; run them on one with

    JAX_PLATFORMS=cuda python -m pytest tests/test_gpu.py -m gpu
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from sell_cases import DTYPES, EDGES, FAMILIES, check_product

from sparsematrixvectormultiplication_tpu.formats.csr import CSRMatrix
from sparsematrixvectormultiplication_tpu.formats.sell import SellMatrix
from sparsematrixvectormultiplication_tpu.ops.sell import (
    device_put_sell,
    sell_spmv,
)

pytestmark = pytest.mark.gpu


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", ["fem_3d", "power_law", "road_network",
                                  "single_heavy_row", "empty_matrix"])
def test_compiled_operator_matches_oracle(gpu, case, dtype):
    coo = {**FAMILIES, **EDGES}[case]()
    csr = CSRMatrix.from_coo(coo)
    x = np.random.default_rng(0).standard_normal(csr.ncols)
    d = device_put_sell(SellMatrix.from_csr(csr), jnp.dtype(dtype))
    xd = jnp.asarray(x, jnp.float64 if dtype == "float64" else jnp.float32)
    check_product(sell_spmv(d, xd), csr, np.asarray(xd, np.float64), dtype)


def test_spmd_sell_on_every_gpu(gpu):
    from sparsematrixvectormultiplication_tpu.parallel.sharding import (
        make_mesh,
    )
    from sparsematrixvectormultiplication_tpu.parallel.spmd_sell import (
        build_spmd_sell,
        sell_spmv_spmd,
    )

    n = len(jax.devices())
    csr = CSRMatrix.from_coo(FAMILIES["dense_rows_mix"]())
    mesh = make_mesh(n, ("rows",))
    spmd = build_spmd_sell(csr, n, mesh=mesh, dtype=jnp.float64)
    x = np.random.default_rng(1).standard_normal(csr.ncols)
    check_product(sell_spmv_spmd(spmd, x, mesh), csr, x, "float64")
