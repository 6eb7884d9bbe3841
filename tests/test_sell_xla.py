"""The SELL-C-σ operator (ops/sell.py) against the fp64 oracle: every
synthetic family and every edge case, at f32, bf16 values and f64."""

import jax.numpy as jnp
import numpy as np
import pytest
from sell_cases import DTYPES, EDGES, FAMILIES, check_product

from sparsematrixvectormultiplication_tpu.formats.csr import CSRMatrix
from sparsematrixvectormultiplication_tpu.formats.sell import SellMatrix
from sparsematrixvectormultiplication_tpu.ops import sell as ops_sell


def _run(coo, dtype):
    csr = CSRMatrix.from_coo(coo)
    x = np.random.default_rng(0).standard_normal(csr.ncols)
    d = ops_sell.device_put_sell(SellMatrix.from_csr(csr), jnp.dtype(dtype))
    xd = jnp.asarray(x, jnp.float64 if dtype == "float64" else jnp.float32)
    y = ops_sell.sell_spmv(d, xd)
    assert y.dtype == (jnp.float64 if dtype == "float64" else jnp.float32)
    check_product(y, csr, np.asarray(xd, np.float64), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_xla_families(family, dtype):
    _run(FAMILIES[family](), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", sorted(EDGES))
def test_xla_edge_cases(case, dtype):
    _run(EDGES[case](), dtype)


def test_index_planes_stay_int32_under_x64():
    import jax

    assert jax.config.jax_enable_x64
    csr = CSRMatrix.from_coo(FAMILIES["banded"]())
    d = ops_sell.device_put_sell(SellMatrix.from_csr(csr), jnp.float64)
    for cols, _, rows in d.bins:
        assert cols.dtype == jnp.int32 and rows.dtype == jnp.int32
    assert d.seg_owner.dtype == jnp.int32
