"""chip_smoke.py's phases at tiny sizes on the CPU (the script itself runs
them at full size on a GPU), and its checks' failure paths."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import chip_smoke as cs
from sparsematrixvectormultiplication_tpu.formats.csr import CSRMatrix
from sparsematrixvectormultiplication_tpu.models import synthetic as syn


def test_phase_spmv(capsys):
    cs.phase_spmv(syn.fem_3d(5, 5, 5, dof=3, seed=1), iterations=2)
    out = capsys.readouterr().out
    for dt in ("float32", "bfloat16", "float64"):
        assert f"auto_device_op {dt}" in out
    assert "memory_analysis" in out and "peak_bytes_in_use" in out


@pytest.mark.parametrize("name,gen", [
    ("road_network", lambda: syn.road_network(4000, seed=1)),
    ("webbase_like", lambda: syn.webbase_like(4000, 3, seed=9)),
])
def test_phase_short_rows(name, gen, capsys):
    cs.phase_short_rows(gen(), name)
    assert f"{name} float32: significant diffs 0" in capsys.readouterr().out


def test_phase_cg(capsys):
    cs.phase_cg(8)
    assert "host residual" in capsys.readouterr().out


def test_phase_four_cards(capsys):
    cs.phase_four_cards(syn.fem_3d(6, 6, 6, dof=3, seed=1), 4)
    out = capsys.readouterr().out
    for name in ("spmd_sell", "row_sharded_ell", "ell_2d_psum"):
        assert f"{name} vs oracle: significant diffs 0" in out
        assert f"{name} vs one device: significant diffs 0" in out


def _csr():
    return CSRMatrix.from_coo(syn.banded(400, 6, 20, seed=2))


def test_check_fails_on_wrong_product():
    csr = _csr()
    x = np.ones(csr.ncols)
    ref = csr.spmv(x)
    bad = ref.copy()
    bad[3] += 1.0
    for dt in ("float32", "float64"):
        with pytest.raises(SystemExit, match="FAILED"):
            cs.check("bad", bad, ref, csr, x, dt)


def test_check_fails_on_shape_or_nan():
    csr = _csr()
    x = np.ones(csr.ncols)
    ref = csr.spmv(x)
    with pytest.raises(SystemExit, match="shape"):
        cs.check("short", ref[:-1], ref, csr, x, "float32")
    nan = ref.copy()
    nan[0] = np.nan
    with pytest.raises(SystemExit, match="non-finite"):
        cs.check("nan", nan, ref, csr, x, "float64")


def test_fp64_bound_accepts_reordered_sums():
    """A product summed in another order passes the fp64 round-off bound;
    an f32 result does not."""
    csr = _csr()
    x = np.random.default_rng(0).standard_normal(csr.ncols)
    ref = csr.spmv(x)
    reordered = np.array([np.sum(csr.values[a:b][::-1] * x[csr.col_idx[a:b][::-1]])
                          for a, b in zip(csr.row_ptr[:-1], csr.row_ptr[1:])])
    cs.check("reordered", reordered, ref, csr, x, "float64")
    y32 = np.asarray(jnp.asarray(csr.to_scipy() @ x, jnp.float32) + 1e-3)
    with pytest.raises(SystemExit):
        cs.check("f32 as f64", y32, ref, csr, x, "float64")


def test_phase_device_refuses_cpu():
    assert jax.devices()[0].platform == "cpu"
    with pytest.raises(SystemExit, match="no GPU found"):
        cs.phase_device(False)
