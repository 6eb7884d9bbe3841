"""Device-scale sweep (bench/scale.py run_path_scale_sweep).

The sweep covers the row-sharded SELL and ELL paths, with the ELL curve
filling the reference CSV's hll column family. These tests run each path
at 1-2 virtual CPU devices on tiny matrices and check (a) the result
validates against the fp64 oracle and (b) the rows land in the documented
openmp-schema columns (src/utility.c:114-120 layout).
"""

import csv

import numpy as np
import pytest

from sparsematrixvectormultiplication_tpu.bench.scale import (
    run_path_scale_sweep,
)
from sparsematrixvectormultiplication_tpu.formats.csr import CSRMatrix
from sparsematrixvectormultiplication_tpu.models.synthetic import (
    banded,
    road_network,
)


def _csr(kind):
    if kind == "banded":
        return CSRMatrix.from_coo(banded(4096, 6, 64, seed=1))
    coo = road_network(8192, seed=2)
    csr = CSRMatrix.from_coo(coo)
    csr_k, _ = csr.split_heavy_rows(1024)
    return csr_k


def _rows(path):
    with open(path) as f:
        return list(csv.reader(f))


HDR = None


def _col(rows, name):
    return rows[0].index(name)


@pytest.mark.parametrize("path_name,kind", [
    ("sell", "banded"),
    ("hll", "banded"),
    ("sell", "road"),
    ("hll", "road"),
])
def test_path_scale_sweep_validates(path_name, kind, tmp_path):
    csr = _csr(kind)
    out = str(tmp_path / "scale.csv")
    results = run_path_scale_sweep(
        "tiny", csr, out, path_name, device_counts=[1, 2],
        iterations=2, rounds=1, allow_cpu=True, log=lambda m: None)
    assert len(results) == 2
    for n, sec, gf, dm in results:
        assert dm.significant_diffs == 0
        assert sec > 0 and gf > 0

    rows = _rows(out)
    assert len(rows) == 3  # header + 2 device counts
    # the curve lands in the documented column family
    tcol = _col(rows, "time_parallel_hll" if path_name == "hll"
                else "time_parallel")
    ecol = _col(rows, "efficiency_hll" if path_name == "hll"
                else "efficiency_parallel")
    for r in rows[1:]:
        assert r[0] == f"tiny[{path_name}]"
        assert float(r[tcol]) > 0
        assert float(r[ecol]) > 0
    # num_threads column records the device count
    ncol = _col(rows, "num_threads")
    assert [r[ncol] for r in rows[1:]] == ["1", "2"]


def test_hll_role_fills_hll_columns_only(tmp_path):
    csr = _csr("banded")
    out = str(tmp_path / "scale.csv")
    run_path_scale_sweep("tiny", csr, out, "hll", device_counts=[1],
                         iterations=2, rounds=1, allow_cpu=True,
                         log=lambda m: None)
    rows = _rows(out)
    r = rows[1]
    assert float(r[_col(rows, "time_parallel_hll")]) > 0
    # the parallel (CSR-kernel) family stays zero for the hll curve
    assert float(r[_col(rows, "time_parallel")]) == 0.0
    assert float(r[_col(rows, "flops_parallel")]) == 0.0


def test_sell_path_splits_heavy_rows(tmp_path):
    """A power-law head is split into segments inside every shard, and the
    sweep's result is reduced back to natural rows."""
    from sparsematrixvectormultiplication_tpu.models.synthetic import (
        power_law,
    )

    csr = CSRMatrix.from_coo(power_law(2048, avg_nnz_per_row=6, seed=5))
    assert int(csr.row_nnz().max()) > 256  # a real power-law head
    results = run_path_scale_sweep(
        "pl_probe", csr, str(tmp_path / "s.csv"), "sell",
        device_counts=[1, 4], iterations=2, rounds=1, allow_cpu=True,
        log=lambda m: None)
    assert [r[0] for r in results] == [1, 4]
    assert all(dm.significant_diffs == 0 for _, _, _, dm in results)


def test_scale_sweep_refuses_cpu(tmp_path):
    """A measurement path: without allow_cpu it exits on a CPU device."""
    with pytest.raises(SystemExit, match="no GPU"):
        run_path_scale_sweep("tiny", _csr("banded"), str(tmp_path / "s.csv"),
                             "sell", device_counts=[1], log=lambda m: None)
