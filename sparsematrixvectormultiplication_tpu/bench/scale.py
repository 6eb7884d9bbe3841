"""Device-count scaling sweep — the reference's thread-count axis on devices.

The reference sweeps OpenMP thread counts {2,4,8,16,32,40} per matrix and
reports speedup/efficiency columns (main.c:18,172-459; 33-column CSV
src/utility.c:114-120). The analogous axis here is the device count: the
row-sharded SELL operator (parallel/spmd_sell.py, path ``"sell"``) or the
row-sharded padded ELL kernel (parallel/sharding.py, path ``"hll"``) over
meshes of 1..N devices, with speedup and efficiency against one device.

A sweep is a measurement, so it refuses to run anywhere but on GPUs unless
the caller allows CPU devices (the CLI's ``--force-cpu-devices``, tests).
"""

from __future__ import annotations

import functools
import time

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P

from ..formats.csr import CSRMatrix
from ..utils.metrics import calculate_flops
from ..utils.platform import require_gpu
from ..utils.timing import time_device_fn_batched
from ..utils.validation import (
    DEFAULT_ABS_TOL,
    DEFAULT_REL_TOL,
    difference_metrics,
)
from .csv_report import OPENMP_HEADER, _append_row, _fmt

__all__ = ["run_path_scale_sweep"]


def run_path_scale_sweep(
    name: str,
    csr: CSRMatrix,
    out_csv: str,
    path: str = "sell",
    *,
    device_counts=None,
    dtype=None,
    iterations: int = 16,
    rounds: int = 2,
    x: np.ndarray | None = None,
    allow_cpu: bool = False,
    log=print,
):
    """Device-scale curve for one shard path, ``"sell"`` or ``"hll"``: one
    openmp-schema row per device count, labeled ``name[path]``."""
    from ..parallel.sharding import make_mesh

    if not allow_cpu:
        require_gpu("device-scale sweep")
    dtype = dtype or jnp.float32
    ndev = len(jax.devices())
    counts = device_counts or [n for n in (1, 2, 4, 8, 16, 32) if n <= ndev]
    if x is None:
        x = np.ones(csr.ncols, dtype=np.float64)
    y_ref = csr.spmv(x)
    results = []

    for n in counts:
        mesh = make_mesh(n)
        xd = jax.device_put(jnp.asarray(x, dtype), NamedSharding(mesh, P()))
        t0 = time.perf_counter()
        if path == "sell":
            from ..parallel.spmd_sell import (build_spmd_sell, sell_spmv_spmd,
                                              spmd_run)
            spmd = build_spmd_sell(csr, n, mesh=mesh, dtype=dtype)
            fn = functools.partial(spmd_run, mesh=mesh, axis=spmd.axis)
            timed_args = (spmd.stacked, xd)
            y = sell_spmv_spmd(spmd, x, mesh)
        elif path == "hll":
            from ..formats.hll import HLLMatrix
            from ..parallel.sharding import shard_ell_rows

            sharded = shard_ell_rows(HLLMatrix.from_csr(csr), mesh, dtype=dtype)

            @functools.partial(
                jax.jit, out_shardings=NamedSharding(mesh, P("rows")))
            def fn(ja, as_, xv):
                return jnp.sum(as_ * jnp.take(xv, ja), axis=1)

            timed_args = (sharded.ja, sharded.as_, xd)
            y = np.asarray(fn(*timed_args))[: csr.nrows]
        else:
            raise ValueError(f"unknown path {path!r}")
        conv_s = time.perf_counter() - t0

        dm = difference_metrics(y_ref, np.asarray(y, np.float64)[: csr.nrows],
                                DEFAULT_ABS_TOL, DEFAULT_REL_TOL)
        sec, _ = time_device_fn_batched(fn, *timed_args, reps=iterations,
                                        rounds=rounds)
        gf = calculate_flops(csr.nnz, sec) / 1e9
        log(f"[{name}] spmd_{path} x{n} dev: {sec*1e3:.3f} ms = "
            f"{gf:.3f} GFLOPS, sig_diffs={dm.significant_diffs} "
            f"(convert {conv_s:.1f}s)")
        results.append((n, sec, gf, dm))

    _write_scale_rows(out_csv, f"{name}[{path}]", csr, results, csr.nnz,
                      role="hll" if path == "hll" else "parallel")
    return results


def _write_scale_rows(out_csv, label, csr, results, work, role="parallel"):
    """openmp-schema rows for a device-scale curve (num_threads = device
    count; ``work`` = nnz, the flops numerator / 2).

    ``role`` picks the reference column family the curve fills:
    ``"parallel"`` (the CSR-kernel columns) or ``"hll"`` (time_parallel_hll
    / flops_parallel_hll / speedup_hll / efficiency_hll)."""
    t1 = results[0][1] if results else 0.0
    # column indices per role: (t1, sec, err_rel, err_abs, flops_t1,
    # flops, speedup, efficiency) in the 33-column reference layout
    idx = {"parallel": (5, 7, 11, 12, 19, 21, 25, 29),
           "hll": (6, 9, 13, 14, 20, 23, 27, 31)}[role]
    for n, sec, gf, dm in results:
        sp = t1 / sec if sec > 0 else 0.0
        row = [label, csr.nrows, csr.ncols, csr.nnz, n] + [_fmt(0.0)] * 28
        row[idx[0]] = _fmt(t1)
        row[idx[1]] = _fmt(sec)
        row[idx[2]] = _fmt(dm.mean_rel_err)
        row[idx[3]] = _fmt(dm.mean_abs_err)
        row[idx[4]] = _fmt(calculate_flops(work, t1) if t1 > 0 else 0.0)
        row[idx[5]] = _fmt(gf * 1e9)
        row[idx[6]] = _fmt(sp)
        row[idx[7]] = _fmt(sp / n)
        _append_row(out_csv, OPENMP_HEADER, row)
