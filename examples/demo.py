#!/usr/bin/env python
"""End-to-end demo: load a .mtx, run the SpMV operator in three precisions,
validate each against the fp64 host oracle, and solve.

    python examples/demo.py [path/to/matrix.mtx]

Without an argument, generates a banded FEM-class matrix. Runs on whatever
backend JAX picks; timing is printed on a GPU only.
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np


def main():
    import jax

    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp

    import sparsematrixvectormultiplication_tpu as spmv
    from sparsematrixvectormultiplication_tpu.bench.harness import bf16_rounded
    from sparsematrixvectormultiplication_tpu.ops.sell import (
        device_put_sell,
        sell_spmv,
    )
    from sparsematrixvectormultiplication_tpu.utils.metrics import format_flops
    from sparsematrixvectormultiplication_tpu.utils.validation import (
        difference_metrics,
    )

    if len(sys.argv) > 1:
        coo = spmv.COOMatrix.from_mtx(sys.argv[1])
        name = os.path.basename(sys.argv[1])
    else:
        from sparsematrixvectormultiplication_tpu.models.synthetic import banded

        coo = banded(50_000, 24, 500, seed=0)
        name = "banded_demo(50k x 50k, ~24 nnz/row)"

    print(f"matrix: {name} -> {coo.summary()}")
    csr = spmv.CSRMatrix.from_coo(coo)
    sell = spmv.SellMatrix.from_csr(csr)
    print(f"SELL-C-sigma: c={sell.c} sigma={sell.sigma} bins "
          f"{[b.k for b in sell.bins]}, padding {sell.padding_ratio:.2f}x, "
          f"{sell.seg_owner.size} heavy-row segments")

    x = np.ones(coo.ncols)
    y_oracle = csr.spmv(x)  # host fp64 golden reference
    print(f"backend: {jax.devices()[0].device_kind}")

    for dt in (jnp.float32, jnp.bfloat16, jnp.float64):
        d = device_put_sell(sell, dt)
        xd = jnp.asarray(x, jnp.float64 if dt == jnp.float64 else jnp.float32)
        y = np.asarray(sell_spmv(d, xd), np.float64)
        # bf16 values are checked against the oracle on the rounded values
        ref = bf16_rounded(csr).spmv(x) if dt == jnp.bfloat16 else y_oracle
        dm = difference_metrics(ref, y)
        print(f"{jnp.dtype(dt).name:8s} SpMV: significant_diffs="
              f"{dm.significant_diffs} max_rel={dm.max_rel_err:.2e}")

    # the one-call surface: convert, upload, operator
    op = spmv.auto_device_op(csr, jnp.float32)
    dm = difference_metrics(y_oracle, op.matvec(x))
    print(f"auto_device_op: significant_diffs={dm.significant_diffs}")

    # fp64 CG on an SPD 1-D Laplacian through the same operator
    from sparsematrixvectormultiplication_tpu.formats.coo import COOMatrix
    from sparsematrixvectormultiplication_tpu.solvers import cg_sell

    n = 1024
    rows = np.repeat(np.arange(n), 3)[1:-1]
    cols = rows + np.tile([-1, 0, 1], n)[1:-1]
    lap = spmv.CSRMatrix.from_coo(COOMatrix(
        n, n, rows, cols, np.tile([-1.0, 2.5, -1.0], n)[1:-1]))
    b = np.ones(n)
    xs, iters, _ = cg_sell(device_put_sell(spmv.SellMatrix.from_csr(lap),
                                           jnp.float64),
                           jnp.asarray(b), tol=1e-12, maxiter=500)
    res = np.linalg.norm(b - lap.spmv(np.asarray(xs))) / np.linalg.norm(b)
    print(f"fp64 CG: {int(iters)} iterations, host residual {res:.1e}")

    # PageRank on |A| through the XLA CSR matvec
    from sparsematrixvectormultiplication_tpu.ops.xla import (
        csr_spmv,
        device_put_csr,
    )
    from sparsematrixvectormultiplication_tpu.solvers import (
        pagerank,
        pagerank_operator,
    )

    if coo.nrows == coo.ncols:
        absco = COOMatrix(coo.nrows, coo.ncols, coo.row, coo.col,
                          np.abs(coo.val))
        t, dangling = pagerank_operator(spmv.CSRMatrix.from_coo(absco))
        dt_pr = device_put_csr(t)
        p, iters, delta = pagerank(
            lambda u: csr_spmv(dt_pr.values, dt_pr.col_idx, dt_pr.row_ids,
                               u, nrows=dt_pr.nrows),
            jnp.asarray(dangling), tol=1e-10, maxiter=200)
        print(f"PageRank: {int(iters)} iterations, L1 delta "
              f"{float(delta):.2e}, sum={float(np.asarray(p).sum()):.6f}")

    if jax.devices()[0].platform == "gpu":
        from sparsematrixvectormultiplication_tpu.utils.timing import (
            time_device_fn_batched,
        )

        d32 = device_put_sell(sell, jnp.float32)
        sec, _ = time_device_fn_batched(sell_spmv, d32,
                                        jnp.asarray(x, jnp.float32),
                                        reps=20, rounds=3)
        print(f"f32 SpMV time: {sec*1e3:.3f} ms = "
              f"{format_flops(2 * coo.nnz / sec)}")


if __name__ == "__main__":
    main()
