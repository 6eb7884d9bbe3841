#!/usr/bin/env python
"""Smoke run of the SpMV main path on a GPU, at full size, in one process.

    python chip_smoke.py               # one GPU
    python chip_smoke.py --four-cards  # the multi-device paths on four GPUs

One GPU: the 50.8M-nnz ``fem_3d(60, 60, 60, dof=3)`` matrix in f32, bf16
and native fp64, through ``auto_device_op`` and through the benchmark
harness; ``road_network(1_200_000)`` and ``webbase_like`` in f32 (short
rows, heavy-row split); one fp64 CG solve on the HPCG stencil. Four GPUs:
the row-sharded SELL operator under ``shard_map`` and the row-sharded and
2-D (psum) ELL paths on the same fem3d matrix, each compared with the
one-device result and the fp64 oracle.

Every product is checked against the fp64 host oracle (``CSRMatrix.spmv``):

* fp64: ``|y - y_ref| <= 2 k eps (|A| |x|)`` per row, with ``k`` the longest
  row and ``eps`` fp64's machine epsilon: the forward-error bound of a
  k-term dot product, doubled because both sides round, each in its own
  summation order;
* f32: the reference's validator at ``DEFAULT_ABS_TOL`` / ``DEFAULT_REL_TOL``;
* bf16 values: the same, against the oracle on the bf16-rounded values.

A failed check or phase exits non-zero. The last line of standard output
is one JSON object, ``{"ok": true, "device": {...}}``; with no GPU the
script exits non-zero before it.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str):
    raise SystemExit(f"chip_smoke FAILED: {msg}")


def check(name: str, y, ref, csr, x, dtype: str) -> None:
    """Check one product against the fp64 oracle at ``dtype``'s tolerance."""
    import numpy as np

    from sparsematrixvectormultiplication_tpu.utils.validation import (
        difference_metrics,
        roundoff_metrics,
        roundoff_scale,
    )

    y = np.asarray(y, np.float64)
    if y.shape != ref.shape or not np.all(np.isfinite(y)):
        fail(f"{name}: shape {y.shape} (want {ref.shape}) or non-finite values")
    if dtype == "float64":
        scale, k = roundoff_scale(csr, x)
        dm = roundoff_metrics(ref, y, scale, k)
        log(f"  {name}: max |y-ref|/(|A||x|) = {dm.max_rel_err:.3e} "
            f"(bound 2*{k}*eps = {2 * k * np.finfo(np.float64).eps:.3e})")
        if dm.significant_diffs:
            fail(f"{name}: fp64 error above the round-off bound in "
                 f"{dm.significant_diffs} rows")
    else:
        dm = difference_metrics(ref, y)
        log(f"  {name}: significant diffs {dm.significant_diffs}, "
            f"max rel {dm.max_rel_err:.3e}")
        if dm.significant_diffs:
            fail(f"{name}: {dm.significant_diffs} significant differences")


def phase_device(four_cards: bool) -> dict:
    """Refuse anything but a GPU; print the cards, power limits and the
    compile-cache directory."""
    import jax

    from sparsematrixvectormultiplication_tpu.utils.platform import (
        enable_compile_cache,
        require_gpu,
    )

    require_gpu("chip_smoke.py")
    jax.config.update("jax_enable_x64", True)
    devs = jax.devices()
    if four_cards and len(devs) < 4:
        fail(f"--four-cards needs 4 GPUs, found {len(devs)}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    for line in smi.strip().splitlines():
        log(f"card: {line}")
    log(f"compile cache: {enable_compile_cache()}")
    n = 4 if four_cards else 1
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": n}


def phase_spmv(coo, *, dtypes=("float32", "bfloat16", "float64"),
               iterations: int = 10) -> None:
    """SpMV through ``auto_device_op`` and ``run_matrix`` at each dtype."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from sparsematrixvectormultiplication_tpu import CSRMatrix, auto_device_op
    from sparsematrixvectormultiplication_tpu.bench.harness import (
        BenchConfig,
        bf16_rounded,
        run_matrix,
    )
    from sparsematrixvectormultiplication_tpu.ops.sell import (
        device_put_sell,
        sell_spmv,
    )
    from sparsematrixvectormultiplication_tpu.utils.timing import (
        time_device_fn_batched,
    )

    t0 = time.perf_counter()
    csr = CSRMatrix.from_coo(coo)
    log(f"  CSR: {csr.nrows} rows, {csr.nnz} nnz "
        f"({time.perf_counter() - t0:.2f} s)")
    x = np.random.default_rng(0).standard_normal(csr.ncols)
    ref = csr.spmv(x)
    t0 = time.perf_counter()
    op = auto_device_op(csr, jnp.float32)
    jax.block_until_ready(op.device)
    s = op.host
    log(f"  SELL-C-sigma: c={s.c} sigma={s.sigma} bins "
        f"{[b.k for b in s.bins]} padding {s.padding_ratio:.3f} "
        f"heavy segments {s.seg_owner.size} "
        f"(convert + upload {time.perf_counter() - t0:.2f} s)")
    for dt in dtypes:
        t0 = time.perf_counter()
        d = device_put_sell(s, jnp.dtype(dt))
        jax.block_until_ready(d)
        upload = time.perf_counter() - t0
        xd = jnp.asarray(x, jnp.float64 if dt == "float64" else jnp.float32)
        compiled = sell_spmv.lower(d, xd).compile()
        y = sell_spmv(d, xd)
        sec, _ = time_device_fn_batched(sell_spmv, d, xd, reps=iterations,
                                        rounds=2)
        log(f"  {dt}: upload {upload:.2f} s, product {sec * 1e3:.3f} ms = "
            f"{2 * csr.nnz / sec / 1e9:.1f} GFLOPS")
        log(f"  {dt}: memory_analysis {compiled.memory_analysis()}")
        oracle = bf16_rounded(csr).spmv(x) if dt == "bfloat16" else ref
        check(f"auto_device_op {dt}", y, oracle, csr, x, dt)
        del d

    stage = {"float32": "sell", "bfloat16": "sell_bf16", "float64": "sell_f64"}
    cfg = BenchConfig(iterations=iterations, rounds=2, dtype="float32",
                      kernels=("serial_csr",) + tuple(stage[d] for d in dtypes),
                      flush_between_stages=False)
    res = run_matrix("smoke", coo, cfg, log=lambda m: log(f"  {m}"))
    if res.problems():
        fail("run_matrix: " + "; ".join(res.problems()))
    stats = jax.devices()[0].memory_stats() or {}
    log(f"  peak_bytes_in_use {stats.get('peak_bytes_in_use')}")


def phase_short_rows(coo, name: str) -> None:
    """f32 SpMV on a short-row or power-law matrix."""
    import jax.numpy as jnp
    import numpy as np

    from sparsematrixvectormultiplication_tpu import CSRMatrix, auto_device_op

    csr = CSRMatrix.from_coo(coo)
    x = np.random.default_rng(1).standard_normal(csr.ncols)
    op = auto_device_op(csr, jnp.float32)
    log(f"  {name}: {csr.nnz} nnz, c={op.host.c} sigma={op.host.sigma} "
        f"heavy segments {op.host.seg_owner.size}")
    check(f"{name} float32", op.matvec(x), csr.spmv(x), csr, x, "float32")


def phase_cg(n: int, *, tol: float = 1e-10) -> None:
    """One fp64 CG solve on the HPCG stencil; residual checked on the host."""
    import jax.numpy as jnp
    import numpy as np

    from sparsematrixvectormultiplication_tpu import CSRMatrix, SellMatrix
    from sparsematrixvectormultiplication_tpu.models.synthetic import (
        hpcg_stencil,
    )
    from sparsematrixvectormultiplication_tpu.ops.sell import device_put_sell
    from sparsematrixvectormultiplication_tpu.solvers import cg_sell

    csr = CSRMatrix.from_coo(hpcg_stencil(n, n, n))
    b = np.random.default_rng(2).standard_normal(csr.nrows)
    d = device_put_sell(SellMatrix.from_csr(csr), jnp.float64)
    t0 = time.perf_counter()
    x, iters, _ = cg_sell(d, jnp.asarray(b, jnp.float64), tol=tol,
                          maxiter=2000)
    x = np.asarray(x, np.float64)
    sec = time.perf_counter() - t0
    rel = float(np.linalg.norm(b - csr.spmv(x)) / np.linalg.norm(b))
    log(f"  CG fp64 on {n}^3 HPCG stencil ({csr.nnz} nnz): {int(iters)} "
        f"iterations, {sec:.2f} s incl. compile, host residual {rel:.3e}")
    if not rel <= 10 * tol:
        fail(f"CG residual {rel:.3e} above {10 * tol:.1e}")


def phase_four_cards(coo, n_devices: int = 4) -> None:
    """Row-sharded SELL and ELL, and 2-D psum ELL, on ``n_devices``,
    against the one-device product and the fp64 oracle."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from sparsematrixvectormultiplication_tpu import (
        CSRMatrix,
        HLLMatrix,
        auto_device_op,
    )
    from sparsematrixvectormultiplication_tpu.parallel.sharding import (
        make_mesh,
        row_sharded_spmv,
        shard_ell_2d,
        shard_ell_rows,
        sharded_spmv_2d,
    )
    from sparsematrixvectormultiplication_tpu.parallel.spmd_sell import (
        build_spmd_sell,
        sell_spmv_spmd,
    )

    csr = CSRMatrix.from_coo(coo)
    x = np.random.default_rng(0).standard_normal(csr.ncols)
    ref = csr.spmv(x)
    one = auto_device_op(csr, jnp.float32).matvec(x)
    check("one device", one, ref, csr, x, "float32")
    x32 = jnp.asarray(x, jnp.float32)

    mesh = make_mesh(n_devices, ("rows",))
    t0 = time.perf_counter()
    spmd = build_spmd_sell(csr, n_devices, mesh=mesh, dtype=jnp.float32)
    log(f"  spmd_sell built in {time.perf_counter() - t0:.1f} s")
    results = {"spmd_sell": sell_spmv_spmd(spmd, x32, mesh)}
    hll = HLLMatrix.from_csr(csr)
    results["row_sharded_ell"] = np.asarray(
        row_sharded_spmv(shard_ell_rows(hll, mesh, dtype=np.float32), x32,
                         mesh))
    mesh2 = make_mesh(n_devices, ("rows", "cols"),
                      shape=(n_devices // 2, 2))
    results["ell_2d_psum"] = np.asarray(
        sharded_spmv_2d(shard_ell_2d(hll, mesh2, dtype=np.float32), x32,
                        mesh2))
    for name, y in results.items():
        check(f"{name} vs oracle", y, ref, csr, x, "float32")
        check(f"{name} vs one device", y, one, csr, x, "float32")
    log(f"  devices used: {[str(d) for d in jax.devices()[:n_devices]]}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the multi-device paths, on four GPUs")
    args = ap.parse_args(argv)

    device = phase_device(args.four_cards)
    from sparsematrixvectormultiplication_tpu.models.synthetic import (
        fem_3d,
        road_network,
        webbase_like,
    )

    t0 = time.perf_counter()
    fem = fem_3d(60, 60, 60, dof=3, seed=1)
    log(f"fem3d generated: {fem.nnz} nnz ({time.perf_counter() - t0:.1f} s)")
    if args.four_cards:
        log("phase: four-card paths")
        phase_four_cards(fem)
    else:
        log("phase: fem3d SpMV (f32, bf16, f64)")
        phase_spmv(fem)
        del fem
        log("phase: short rows")
        phase_short_rows(road_network(1_200_000, seed=1), "road_network")
        phase_short_rows(webbase_like(1_000_000, 3, seed=9), "webbase_like")
        log("phase: fp64 CG")
        phase_cg(64)
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
