#!/usr/bin/env python
"""Benchmark: SELL-C-σ SpMV on one GPU, validated against the fp64 host
oracle. Prints ONE JSON line:
  {"metric": ..., "value": N, "unit": ..., "vs_baseline": N, ...}

Headline workload: a Cube_Coup_dt0-class 3-D FEM matrix (27-point stencil x
3 dof, 50.8M nnz) — the same matrix class as the reference project's own
headline result (CUDA warp-per-row CSR on Cube_Coup_dt0: 47.09 fp64 GFLOPS
on a card the reference did not record, reference result/result_cuda.csv
row 3 / BASELINE.md). vs_baseline divides by that number. The fp64 fields
come from the native fp64 stage; secondary fields cover a random-in-band
matrix (the gather-hostile regime) and a road network (short rows).

Runs on a GPU only: with no GPU it exits non-zero and prints no result.
It does the same when any stage it asks for fails or does not validate
(fp64 stages within the round-off bound, the others at the reference
tolerances).
"""

import json
import sys
import time

BASELINE_GFLOPS = 47.09  # reference CUDA warp-CSR, Cube_Coup_dt0 (BASELINE.md)


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def main():
    import jax

    from sparsematrixvectormultiplication_tpu.utils.platform import (
        enable_compile_cache,
        require_gpu,
    )

    require_gpu("bench.py")
    jax.config.update("jax_enable_x64", True)
    enable_compile_cache()

    from sparsematrixvectormultiplication_tpu.bench.harness import BenchConfig, run_matrix
    from sparsematrixvectormultiplication_tpu.models.synthetic import (
        banded,
        fem_3d,
        road_network,
    )

    t_all = time.time()
    cfg = BenchConfig(
        iterations=64,
        rounds=3,
        dtype="float32",
        kernels=("serial_csr", "sell", "sell_bf16", "sell_f64"),
        flush_between_stages=False,
    )

    # --- headline: Cube_Coup_dt0-class FEM (clustered stencil) ---
    t0 = time.time()
    coo = fem_3d(60, 60, 60, dof=3, seed=1)
    log(f"fem3d gen: {time.time()-t0:.0f}s nnz={coo.nnz}")
    res = run_matrix("fem3d_cube", coo, cfg, log=log)
    s, f64, b16 = res.stage("sell"), res.stage("sell_f64"), res.stage("sell_bf16")

    # --- secondary: adversarial random-in-band (gather-hostile) ---
    t0 = time.time()
    coo2 = banded(250_000, 60, 2500, seed=1)
    log(f"banded gen: {time.time()-t0:.0f}s nnz={coo2.nnz}")
    cfg2 = BenchConfig(iterations=64, rounds=3, dtype="float32",
                       kernels=("serial_csr", "sell", "sell_f64"),
                       flush_between_stages=False)
    res2 = run_matrix("banded_adversarial", coo2, cfg2, log=log)
    s2, f64_2 = res2.stage("sell"), res2.stage("sell_f64")

    # --- tertiary: scattered short rows (≙ the reference's thread-per-row
    # CUDA class, roadNet-PA row of result/result_cuda.csv) ---
    t0 = time.time()
    coo3 = road_network(1_200_000, seed=1)
    log(f"road gen: {time.time()-t0:.0f}s nnz={coo3.nnz}")
    cfg3 = BenchConfig(iterations=128, rounds=3, dtype="float32",
                       kernels=("serial_csr", "sell"),
                       flush_between_stages=False)
    res3 = run_matrix("road_scattered", coo3, cfg3, log=log)
    s3 = res3.stage("sell")

    log(f"total bench time: {time.time()-t_all:.0f}s")
    # every stage asked for must have run and validated: fp64 stages within
    # the round-off bound, the others at the reference tolerances
    problems = res.problems() + res2.problems() + res3.problems()
    if problems:
        raise SystemExit("bench.py FAILED: " + "; ".join(problems))
    print(
        json.dumps(
            {
                "metric": "pallas_sell_f32_gflops_fem3d_51Mnnz",
                "value": round(s.gflops, 3),
                "unit": "GFLOPS",
                "vs_baseline": round(s.gflops / BASELINE_GFLOPS, 4),
                "valid": True,
                "mean_rel_err": s.diff.mean_rel_err,
                "nnz": res.nnz,
                "time_ms": round(s.seconds * 1e3, 3),
                # native fp64 (the key names predate it)
                "fp64_dd_gflops": round(f64.gflops, 3),
                "fp64_dd_vs_baseline": round(f64.gflops / BASELINE_GFLOPS, 4),
                "fp64_dd_max_rel_err": f64.diff.max_rel_err,
                "bf16_gflops": round(b16.gflops, 3),
                "bf16_vs_baseline": round(b16.gflops / BASELINE_GFLOPS, 4),
                "adversarial_banded_f32_gflops": round(s2.gflops, 3),
                "adversarial_banded_dd_gflops": round(f64_2.gflops, 3),
                # scattered short-row regime vs the reference's roadNet-PA
                # CUDA warp number (2.59 GF, result/result_cuda.csv)
                "scattered_road_f32_gflops": round(s3.gflops, 3),
                "scattered_road_vs_ref_warp": round(s3.gflops / 2.59, 3),
            }
        ),
        flush=True,
    )


if __name__ == "__main__":
    main()
