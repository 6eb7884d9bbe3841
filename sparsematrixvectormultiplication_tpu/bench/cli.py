"""Benchmark CLI — the directory-sweep driver (≙ main.c:22-459).

Promotes every hard-coded constant of the reference to a flag (SURVEY §5
config note: matrix dir main.c:25, iteration count main.c:20, hack size
hll_matrix.h:12, tolerances main.c:145):

    python -m sparsematrixvectormultiplication_tpu.bench.cli \
        --matrix-dir ./matrix_for_test --output-dir ./result
    python -m sparsematrixvectormultiplication_tpu.bench.cli --suite quick

Writes the native CSV plus reference-compatible openmp/cuda-style CSVs, and
supports resumable sweeps via a checkpoint file (a capability the reference
lacks — its startup wipes result/, utility.c:200-216).
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys
import traceback


def build_parser():
    p = argparse.ArgumentParser(
        prog="spmv-bench",
        description="GPU SpMV benchmark sweep (validating, CSV-reporting)",
    )
    src = p.add_mutually_exclusive_group()
    src.add_argument("--matrix-dir", help=".mtx directory to sweep (≙ ../matrix_for_test)")
    src.add_argument("--matrix", action="append", help="single .mtx file (repeatable)")
    src.add_argument(
        "--suite",
        choices=["quick", "full"],
        help="generated synthetic corpus (models/synthetic.py BENCH_SUITE)",
    )
    src.add_argument(
        "--suite-entry", action="append",
        help="single BENCH_SUITE entry by name (repeatable; builds the "
             "matrix in-process — no multi-GB .mtx intermediate)",
    )
    p.add_argument("--output-dir", default="result", help="CSV output directory")
    p.add_argument("--iterations", type=int, default=20, help="measured reps per stage")
    p.add_argument("--skip", type=int, default=5, help="warm-up iterations (utility.h:7)")
    p.add_argument("--rounds", type=int, default=3)
    p.add_argument("--dtype", default="float32", choices=["float32", "float64", "bfloat16"])
    p.add_argument("--hack-size", type=int, default=32, help="HLL block rows (hll_matrix.h:12)")
    p.add_argument("--abs-tol", type=float, default=1e-5)
    p.add_argument("--rel-tol", type=float, default=1e-4)
    p.add_argument(
        "--kernels",
        default="serial_csr,serial_hll,xla_csr,xla_ell,sell,sell_bf16,sell_f64",
        help="comma-separated stage list (bench/harness.py)",
    )
    p.add_argument("--no-validate", action="store_true")
    p.add_argument("--device-validate", action="store_true",
                   help="per-iteration in-graph validation (≙ the "
                        "reference's in-loop checkResult, "
                        "main_cuda.cu:183-188): accumulate max|y_i - y_0| "
                        "across chained reps on-device, one readback; "
                        "overhead recorded per stage")
    p.add_argument("--reorder", default="none", choices=["none", "rcm", "auto"],
                   help="symmetric RCM bandwidth-reducing preprocessing "
                        "(auto = keep only if p98 bandwidth improves >=2x)")
    p.add_argument("--scale-sweep", action="store_true",
                   help="per matrix, also sweep the device-count axis with the "
                        "row-sharded SELL operator (openmp-schema rows, "
                        "num_threads = device count ≙ main.c:18 thread sweep)")
    p.add_argument("--force-cpu-devices", type=int, default=0, metavar="N",
                   help="force the CPU backend with N virtual devices "
                        "(for multi-device sweeps without multi-chip hardware)")
    p.add_argument("--resume", action="store_true",
                   help="skip matrices already present in the checkpoint")
    p.add_argument("--profile-dir", default=None,
                   help="emit a jax.profiler trace per matrix into this dir")
    p.add_argument("--json", action="store_true", help="also print per-matrix JSON lines")
    return p


def iter_matrices(args):
    """Yield (name, builder) pairs — matrices are built LAZILY so resumed
    sweeps skip completed entries without regenerating them."""
    from ..formats.coo import COOMatrix

    if args.suite:
        from ..models.synthetic import BENCH_SUITE

        entries = BENCH_SUITE[:4] if args.suite == "quick" else BENCH_SUITE
        for e in entries:
            yield e.name, e.builder
    elif args.suite_entry:
        from ..models.synthetic import BENCH_SUITE

        by_name = {e.name: e for e in BENCH_SUITE}
        # fail loudly: a mistyped entry must not become a 0-matrix sweep
        # that exits 0 inside an unattended chain
        unknown = [nm for nm in args.suite_entry if nm not in by_name]
        if unknown:
            raise SystemExit(
                f"unknown suite entries {unknown}; have {sorted(by_name)}")
        for nm in args.suite_entry:
            yield nm, by_name[nm].builder
    elif args.matrix:
        for path in args.matrix:
            yield (os.path.splitext(os.path.basename(path))[0],
                   lambda p=path: COOMatrix.from_mtx(p))
    elif args.matrix_dir:
        files = sorted(glob.glob(os.path.join(args.matrix_dir, "*.mtx")))
        if not files:
            print(f"no .mtx files in {args.matrix_dir}", file=sys.stderr)
        for path in files:
            yield (os.path.splitext(os.path.basename(path))[0],
                   lambda p=path: COOMatrix.from_mtx(p))
    else:
        from ..models.synthetic import BENCH_SUITE

        for e in BENCH_SUITE[:2]:
            yield e.name, e.builder


def main(argv=None):
    args = build_parser().parse_args(argv)

    import jax

    from ..utils.platform import enable_compile_cache, require_gpu

    if args.force_cpu_devices:
        # before any backend initialisation
        jax.config.update("jax_platforms", "cpu")
        jax.config.update("jax_num_cpu_devices", int(args.force_cpu_devices))
    else:
        require_gpu("spmv-bench")
    jax.config.update("jax_enable_x64", True)  # the sell_f64 stage
    enable_compile_cache()

    from .csv_report import (
        write_cuda_style_row,
        write_memory_stats_row,
        write_native_row,
        write_openmp_style_row,
        write_tile_config_row,
    )
    from .harness import BenchConfig, run_matrix

    cfg = BenchConfig(
        iterations=args.iterations,
        skip=args.skip,
        rounds=args.rounds,
        abs_tol=args.abs_tol,
        rel_tol=args.rel_tol,
        dtype=args.dtype,
        hack_size=args.hack_size,
        kernels=tuple(k.strip() for k in args.kernels.split(",") if k.strip()),
        validate=not args.no_validate,
        device_validate=args.device_validate,
        reorder=args.reorder,
    )

    os.makedirs(args.output_dir, exist_ok=True)
    ckpt_path = os.path.join(args.output_dir, ".sweep_checkpoint")
    done = set()
    if args.resume and os.path.exists(ckpt_path):
        done = set(open(ckpt_path).read().split())

    native_csv = os.path.join(args.output_dir, "spmv_results.csv")
    openmp_csv = os.path.join(args.output_dir, "spmv_results_openmp.csv")
    cuda_csv = os.path.join(args.output_dir, "spmv_results_cuda.csv")
    tiles_csv = os.path.join(args.output_dir, "spmv_tile_config.csv")
    # ≙ reference result/matrix_memory_stats_csr.csv (csr_matrix.c:28)
    memstats_csv = os.path.join(args.output_dir, "matrix_memory_stats.csv")

    n_ok = n_fail = 0
    for name, build in iter_matrices(args):
        if name in done:
            print(f"[{name}] skipped (checkpoint)")
            continue
        try:
            import time as _time

            t0 = _time.perf_counter()
            coo = build()
            print(f"[{name}] load/generate: {_time.perf_counter()-t0:.1f}s "
                  f"({coo.nnz} nnz)")
            from ..utils.profiling import profile_trace

            with profile_trace(
                os.path.join(args.profile_dir, name) if args.profile_dir else None
            ):
                res = run_matrix(name, coo, cfg)
            write_native_row(native_csv, res)
            write_openmp_style_row(openmp_csv, res)
            write_cuda_style_row(cuda_csv, res)
            write_tile_config_row(tiles_csv, res)
            if args.scale_sweep:
                from ..formats.csr import CSRMatrix
                from .scale import run_path_scale_sweep

                run_path_scale_sweep(
                    name, CSRMatrix.from_coo(coo),
                    os.path.join(args.output_dir, "spmv_scale_devices.csv"),
                    iterations=max(4, args.iterations // 4),
                    allow_cpu=bool(args.force_cpu_devices),
                )
            for fmt in ("csr", "hll", "sell"):
                if fmt in res.format_stats:
                    write_memory_stats_row(memstats_csv, name, fmt, res.format_stats[fmt])
            if args.json:
                best = max(
                    (s for s in res.stages.values() if not s.stage.startswith("serial")),
                    key=lambda s: s.gflops,
                    default=None,
                )
                print(json.dumps({
                    "matrix": name, "nnz": res.nnz,
                    "best_stage": best.stage if best else None,
                    "best_gflops": best.gflops if best else 0.0,
                }))
            with open(ckpt_path, "a") as f:
                f.write(name + "\n")
            n_ok += 1
        except Exception:
            # per-matrix failure continues the sweep (≙ main.c:54-75)
            traceback.print_exc()
            n_fail += 1
    print(f"sweep done: {n_ok} ok, {n_fail} failed -> {args.output_dir}/")
    return 0 if n_fail == 0 else 1


if __name__ == "__main__":
    sys.exit(main())
