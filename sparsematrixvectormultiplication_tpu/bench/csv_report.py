"""CSV reporting — native schema plus reference-compatible emitters.

The reference writes three CSVs (SURVEY §5 observability):
  * ``spmv_results_openmp.csv`` — 33 columns (src/utility.c:114-120)
  * ``spmv_results_cuda.csv`` — 32 columns (cuda_src/utility.cu:115-123)
  * ``spmv_results_cuda_block_dim.csv`` — chosen launch dims
    (cuda_src/utility.cu:251)

This module writes (a) the framework's native schema with full stage detail
and (b) bit-layout-compatible reference schemas with a documented stage
mapping, so downstream tooling written for the reference's CSVs keeps
working. All writers append, emitting the header only when the file is new or
empty (≙ utility.c:102-121) — which, unlike the reference (whose startup
wipes result/, utility.c:200-216, defeating resume), makes interrupted sweeps
resumable; see also the checkpoint support in bench/cli.py.
"""

from __future__ import annotations

import csv
import os

from .harness import MatrixResult
from .peaks import peak_memory_bandwidth

__all__ = [
    "write_native_row",
    "write_openmp_style_row",
    "write_cuda_style_row",
    "write_tile_config_row",
]


def _append_row(path: str, header: list, row: list):
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    new = not os.path.exists(path) or os.path.getsize(path) == 0
    if not new:
        # Fail loudly on schema drift: appending rows of a newer schema
        # under an older header silently misaligns every column after the
        # divergence point.
        with open(path, newline="") as f:
            existing = next(csv.reader(f), None)
        if existing is not None and existing != [str(h) for h in header]:
            raise ValueError(
                f"CSV schema mismatch appending to {path}: file header has "
                f"{len(existing)} cols {existing[:4]}..., writer expects "
                f"{len(header)} cols {header[:4]}... — migrate or use a new "
                "result dir")
    with open(path, "a", newline="") as f:
        w = csv.writer(f)
        if new:
            w.writerow(header)
        w.writerow(row)


def _fmt(v: float) -> str:
    return f"{v:.15f}"


NATIVE_HEADER = [
    "matrix_name", "rows", "cols", "nonzeros", "stage", "dtype",
    "arith_class",
    "time_s", "gflops", "speedup_vs_serial",
    "mean_rel_err", "significant_diffs", "max_abs_err", "max_rel_err",
    "padding_ratio", "bytes_streamed_per_nnz", "pct_peak_bw",
]


def _stage_dtype_and_class(stage: str, cfg_dtype: str):
    """dtype/arith labels per stage: the host oracles and ``sell_f64`` are
    fp64, the reference's precision; ``*_bf16`` stages store bf16 values."""
    if stage.startswith("serial") or stage.endswith("_f64"):
        return "float64", "fp64"
    if stage.endswith("_bf16"):
        return "bfloat16", "bf16"
    return cfg_dtype, {"float32": "fp32", "float64": "fp64",
                       "bfloat16": "bf16"}.get(cfg_dtype, cfg_dtype)


def write_native_row(path: str, result: MatrixResult):
    """One row per (matrix, stage) — the framework's primary schema.

    ``bytes_streamed_per_nnz`` counts the device buffers a stage reads
    (matrix arrays and x); ``pct_peak_bw`` sets those bytes per second
    against the device's published memory bandwidth, and is left empty for
    host stages and for runs not on a GPU."""
    on_gpu = result.device.get("platform") == "gpu"
    peak = peak_memory_bandwidth(result.device["kind"]) if on_gpu else None
    for stage, s in result.stages.items():
        pad = s.extra.get("padding_ratio", 1.0)
        dev_bytes = s.extra.get("device_bytes")
        per_nnz = f"{dev_bytes / max(result.nnz, 1):.2f}" if dev_bytes else ""
        pct = (f"{dev_bytes / max(s.seconds, 1e-12) / peak * 100.0:.2f}"
               if dev_bytes and peak else "")
        dtype, arith = _stage_dtype_and_class(stage, result.config.dtype)
        _append_row(
            path,
            NATIVE_HEADER,
            [
                result.name, result.nrows, result.ncols, result.nnz, stage,
                dtype, arith,
                _fmt(s.seconds), f"{s.gflops:.6f}",
                f"{result.speedup(stage):.6f}",
                f"{s.diff.mean_rel_err:.15e}", s.diff.significant_diffs,
                f"{s.diff.max_abs_err:.15e}", f"{s.diff.max_rel_err:.15e}",
                f"{pad:.6f}", per_nnz, pct,
            ],
        )


# Exact header of the reference OpenMP CSV (src/utility.c:114-120).
OPENMP_HEADER = (
    "matrix_name,rows,cols,nonzeros,num_threads,"
    "time_serial,time_serial_hll,time_parallel,time_parallel_simd,"
    "time_parallel_hll,time_parallel_hll_simd,"
    "error_csr_relative,error_csr_absolute,error_hll_relative,error_hll_absolute,"
    "error_csr_simd_relative,error_csr_simd_absolute,error_hll_simd_relative,"
    "error_hll_simd_absolute,"
    "flops_serial,flops_serial_hll,flops_parallel,flops_parallel_simd,"
    "flops_parallel_hll,flops_parallel_hll_simd,"
    "speedup_parallel,speedup_simd,speedup_hll,speedup_hll_simd,"
    "efficiency_parallel,efficiency_simd,efficiency_hll,efficiency_hll_simd"
).split(",")

# Stage mapping onto the reference's column roles (each column a DISTINCT
# stage — a duplicate mapping would let downstream tooling compare a kernel
# against itself):
#   time_parallel          <- sell     (the SELL-C-σ operator)
#   time_parallel_simd     <- xla_csr  (the vectorized CSR kernel)
#   time_parallel_hll      <- xla_ell  (the parallel HLL kernel)
#   time_parallel_hll_simd <- none     (zeros: no second HLL device stage)
_OPENMP_MAP = {
    "parallel": "sell",
    "parallel_simd": "xla_csr",
    "parallel_hll": "xla_ell",
    "parallel_hll_simd": None,
}


def write_openmp_style_row(path: str, result: MatrixResult, num_threads: int = 1):
    """Reference-schema row; ``num_threads`` records device count."""
    def sec(stage):
        s = result.stages.get(stage)
        return s.seconds if s else 0.0

    def gf(stage):
        s = result.stages.get(stage)
        return s.gflops * 1e9 if s else 0.0  # reference stores raw FLOPS

    def err(stage):
        s = result.stages.get(stage)
        return (s.diff.mean_rel_err, s.diff.mean_abs_err) if s else (0.0, 0.0)

    sp = {k: result.speedup(v) for k, v in _OPENMP_MAP.items()}
    eff = {k: v / max(num_threads, 1) for k, v in sp.items()}
    e_csr = err(_OPENMP_MAP["parallel"])
    e_hll = err(_OPENMP_MAP["parallel_hll"])
    e_csr_simd = err(_OPENMP_MAP["parallel_simd"])
    e_hll_simd = err(_OPENMP_MAP["parallel_hll_simd"])

    row = [
        result.name, result.nrows, result.ncols, result.nnz, num_threads,
        _fmt(sec("serial_csr")), _fmt(sec("serial_hll")),
        _fmt(sec(_OPENMP_MAP["parallel"])), _fmt(sec(_OPENMP_MAP["parallel_simd"])),
        _fmt(sec(_OPENMP_MAP["parallel_hll"])), _fmt(sec(_OPENMP_MAP["parallel_hll_simd"])),
        _fmt(e_csr[0]), _fmt(e_csr[1]), _fmt(e_hll[0]), _fmt(e_hll[1]),
        _fmt(e_csr_simd[0]), _fmt(e_csr_simd[1]), _fmt(e_hll_simd[0]), _fmt(e_hll_simd[1]),
        _fmt(gf("serial_csr")), _fmt(gf("serial_hll")),
        _fmt(gf(_OPENMP_MAP["parallel"])), _fmt(gf(_OPENMP_MAP["parallel_simd"])),
        _fmt(gf(_OPENMP_MAP["parallel_hll"])), _fmt(gf(_OPENMP_MAP["parallel_hll_simd"])),
        _fmt(sp["parallel"]), _fmt(sp["parallel_simd"]),
        _fmt(sp["parallel_hll"]), _fmt(sp["parallel_hll_simd"]),
        _fmt(eff["parallel"]), _fmt(eff["parallel_simd"]),
        _fmt(eff["parallel_hll"]), _fmt(eff["parallel_hll_simd"]),
    ]
    _append_row(path, OPENMP_HEADER, row)


# Exact header of the reference CUDA CSV (cuda_src/utility.cu:115-123).
CUDA_HEADER = (
    "matrix_name,rows,cols,nonzeros,"
    "time_serial,time_serial_hll,time_row_csr,time_warp_csr,time_warp_shared_csr,"
    "time_row_hll,time_warp_hll,time_warp_shared_hll,"
    "flops_serial,avg_flops_hll_serial,flops_row_csr,flops_warp_csr,"
    "flops_warp_csr_shared,flops_row_hll,flops_warp_hll,flops_warp_shared_hll,"
    "relative_error_row_csr,absolute_error_row_csr,"
    "relative_error_warp_csr,absolute_error_warp_csr,"
    "relative_error_warp_shared_csr,absolute_error_warp_shared_csr,"
    "relative_error_row_hll,absolute_error_row_hll,"
    "relative_error_warp_hll,absolute_error_warp_hll,"
    "relative_error_warp_shared_hll,absolute_error_warp_shared_hll"
).split(",")

# Stage mapping onto the reference's CUDA kernel roles (all fp64 there).
# DISTINCT stages for distinct reference kernels
# (cuda_src/utility.cu:115-123) — a duplicate mapping would emit
# byte-identical columns and let downstream tooling compare a kernel
# against itself:
#   row_csr         <- xla_csr   (the XLA segment-sum CSR kernel)
#   warp_csr        <- sell      (SELL-C-σ at the run's dtype)
#   warp_shared_csr <- sell_f64  (SELL-C-σ in fp64, the reference's precision)
#   row_hll         <- xla_ell   (padded-HLL device kernel)
#   warp_hll        <- sell_bf16 (SELL-C-σ with bf16 values)
#   warp_shared_hll <- none      (zeros)
_CUDA_MAP = {
    "row_csr": ("xla_csr",),
    "warp_csr": ("sell",),
    "warp_shared_csr": ("sell_f64",),
    "row_hll": ("xla_ell",),
    "warp_hll": ("sell_bf16",),
    "warp_shared_hll": (),
}


def write_cuda_style_row(path: str, result: MatrixResult):
    def _stage(role):
        for cand in _CUDA_MAP.get(role, (role,)):
            s = result.stages.get(cand)
            if s:
                return s
        return None

    def sec(role):
        s = _stage(role)
        return s.seconds if s else 0.0

    def gf(role):
        s = _stage(role)
        return s.gflops * 1e9 if s else 0.0

    def err(role):
        s = _stage(role)
        return (s.diff.mean_rel_err, s.diff.mean_abs_err) if s else (0.0, 0.0)

    def sser(stage):
        s = result.stages.get(stage)
        return s.seconds if s else 0.0

    def gser(stage):
        s = result.stages.get(stage)
        return s.gflops * 1e9 if s else 0.0

    roles = ["row_csr", "warp_csr", "warp_shared_csr", "row_hll", "warp_hll",
             "warp_shared_hll"]
    errs = [x for r in roles for x in err(r)]
    row = [
        result.name, result.nrows, result.ncols, result.nnz,
        _fmt(sser("serial_csr")), _fmt(sser("serial_hll")),
        _fmt(sec("row_csr")), _fmt(sec("warp_csr")), _fmt(sec("warp_shared_csr")),
        _fmt(sec("row_hll")), _fmt(sec("warp_hll")), _fmt(sec("warp_shared_hll")),
        _fmt(gser("serial_csr")), _fmt(gser("serial_hll")),
        _fmt(gf("row_csr")), _fmt(gf("warp_csr")), _fmt(gf("warp_shared_csr")),
        _fmt(gf("row_hll")), _fmt(gf("warp_hll")), _fmt(gf("warp_shared_hll")),
    ] + [_fmt(e) for e in errs]
    _append_row(path, CUDA_HEADER, row)


MEMORY_STATS_HEADER = [
    "matrix_name", "rows", "cols", "nonzeros", "format",
    "bytes_total", "bytes_per_nnz", "padded_nnz", "padding_ratio",
]


def write_memory_stats_row(path: str, matrix_name: str, fmt: str, stats: dict):
    """Per-format memory footprint row (≙ write_memory_stats_to_csv,
    src/csr_matrix.c:28-61 — which the reference defines but never calls;
    here it is wired into the sweep)."""
    _append_row(
        path,
        MEMORY_STATS_HEADER,
        [
            matrix_name, stats.get("rows"), stats.get("cols"), stats.get("nnz"),
            fmt, stats.get("bytes_total"),
            f"{stats.get('bytes_total', 0) / max(stats.get('nnz', 1), 1):.3f}",
            stats.get("padded_nnz", stats.get("nnz")),
            f"{stats.get('padding_ratio', 1.0):.6f}",
        ],
    )


TILE_HEADER = [
    "matrix_name", "nonzeros", "slice_rows", "sigma", "bin_k", "n_slices",
    "bin_padding_ratio", "padding_ratio",
]


def write_tile_config_row(path: str, result: MatrixResult):
    """Chosen SELL slice geometry per bin (≙ write_block_result_to_csv,
    cuda_src/utility.cu:236-261, where the reference logs its CUDA block
    dims): slice height, sort window, and each bin's width and size."""
    sell = result.format_stats.get("sell")
    if not sell:
        return
    for b in sell["bins"]:
        _append_row(
            path,
            TILE_HEADER,
            [result.name, result.nnz, sell["slice_rows"], sell["sigma"],
             b["k"], b["n_slices"], f"{b['padding_ratio']:.6f}",
             f"{sell['padding_ratio']:.6f}"],
        )
