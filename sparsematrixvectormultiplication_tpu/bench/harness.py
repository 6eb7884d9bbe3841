"""Benchmark harness — stage runner with validation (≙ main.c / main_cuda.cu).

Reproduces the reference driver shape: per matrix, convert to every format,
run each kernel stage for ``skip + iterations`` passes (reference
NUM_ITERATION=100 incl. 5-iteration warm-up skip, main.c:20, utility.h:7),
validate every stage against the serial fp64 CSR oracle
(≙ main.c:145,207,260,310,362), and report time / GFLOPS / errors.

Stages:

* ``serial_csr``, ``serial_hll`` — the host fp64 oracles;
* ``xla_csr``, ``xla_ell`` — plain XLA CSR and padded-ELL kernels at
  ``cfg.dtype``;
* ``cusparse_csr`` — ``jax.experimental.sparse.BCSR`` at ``cfg.dtype``:
  cuSPARSE's CSR SpMV on a GPU where cuSPARSE takes the dtype
  (``extra["cusparse"]`` says whether it did), JAX's generic lowering
  otherwise;
* ``sell`` — the SELL-C-σ operator (:func:`..ops.sell.sell_spmv`) at
  ``cfg.dtype``; ``sell_bf16`` with bf16 values; ``sell_f64`` in native
  fp64, the reference's precision (needs ``jax_enable_x64``).

Device stages run in the order of ``cfg.kernels``; a stage listed twice
is timed twice and keeps its better time, so ``A B B A`` orders can be
asked for. Each stage is checked at its value precision: fp64 stages
within the round-off bound (:func:`..utils.validation.roundoff_metrics`),
f32 at ``cfg.abs_tol``/``cfg.rel_tol``, bf16 values at the same
tolerances against the oracle on the bf16-rounded values.

``x`` defaults to a seeded standard-normal vector. (The reference uses
all ones, under which ``y_i`` is the sum of row ``i``'s values and a
wrong column index cannot be seen; device time does not depend on the
values of ``x``.)

Device stages are timed by :func:`..utils.timing.time_device_fn_batched`,
which ends in ``block_until_ready``; validation compares one device result
on the host per stage instead of copying y back every iteration. A stage
that fails is logged and recorded in ``MatrixResult.failed``;
:meth:`MatrixResult.problems` lists every asked-for stage that is missing
or invalid.
"""

from __future__ import annotations

import gc
import time
from dataclasses import dataclass, field

import jax
import jax.numpy as jnp
import numpy as np

from ..formats.coo import COOMatrix
from ..formats.csr import CSRMatrix
from ..formats.hll import DEFAULT_HACK_SIZE, HLLMatrix
from ..formats.sell import SellMatrix
from ..ops.sell import device_put_sell, sell_spmv
from ..ops.xla import device_put_csr, device_put_ell
from ..utils.metrics import calculate_flops
from ..utils.timing import ITERATION_SKIP, time_device_fn_batched
from ..utils.validation import (
    DEFAULT_ABS_TOL,
    DEFAULT_REL_TOL,
    DiffMetrics,
    difference_metrics,
    roundoff_metrics,
    roundoff_scale,
)

__all__ = ["BenchConfig", "StageResult", "MatrixResult", "run_matrix",
           "flush_l2", "bf16_rounded", "DEVICE_STAGES"]

DEVICE_STAGES = ("xla_csr", "xla_ell", "cusparse_csr", "sell", "sell_bf16",
                 "sell_f64")


@dataclass
class BenchConfig:
    iterations: int = 20          # measured reps per round (reference: 95)
    skip: int = ITERATION_SKIP    # warm-up iterations (≙ utility.h:7)
    rounds: int = 3               # outer repetitions; best round wins
    abs_tol: float = DEFAULT_ABS_TOL
    rel_tol: float = DEFAULT_REL_TOL
    dtype: str = "float32"        # value dtype of xla_*, cusparse_csr, sell
    hack_size: int = DEFAULT_HACK_SIZE
    kernels: tuple = ("serial_csr", "serial_hll", "xla_csr", "xla_ell", "sell")
    ell_max_elements: int = 1 << 28  # padded-ELL rectangle cap (power-law
                                     # rows blow the rectangle up)
    flush_between_stages: bool = True
    validate: bool = True
    reorder: str = "none"              # "none" | "rcm" | "auto" — symmetric
                                       # P A Pᵀ bandwidth-reducing preprocessing
                                       # (formats/reorder.py; workload-equivalent)
    device_validate: bool = False      # per-iteration in-graph validation
                                       # (≙ the reference's in-loop
                                       # checkResult, main_cuda.cu:183-188):
                                       # one extra chained run accumulating
                                       # max|y_i - y_0| on the device, one
                                       # readback; overhead recorded per
                                       # stage, never part of the timed run


@dataclass
class StageResult:
    stage: str
    seconds: float
    gflops: float
    diff: DiffMetrics
    extra: dict = field(default_factory=dict)


@dataclass
class MatrixResult:
    name: str
    nrows: int
    ncols: int
    nnz: int
    stages: dict            # stage -> StageResult
    format_stats: dict
    config: BenchConfig
    device: dict = field(default_factory=dict)  # platform, kind, count
    failed: dict = field(default_factory=dict)  # stage -> why it has no row

    def stage(self, name: str) -> StageResult | None:
        return self.stages.get(name)

    def speedup(self, stage: str, baseline: str = "serial_csr") -> float:
        b, s = self.stages.get(baseline), self.stages.get(stage)
        if not b or not s or s.seconds <= 0:
            return 0.0
        return b.seconds / s.seconds

    def problems(self) -> list:
        """Every stage of ``config.kernels`` that is missing or has
        significant differences, with the reason; empty when all passed."""
        out = []
        for st in dict.fromkeys(self.config.kernels):
            s = self.stages.get(st)
            if s is None:
                out.append(f"{self.name}/{st}: "
                           f"{self.failed.get(st, 'did not run')}")
            elif s.diff.significant_diffs:
                out.append(f"{self.name}/{st}: {s.diff.significant_diffs} "
                           "significant differences")
        return out


def flush_l2(mbytes: int = 256):
    """Stream a buffer of ``mbytes`` through device memory between stages,
    so no stage starts with the previous one's data in the 50 MB L2
    (≙ clear_cache, utility.c:141-159 / clear_gpu_cache,
    cuda_src/utility.cu:148-175)."""
    n = mbytes * 1024 * 1024 // 4
    jax.block_until_ready(jnp.sum(jnp.ones((n,), jnp.float32) * 1.0000001))


def bf16_rounded(csr: CSRMatrix) -> CSRMatrix:
    """``csr`` with its values rounded to bf16 (kept in fp64): the oracle
    for bf16-valued stages, so their check isolates the kernel from the
    storage rounding."""
    return CSRMatrix(csr.nrows, csr.ncols, csr.row_ptr, csr.col_idx,
                     csr.values.astype(jnp.bfloat16).astype(np.float64))


def device_info() -> dict:
    d = jax.devices()[0]
    return {"platform": d.platform, "kind": d.device_kind,
            "count": len(jax.devices())}


def _device_bytes(obj) -> int:
    return sum(int(a.nbytes) for a in jax.tree_util.tree_leaves(obj))


def _stage_dtype(stage: str, cfg: BenchConfig):
    return {"sell_bf16": jnp.dtype(jnp.bfloat16),
            "sell_f64": jnp.dtype(jnp.float64)}.get(stage, jnp.dtype(cfg.dtype))


def _bcsr(csr: CSRMatrix, dtype):
    from jax.experimental import sparse as jsparse

    return jsparse.BCSR(
        (jnp.asarray(csr.values.astype(dtype)),
         jnp.asarray(csr.col_idx, jnp.int32),
         jnp.asarray(csr.row_ptr.astype(np.int32))),
        shape=csr.shape)


def run_matrix(
    name: str,
    coo: COOMatrix,
    cfg: BenchConfig = BenchConfig(),
    x: np.ndarray | None = None,
    log=print,
) -> MatrixResult:
    """Run all configured stages on one matrix (≙ the per-matrix body of
    main.c:39-459 / main_cuda.cu:52-729)."""
    M, N, nnz = coo.nrows, coo.ncols, coo.nnz
    if x is None:
        x = np.random.default_rng(0).standard_normal(N)

    t0 = time.perf_counter()
    csr = CSRMatrix.from_coo(coo)
    stages: dict = {}
    failed: dict = {}
    fstats = {"csr": csr.memory_stats(),
              "convert_csr_s": time.perf_counter() - t0}

    if cfg.reorder in ("rcm", "auto") and M == N:
        # bandwidth-reducing preprocessing (formats/reorder.py): the SpMV
        # workload is unchanged (same nnz/FLOPs, y' = P y); every stage,
        # including the serial oracle, runs the permuted problem (x
        # permuted alike), so validation is self-consistent.
        from ..formats.reorder import reorder_rcm

        csr, perm_r, rstats = reorder_rcm(
            csr, mode=cfg.reorder, log=lambda m: log(f"[{name}] {m}"))
        fstats["reorder"] = rstats
        if perm_r is not None:
            x = np.asarray(x)[perm_r]

    # --- golden oracle: host fp64 serial CSR (≙ csr_matrix_vector_mult) ---
    y_ref = None
    if "serial_csr" in cfg.kernels:
        times = []
        for _ in range(min(cfg.skip, 2) + 3):
            t0 = time.perf_counter()
            y_ref = csr.spmv(x)
            times.append(time.perf_counter() - t0)
        sec = min(times)
        stages["serial_csr"] = StageResult(
            "serial_csr", sec, calculate_flops(nnz, sec) / 1e9, DiffMetrics())
        log(f"[{name}] serial_csr: {sec*1e3:.3f} ms = "
            f"{stages['serial_csr'].gflops:.3f} GFLOPS (host fp64 oracle)")
    if y_ref is None:
        y_ref = csr.spmv(x)

    cache: dict = {}

    def once(key, make):
        if key not in cache:
            cache[key] = make()
        return cache[key]

    def validate(y, vdt) -> DiffMetrics:
        """``y`` against the oracle at the precision of values ``vdt``."""
        if not cfg.validate:
            return DiffMetrics()
        y = np.asarray(y, np.float64)[:M]
        if vdt == jnp.float64:
            scale, k = once("scale", lambda: roundoff_scale(csr, x))
            return roundoff_metrics(y_ref, y, scale, k)
        ref = y_ref
        if vdt == jnp.bfloat16:
            ref = once("ref_bf16", lambda: bf16_rounded(csr).spmv(x))
        return difference_metrics(ref, y, cfg.abs_tol, cfg.rel_tol)

    def get_hll():
        def make():
            t0 = time.perf_counter()
            hll = HLLMatrix.from_csr(csr, cfg.hack_size)
            fstats["convert_hll_s"] = time.perf_counter() - t0
            fstats["hll"] = hll.memory_stats()
            return hll
        return once("hll", make)

    def get_sell():
        def make():
            t0 = time.perf_counter()
            sell = SellMatrix.from_csr(csr)
            fstats["convert_sell_s"] = time.perf_counter() - t0
            fstats["sell"] = sell.memory_stats()
            if sell.seg_owner.size:
                log(f"[{name}] split heavy rows into {sell.seg_owner.size} "
                    "extra segments")
            return sell
        return once("sell", make)

    if "serial_hll" in cfg.kernels:
        hll = get_hll()
        t0 = time.perf_counter()
        y = hll.spmv(x)
        sec = time.perf_counter() - t0
        stages["serial_hll"] = StageResult(
            "serial_hll", sec, calculate_flops(nnz, sec) / 1e9,
            validate(y, jnp.dtype(jnp.float64)))
        log(f"[{name}] serial_hll: {sec*1e3:.3f} ms, "
            f"sig_diffs={stages['serial_hll'].diff.significant_diffs}")

    def build(stage, vdt):
        """(fn, device matrix, extra) of one device stage."""
        if stage == "xla_csr":
            return (lambda d, xx: d.spmv(xx)), device_put_csr(csr, dtype=vdt), {}
        if stage == "xla_ell":
            return ((lambda d, xx: d.spmv(xx)),
                    device_put_ell(get_hll(), dtype=vdt,
                                   max_elements=cfg.ell_max_elements), {})
        if stage == "cusparse_csr":
            return (lambda m, xx: m @ xx), _bcsr(csr, vdt), {}
        sell = get_sell()
        t0 = time.perf_counter()
        dsell = device_put_sell(sell, vdt)
        return sell_spmv, dsell, {"padding_ratio": sell.padding_ratio,
                                  "upload_s": time.perf_counter() - t0}

    def run_device_stage(stage):
        """Validate, time and record one device stage. A stage that fails
        is logged, recorded in ``failed`` and skipped so the matrix keeps
        its other rows (≙ the reference's per-matrix recovery,
        main.c:54-75)."""
        vdt = _stage_dtype(stage, cfg)
        if vdt == jnp.float64 and not jax.config.jax_enable_x64:
            failed[stage] = "needs jax_enable_x64"
            log(f"[{name}] {stage} FAILED: needs jax_enable_x64")
            return
        # f32 x for f32 and bf16 values, f64 x for f64 values
        xd = jnp.asarray(x, jnp.float64 if vdt == jnp.float64 else jnp.float32)
        prev = stages.get(stage)
        try:
            if cfg.flush_between_stages:
                flush_l2()
            fn, dmat, info = build(stage, vdt)
            if prev is None:
                dm = validate(fn(dmat, xd), vdt)
            sec, _ = time_device_fn_batched(fn, dmat, xd, reps=cfg.iterations,
                                            rounds=cfg.rounds)
            if prev is not None:
                if sec < prev.seconds:
                    prev.seconds = sec
                    prev.gflops = calculate_flops(nnz, sec) / 1e9
                log(f"[{name}] {stage} again: {sec*1e3:.3f} ms "
                    f"(kept {prev.seconds*1e3:.3f} ms)")
                return
            info["device_bytes"] = _device_bytes(dmat) + _device_bytes(xd)
            if stage == "cusparse_csr":
                info["cusparse"] = "cusparse" in (
                    jax.jit(fn).lower(dmat, xd).as_text().lower())
            if cfg.device_validate:
                from ..utils.timing import run_device_validated

                reps = min(cfg.iterations, 16)
                worst, dv_sec = run_device_validated(
                    fn, dmat, xd, y_ref=fn(dmat, xd), reps=reps)
                info.update({"device_val_max_diff": worst,
                             "device_val_reps": reps,
                             "device_val_overhead_pct":
                                 (dv_sec / sec - 1.0) * 100.0 if sec > 0
                                 else 0.0})
        except MemoryError as e:
            failed[stage] = f"skipped: {e}"
            log(f"[{name}] {stage} skipped: {e}")
            return
        except Exception as e:  # noqa: BLE001 — one stage, not the matrix
            failed[stage] = f"{type(e).__name__}: {str(e)[:300]}"
            log(f"[{name}] {stage} FAILED: {failed[stage]}")
            return
        finally:
            dmat = None
            gc.collect()
        stages[stage] = StageResult(stage, sec, calculate_flops(nnz, sec) / 1e9,
                                    dm, extra=info)
        log(f"[{name}] {stage}: {sec*1e3:.3f} ms = {stages[stage].gflops:.3f} "
            f"GFLOPS, sig_diffs={dm.significant_diffs}, "
            f"max_rel={dm.max_rel_err:.2e}")

    for stage in cfg.kernels:
        if stage in DEVICE_STAGES:
            run_device_stage(stage)
        elif not stage.startswith("serial_"):
            failed[stage] = "unknown stage"
            log(f"[{name}] {stage} FAILED: unknown stage")

    return MatrixResult(name, M, N, nnz, stages, fstats, cfg,
                        device_info(), failed)
