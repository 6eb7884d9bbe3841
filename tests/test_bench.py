"""Bench harness + CSV schema tests (CPU: device stages run the XLA path)."""

import csv
import os

import numpy as np
import pytest

from sparsematrixvectormultiplication_tpu.bench.csv_report import (
    CUDA_HEADER,
    NATIVE_HEADER,
    OPENMP_HEADER,
    write_cuda_style_row,
    write_native_row,
    write_openmp_style_row,
    write_tile_config_row,
)
from sparsematrixvectormultiplication_tpu.bench.harness import BenchConfig, run_matrix
from sparsematrixvectormultiplication_tpu.models.synthetic import banded


@pytest.fixture(scope="module")
def result():
    coo = banded(1500, 8, 64, seed=0)
    cfg = BenchConfig(
        iterations=2, rounds=1, skip=1,
        kernels=("serial_csr", "serial_hll", "xla_csr", "xla_ell",
                 "sell", "sell_f64"),
        flush_between_stages=False,
    )
    return run_matrix("tiny_banded", coo, cfg, log=lambda *a, **k: None)


def test_all_stages_ran(result):
    assert set(result.stages) == {
        "serial_csr", "serial_hll", "xla_csr", "xla_ell",
        "sell", "sell_f64",
    }


def test_all_stages_validated(result):
    for name, s in result.stages.items():
        assert s.diff.significant_diffs == 0, (name, s.diff)
        assert s.seconds > 0
        assert s.gflops >= 0


def test_f64_more_accurate_than_f32(result):
    assert (result.stages["sell_f64"].diff.max_abs_err
            <= result.stages["sell"].diff.max_abs_err)


def test_speedup_computation(result):
    assert result.speedup("serial_csr") == 1.0
    assert result.speedup("nonexistent") == 0.0


def _read_csv(path):
    with open(path) as f:
        return list(csv.reader(f))


def test_native_csv(result, tmp_path):
    p = str(tmp_path / "native.csv")
    write_native_row(p, result)
    rows = _read_csv(p)
    assert rows[0] == NATIVE_HEADER
    assert len(rows) == 1 + len(result.stages)
    # appending keeps a single header
    write_native_row(p, result)
    rows = _read_csv(p)
    assert rows[0] == NATIVE_HEADER and len(rows) == 1 + 2 * len(result.stages)


def test_openmp_csv_schema(result, tmp_path):
    p = str(tmp_path / "openmp.csv")
    write_openmp_style_row(p, result, num_threads=1)
    rows = _read_csv(p)
    assert rows[0] == OPENMP_HEADER
    # reference column count per the reference's *code* (utility.c:114-120);
    # note: the reference's checked-in result/spmv_results_openmp.csv carries
    # an older 37-column schema (with stddev/min columns whose producing API
    # was never defined, performance_calculate.h:59-60) — we match the code.
    assert len(rows[1]) == 33
    assert rows[0][:11] == [
        "matrix_name", "rows", "cols", "nonzeros", "num_threads",
        "time_serial", "time_serial_hll", "time_parallel", "time_parallel_simd",
        "time_parallel_hll", "time_parallel_hll_simd",
    ]


def test_cuda_csv_schema(result, tmp_path):
    p = str(tmp_path / "cuda.csv")
    write_cuda_style_row(p, result)
    rows = _read_csv(p)
    assert rows[0] == CUDA_HEADER
    assert len(rows[1]) == 32  # reference column count (cuda utility.cu:115-123)


def test_tile_csv(result, tmp_path):
    p = str(tmp_path / "tiles.csv")
    write_tile_config_row(p, result)
    rows = _read_csv(p)
    assert len(rows) >= 2


def test_cli_end_to_end(tmp_path):
    from sparsematrixvectormultiplication_tpu.bench.cli import main
    from sparsematrixvectormultiplication_tpu.io.mmio import write_matrix_market

    coo = banded(600, 5, 30, seed=1)
    m = tmp_path / "mats"
    m.mkdir()
    write_matrix_market(str(m / "a.mtx"), coo.nrows, coo.ncols, coo.row, coo.col, coo.val)
    out = tmp_path / "result"
    rc = main([
        "--matrix-dir", str(m), "--output-dir", str(out),
        "--iterations", "2", "--rounds", "1", "--force-cpu-devices", "8",
        "--kernels", "serial_csr,xla_csr,sell",
    ])
    assert rc == 0
    assert (out / "spmv_results.csv").exists()
    assert (out / "spmv_results_openmp.csv").exists()
    # resume skips
    rc = main(["--matrix-dir", str(m), "--output-dir", str(out), "--resume",
               "--force-cpu-devices", "8"])
    assert rc == 0
    rows = _read_csv(str(out / "spmv_results.csv"))
    assert len(rows) == 1 + 3  # header + one row per stage, not duplicated


def test_sigma_stage():
    """On a power-law matrix the sell stage sorts rows inside windows
    (SELL-C-sigma) and still validates."""
    from sparsematrixvectormultiplication_tpu.models.synthetic import power_law

    coo = power_law(4096, 4, seed=9)
    cfg = BenchConfig(
        iterations=2, rounds=1, kernels=("serial_csr", "sell"),
        flush_between_stages=False,
    )
    res = run_matrix("pl", coo, cfg, log=lambda *a, **k: None)
    s = res.stages["sell"]
    assert s.diff.significant_diffs == 0
    assert s.extra["padding_ratio"] >= 1.0
    assert res.format_stats["sell"]["sigma"] > 1


def test_memory_stats_csv(result, tmp_path):
    from sparsematrixvectormultiplication_tpu.bench.csv_report import (
        MEMORY_STATS_HEADER,
        write_memory_stats_row,
    )

    p = str(tmp_path / "mem.csv")
    write_memory_stats_row(p, result.name, "csr", result.format_stats["csr"])
    write_memory_stats_row(p, result.name, "sell", result.format_stats["sell"])
    rows = _read_csv(p)
    assert rows[0] == MEMORY_STATS_HEADER and len(rows) == 3


def test_coo_summary():
    from sparsematrixvectormultiplication_tpu import COOMatrix

    coo = COOMatrix(3, 3, np.array([0, 2]), np.array([1, 0]), np.array([1.5, -2.0]))
    s = coo.summary(full=True)
    assert "3 x 3" in s and "nonzeros: 2" in s and "1.5" in s
    assert "nnz=2" in repr(coo)


def test_batched_timer_not_hoisted():
    """The chained timer must execute fn reps times, not once (LICM guard).

    With the loop-invariant hazard (scan body ignoring the carry), XLA may
    hoist fn out of the loop and the reps=16 time would match the reps=1
    time. A heavy matmul chain makes per-call time >> timer overhead so the
    ratio test is robust on CPU.
    """
    import jax
    import jax.numpy as jnp

    from sparsematrixvectormultiplication_tpu.utils.timing import (
        time_device_fn_batched,
    )

    a = jnp.asarray(np.random.default_rng(0).standard_normal((512, 512)), jnp.float32)

    def heavy(m):
        for _ in range(8):
            m = m @ m / jnp.maximum(jnp.max(jnp.abs(m)), 1.0)
        return m

    t1, _ = time_device_fn_batched(heavy, a, reps=1, rounds=3)
    t16, _ = time_device_fn_batched(heavy, a, reps=16, rounds=3)
    # per-call times must be comparable; a hoisted loop would give
    # t16 ~= t1/16. Allow wide slack for CPU scheduling noise.
    assert t16 > t1 / 4, f"per-call time collapsed under chaining: {t1} vs {t16}"


def test_batched_timer_zero_perturbation():
    """The chain perturbation adds exactly 0.0: the chained checksum must be
    reps * out[0] + 0 for a deterministic fn (verifies results stay
    bit-identical under chaining), including tuple-returning fns."""
    import jax.numpy as jnp

    from sparsematrixvectormultiplication_tpu.utils.timing import (
        time_device_fn_batched,
    )

    x = jnp.asarray(np.arange(64, dtype=np.float32))

    calls = {"n": 0}

    def fn(v):
        calls["n"] += 1  # trace-count only
        return v * 3.0 + 1.0, v  # tuple output path

    t, _ = time_device_fn_batched(fn, x, reps=7, rounds=1)
    assert t >= 0
    # fn is traced exactly once (inside one jitted scan), not re-jitted per rep
    assert calls["n"] <= 2


def test_native_csv_includes_new_stages(tmp_path):
    """sell / sell_bf16 / sell_f64 rows flow into the native CSV with their
    dtype labels and device bytes; the peak-bandwidth share stays empty on
    a CPU run (the writer iterates result.stages; this pins that
    contract)."""
    from sparsematrixvectormultiplication_tpu.models.synthetic import banded

    coo = banded(1200, 8, 64, seed=0)
    cfg = BenchConfig(
        iterations=2, rounds=1, skip=1,
        kernels=("serial_csr", "sell", "sell_bf16", "sell_f64"),
        flush_between_stages=False,
    )
    res = run_matrix("csv_stages", coo, cfg, log=lambda *a, **k: None)
    p = str(tmp_path / "native.csv")
    write_native_row(p, res)
    rows = _read_csv(p)
    by_stage = {r[4]: r for r in rows[1:]}
    assert {"sell", "sell_bf16", "sell_f64"} <= set(by_stage)
    assert by_stage["sell_bf16"][5] == "bfloat16"
    assert by_stage["sell_f64"][5] == "float64"
    bpn = NATIVE_HEADER.index("bytes_streamed_per_nnz")
    pct = NATIVE_HEADER.index("pct_peak_bw")
    # bf16 values stream fewer bytes than f32, f64 more
    assert (float(by_stage["sell_bf16"][bpn]) < float(by_stage["sell"][bpn])
            < float(by_stage["sell_f64"][bpn]))
    assert all(r[pct] == "" for r in rows[1:])


def test_hll_upload_guard_is_per_stage(monkeypatch):
    """An oversize ELL rectangle (MemoryError from HLLMatrix.to_rect's
    element cap) must skip that stage only; later stages survive."""
    from sparsematrixvectormultiplication_tpu.models.synthetic import banded

    coo = banded(1500, 8, 64, seed=0)
    cfg = BenchConfig(
        iterations=2, rounds=1, skip=1, ell_max_elements=10,
        kernels=("serial_csr", "xla_ell", "sell"),
        flush_between_stages=False,
    )
    msgs = []
    res = run_matrix("hll_oom", coo, cfg, log=lambda m, *a, **k: msgs.append(m))
    assert "xla_ell" not in res.stages
    assert "sell" in res.stages          # later stages survive
    assert any("xla_ell skipped" in m for m in msgs)
    assert res.failed["xla_ell"].startswith("skipped: ")


def test_stage_failure_is_per_stage(monkeypatch):
    """A device stage that raises is logged as FAILED and skipped; the
    matrix keeps its other stages (≙ the reference's per-matrix recovery,
    main.c:54-75, at stage granularity)."""
    from sparsematrixvectormultiplication_tpu.bench import harness as hz
    from sparsematrixvectormultiplication_tpu.models.synthetic import banded

    def broken(*a, **k):
        raise ValueError("kernel rejected")

    monkeypatch.setattr(hz, "sell_spmv", broken)
    cfg = BenchConfig(iterations=2, rounds=1, skip=1,
                      kernels=("serial_csr", "xla_csr", "sell"),
                      flush_between_stages=False)
    msgs = []
    res = run_matrix("broken", banded(800, 6, 48, seed=5), cfg,
                     log=lambda m, *a, **k: msgs.append(m))
    assert "sell" not in res.stages and "xla_csr" in res.stages
    assert any("sell FAILED: ValueError" in m for m in msgs)
    assert res.failed["sell"].startswith("ValueError: kernel rejected")
    assert res.problems() == ["broken/sell: ValueError: kernel rejected"]


def test_sell_f64_needs_x64():
    """Without jax_enable_x64 the fp64 stage fails loudly instead of
    silently running in f32."""
    import jax

    from sparsematrixvectormultiplication_tpu.models.synthetic import banded

    cfg = BenchConfig(iterations=2, rounds=1, kernels=("serial_csr", "sell_f64"),
                      flush_between_stages=False)
    msgs = []
    with jax.enable_x64(False):
        res = run_matrix("no_x64", banded(300, 4, 8, seed=1), cfg,
                         log=lambda m, *a, **k: msgs.append(m))
    assert "sell_f64" not in res.stages
    assert any("needs jax_enable_x64" in m for m in msgs)
    assert res.problems() == ["no_x64/sell_f64: needs jax_enable_x64"]


def test_run_device_validated_deterministic_and_detects_drift():
    """Per-iteration in-graph validation: a
    deterministic fn accumulates 0 drift across reps; a wrong reference
    reports the exact max deviation."""
    import jax.numpy as jnp

    from sparsematrixvectormultiplication_tpu.utils.timing import (
        run_device_validated,
    )

    a = jnp.arange(64, dtype=jnp.float32)
    fn = lambda v: v * 2.0 + 1.0
    y0 = fn(a)
    diff, sec = run_device_validated(fn, a, y_ref=y0, reps=4)
    assert diff == 0.0
    assert sec > 0
    # perturbed reference: max |y - (y0+3)| = 3 on every iteration
    diff2, _ = run_device_validated(fn, a, y_ref=y0 + 3.0, reps=4)
    assert abs(diff2 - 3.0) < 1e-6


def test_harness_device_validate_flag():
    """cfg.device_validate records per-stage drift metrics in extra."""
    import numpy as np

    from sparsematrixvectormultiplication_tpu.bench.harness import (
        BenchConfig, run_matrix,
    )
    from sparsematrixvectormultiplication_tpu.models.synthetic import banded

    coo = banded(512, nnz_per_row=4, bandwidth=16, seed=3)
    cfg = BenchConfig(iterations=2, rounds=1, device_validate=True,
                      kernels=("serial_csr", "sell"))
    res = run_matrix("dv_probe", coo, cfg, log=lambda *_: None)
    s = res.stages["sell"]
    assert "device_val_max_diff" in s.extra
    assert s.extra["device_val_max_diff"] == 0.0
    assert s.extra["device_val_reps"] == 2


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float64"])
def test_every_device_stage_validates(dtype):
    """Each device stage at each value precision, in ``A B B A`` order,
    validates against the oracle with a seeded random x; on the CPU the
    BCSR stage takes JAX's generic lowering."""
    from sparsematrixvectormultiplication_tpu.bench.harness import DEVICE_STAGES

    order = ("xla_csr", "xla_ell", "cusparse_csr", "sell")
    cfg = BenchConfig(iterations=2, rounds=1, skip=1, dtype=dtype,
                      kernels=("serial_csr",) + order + order[::-1],
                      flush_between_stages=False)
    msgs = []
    res = run_matrix("dtypes", banded(900, 7, 50, seed=4), cfg,
                     log=lambda m, *a, **k: msgs.append(m))
    assert set(order) <= set(DEVICE_STAGES)
    assert res.problems() == [] and not res.failed
    assert set(res.stages) == {"serial_csr", *order}
    assert sum("again" in m for m in msgs) == len(order)
    assert res.stage("cusparse_csr").extra["cusparse"] is False


def test_repeated_stage_keeps_best_time(monkeypatch):
    """A stage listed twice is validated once, timed twice, and keeps the
    better of its two times."""
    from sparsematrixvectormultiplication_tpu.bench import harness as hz

    times = iter([3e-3, 1e-3])
    monkeypatch.setattr(hz, "time_device_fn_batched",
                        lambda *a, **k: (next(times), []))
    cfg = BenchConfig(iterations=2, rounds=1, skip=1,
                      kernels=("serial_csr", "sell", "sell"),
                      flush_between_stages=False)
    res = run_matrix("twice", banded(400, 5, 20, seed=2), cfg,
                     log=lambda *a, **k: None)
    assert res.stage("sell").seconds == 1e-3
    assert np.isclose(res.stage("sell").gflops, 2 * res.nnz / 1e-3 / 1e9)


def test_problems_lists_invalid_and_missing(monkeypatch):
    """``problems`` names a stage whose result is wrong and a stage that
    never ran; a clean run has none."""
    from sparsematrixvectormultiplication_tpu.bench import harness as hz

    good = hz.sell_spmv
    monkeypatch.setattr(hz, "sell_spmv", lambda d, x: good(d, x) * 1.01)
    cfg = BenchConfig(iterations=2, rounds=1, skip=1,
                      kernels=("serial_csr", "sell", "sell_f64", "nope"),
                      flush_between_stages=False)
    res = run_matrix("bad", banded(500, 5, 30, seed=3), cfg,
                     log=lambda *a, **k: None)
    probs = res.problems()
    assert any("bad/sell:" in p and "significant" in p for p in probs)
    assert any("bad/sell_f64:" in p for p in probs)
    assert any("bad/nope: unknown stage" in p for p in probs)


def test_default_x_sees_a_wrong_column(monkeypatch):
    """With x = ones a kernel that reads the wrong columns still returns
    each row's value sum and validates; the harness's default random x
    exposes it."""
    from sparsematrixvectormultiplication_tpu import CSRMatrix
    from sparsematrixvectormultiplication_tpu.bench import harness as hz

    real = hz.device_put_csr

    def shifted(csr, dtype=None):
        return real(CSRMatrix(csr.nrows, csr.ncols, csr.row_ptr,
                              (csr.col_idx + 1) % csr.ncols, csr.values),
                    dtype=dtype)

    monkeypatch.setattr(hz, "device_put_csr", shifted)
    coo = banded(600, 6, 40, seed=7)
    cfg = BenchConfig(iterations=2, rounds=1, skip=1,
                      kernels=("serial_csr", "xla_csr"),
                      flush_between_stages=False)
    quiet = dict(log=lambda *a, **k: None)
    assert run_matrix("ones", coo, cfg, x=np.ones(coo.ncols), **quiet) \
        .problems() == []
    assert run_matrix("random", coo, cfg, **quiet).problems()


def test_roundoff_check_catches_f32_in_an_f64_stage():
    """An fp64 result carried in f32 passes the reference tolerances but
    not the fp64 round-off bound; the exact product passes both."""
    from sparsematrixvectormultiplication_tpu import CSRMatrix
    from sparsematrixvectormultiplication_tpu.utils.validation import (
        difference_metrics,
        roundoff_metrics,
        roundoff_scale,
    )

    csr = CSRMatrix.from_coo(banded(800, 9, 60, seed=1))
    x = np.random.default_rng(0).standard_normal(csr.ncols)
    ref = csr.spmv(x)
    scale, k = roundoff_scale(csr, x)
    assert k == int(csr.row_nnz().max())
    assert np.allclose(scale, np.abs(csr.to_scipy()) @ np.abs(x))
    y32 = ref.astype(np.float32).astype(np.float64)
    assert difference_metrics(ref, y32).significant_diffs == 0
    assert roundoff_metrics(ref, y32, scale, k).significant_diffs > 0
    assert roundoff_metrics(ref, ref.copy(), scale, k).significant_diffs == 0
    nan = ref.copy()
    nan[3] = np.nan
    assert roundoff_metrics(ref, nan, scale, k).significant_diffs == 1


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_chained_timer_copies_x_once(dtype):
    """The timed loop perturbs x in place: the compiled program copies x
    once, before the loop, and not in every iteration (a copy per
    iteration would add a read and a write of x to every timed product)."""
    import re

    import jax.numpy as jnp

    from sparsematrixvectormultiplication_tpu import COOMatrix, SellMatrix
    from sparsematrixvectormultiplication_tpu.ops.sell import (
        device_put_sell,
        sell_spmv,
    )
    from sparsematrixvectormultiplication_tpu.utils.timing import chained_calls

    rng = np.random.default_rng(5)
    m, n, nnz = 300, 1000, 3000            # x's shape differs from y's
    coo = COOMatrix(m, n, rng.integers(0, m, nnz), rng.integers(0, n, nnz),
                    rng.standard_normal(nnz))
    d = device_put_sell(SellMatrix.from_coo(coo), jnp.dtype(dtype))
    x = jnp.ones(n, dtype)
    hlo = chained_calls(sell_spmv, d, x, reps=4).lower(d, x).compile().as_text()
    tag = {"float32": "f32", "float64": "f64"}[dtype]
    copies = re.findall(rf"= {tag}\[{n}\]\{{0\}} copy\(", hlo)
    assert len(copies) <= 1, copies


def test_compare_matrix_tiny():
    """The comparison script's per-matrix step at a tiny size: every
    implementation at every precision gives one validated row."""
    from sparsematrixvectormultiplication_tpu.bench.compare import (
        IMPLS,
        compare_matrix,
    )

    dtypes = ("float32", "bfloat16", "float64")
    rows, problems = compare_matrix("tiny", banded(500, 5, 30, seed=1),
                                    dtypes, reps=2, rounds=1,
                                    log=lambda *a: None)
    assert problems == []
    assert {(r["dtype"], r["impl"]) for r in rows} == {
        (d, i) for d in dtypes for i in IMPLS}
    assert all(r["sig_diffs"] == 0 and r["seconds"] > 0 for r in rows)
