"""Correctness validation — differential metrics vs the golden reference.

Ports both validator formulations of the reference:

* :func:`difference_metrics` — the OpenMP-side validator
  (src/performance_calculate.c:116-178): per element, relative difference
  ``abs_diff / max(|a|, |b|, rel_tol)`` counted only where ``abs_diff >
  abs_tol`` and ``rel_diff > rel_tol`` ("significant"); returns the mean of
  significant relative errors and their count (``mean_abs_err`` hardwired to
  0.0, matching performance_calculate.c:158).
* :func:`difference_metrics_mean` — the CUDA-side validator
  (cuda_src/performance_calculate.cu:103-148): plain mean absolute and mean
  relative error over all entries.

fp64 results are checked more tightly, against the round-off bound of
their dot products (:func:`roundoff_metrics`): the reference tolerances
would pass an fp64 stage that had computed in f32.

Both are vectorized numpy; jnp twins run device-side inside the bench loop so
validation does not force a host round-trip per iteration (unlike the
reference, which copies y D2H every iteration, main_cuda.cu:183-188).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

__all__ = [
    "DiffMetrics",
    "difference_metrics",
    "difference_metrics_mean",
    "roundoff_metrics",
    "roundoff_scale",
    "sampled_spmm_metrics",
    "DEFAULT_ABS_TOL",
    "DEFAULT_REL_TOL",
]


def sampled_spmm_metrics(csr, X, Y, abs_tol=None, rel_tol=None,
                         max_cols: int = 4) -> "DiffMetrics":
    """Validate an SpMM result against the fp64 oracle on a few sampled
    columns (a full host fp64 SpMM would dwarf a benchmark stage's
    wall-clock). ``__add__`` sums sig_diffs and maxes the max errors;
    ``scaled`` restores the means. Shared by the harness BSR stage and
    the SpMM device-scale sweep."""
    b = X.shape[1]
    cols = np.unique(np.linspace(0, b - 1, min(max_cols, b)).astype(int))
    dm = DiffMetrics()
    for c in cols:
        ref_c = csr.spmv(np.asarray(X[:, c], np.float64))
        dm = dm + difference_metrics(
            ref_c, np.asarray(Y[:csr.nrows, c], np.float64),
            abs_tol if abs_tol is not None else DEFAULT_ABS_TOL,
            rel_tol if rel_tol is not None else DEFAULT_REL_TOL)
    return dm.scaled(1.0 / max(len(cols), 1))

# Tolerances at the reference call sites (main.c:145,207,260,310,362).
DEFAULT_ABS_TOL = 1e-5
DEFAULT_REL_TOL = 1e-4


@dataclass
class DiffMetrics:
    """≙ reference ``struct DifferenceMetrics`` (performance_calculate.h)."""

    mean_abs_err: float = 0.0
    mean_rel_err: float = 0.0
    significant_diffs: int = 0
    max_abs_err: float = 0.0
    max_rel_err: float = 0.0

    def __add__(self, other: "DiffMetrics") -> "DiffMetrics":
        return DiffMetrics(
            self.mean_abs_err + other.mean_abs_err,
            self.mean_rel_err + other.mean_rel_err,
            self.significant_diffs + other.significant_diffs,
            max(self.max_abs_err, other.max_abs_err),
            max(self.max_rel_err, other.max_rel_err),
        )

    def scaled(self, k: float) -> "DiffMetrics":
        return DiffMetrics(
            self.mean_abs_err * k,
            self.mean_rel_err * k,
            self.significant_diffs,
            self.max_abs_err,
            self.max_rel_err,
        )


def difference_metrics(
    ref,
    res,
    abs_tol: float = DEFAULT_ABS_TOL,
    rel_tol: float = DEFAULT_REL_TOL,
) -> DiffMetrics:
    """OpenMP-style validator (≙ computeDifferenceMetrics,
    src/performance_calculate.c:116-178)."""
    ref = np.asarray(ref, dtype=np.float64)
    res = np.asarray(res, dtype=np.float64)
    if ref.size == 0:
        return DiffMetrics()
    abs_diff = np.abs(ref - res)
    max_abs = np.maximum(np.abs(ref), np.abs(res))
    denom = np.maximum(max_abs, rel_tol)
    rel_diff = np.where(abs_diff > abs_tol, abs_diff / denom, 0.0)
    significant = rel_diff > rel_tol
    n_sig = int(np.count_nonzero(significant))
    mean_rel = float(rel_diff[significant].sum() / n_sig) if n_sig else 0.0
    return DiffMetrics(
        mean_abs_err=0.0,  # reference hardwires 0.0 (performance_calculate.c:158)
        mean_rel_err=mean_rel,
        significant_diffs=n_sig,
        max_abs_err=float(abs_diff.max()),
        max_rel_err=float(rel_diff.max()),
    )


def roundoff_scale(csr, x) -> tuple:
    """``(|A| |x|, k)`` for :func:`roundoff_metrics`: the per-row sum of
    ``|a_ij x_j|`` and the longest row's length."""
    from ..formats.csr import CSRMatrix

    a = CSRMatrix(csr.nrows, csr.ncols, csr.row_ptr, csr.col_idx,
                  np.abs(np.asarray(csr.values, np.float64)))
    k = int(np.max(np.diff(csr.row_ptr), initial=1))
    return a.spmv(np.abs(np.asarray(x, np.float64))), max(k, 1)


def roundoff_metrics(ref, res, scale, k: int) -> DiffMetrics:
    """fp64 validator: entry ``i`` is significant when ``|res_i - ref_i|``
    exceeds ``2 k eps scale_i``, with ``scale = |A| |x|`` and ``k`` the
    longest row (:func:`roundoff_scale`). That is the forward-error bound
    of a ``k``-term dot product in fp64, doubled because both sides round,
    each in its own summation order. ``max_rel_err`` is the largest
    ``|res_i - ref_i| / scale_i``; ``mean_rel_err`` its mean over the
    significant entries."""
    ref = np.asarray(ref, dtype=np.float64)
    res = np.asarray(res, dtype=np.float64)
    if ref.size == 0:
        return DiffMetrics()
    abs_diff = np.abs(ref - res)
    scale = np.asarray(scale, np.float64)
    rel = np.where(abs_diff > 0, abs_diff / np.maximum(scale, 1e-300), 0.0)
    rel = np.where(np.isfinite(res), rel, np.inf)
    significant = ~(abs_diff <= 2 * k * np.finfo(np.float64).eps * scale)
    n_sig = int(np.count_nonzero(significant))
    return DiffMetrics(
        mean_abs_err=0.0,
        mean_rel_err=float(rel[significant].mean()) if n_sig else 0.0,
        significant_diffs=n_sig,
        max_abs_err=float(abs_diff.max()),
        max_rel_err=float(rel.max()),
    )


def difference_metrics_mean(
    ref,
    res,
    rel_tol: float = DEFAULT_REL_TOL,
) -> DiffMetrics:
    """CUDA-style validator: mean abs/rel over all entries
    (≙ cuda_src/performance_calculate.cu:103-148; default rel_tol
    performance_calculate.cuh:49-55)."""
    ref = np.asarray(ref, dtype=np.float64)
    res = np.asarray(res, dtype=np.float64)
    if ref.size == 0:
        return DiffMetrics()
    abs_diff = np.abs(ref - res)
    denom = np.maximum(np.maximum(np.abs(ref), np.abs(res)), rel_tol)
    rel_diff = abs_diff / denom
    return DiffMetrics(
        mean_abs_err=float(abs_diff.mean()),
        mean_rel_err=float(rel_diff.mean()),
        significant_diffs=int(np.count_nonzero(rel_diff > rel_tol)),
        max_abs_err=float(abs_diff.max()),
        max_rel_err=float(rel_diff.max()),
    )


def difference_metrics_device(ref, res, abs_tol=DEFAULT_ABS_TOL, rel_tol=DEFAULT_REL_TOL):
    """jnp twin of :func:`difference_metrics` — runs on device, returns a dict
    of scalars (keeps per-iteration validation off the host)."""
    import jax.numpy as jnp

    abs_diff = jnp.abs(ref - res)
    denom = jnp.maximum(jnp.maximum(jnp.abs(ref), jnp.abs(res)), rel_tol)
    rel_diff = jnp.where(abs_diff > abs_tol, abs_diff / denom, 0.0)
    significant = rel_diff > rel_tol
    n_sig = jnp.sum(significant)
    return {
        "sum_sig_rel_err": jnp.sum(jnp.where(significant, rel_diff, 0.0)),
        "significant_diffs": n_sig,
        "max_abs_err": jnp.max(abs_diff),
        "max_rel_err": jnp.max(rel_diff),
    }
