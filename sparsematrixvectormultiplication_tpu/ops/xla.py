"""XLA (pure-jnp) CSR and ELL SpMV kernels.

The jittable counterparts of the reference's serial loops (SURVEY §7 step
3): the CSR segment-sum kernel ≙ the golden serial CSR row loop
(src/csr_matrix.c:130-139), the padded ELL kernel ≙ the serial HLL loop
(src/hll_matrix.c:286-308). They run on any backend; the SELL-C-σ
operator in :mod:`.sell` is the main path.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

__all__ = [
    "csr_spmv",
    "csr_spmm",
    "ell_spmv",
    "DeviceCSR",
    "DeviceELL",
    "device_put_csr",
    "device_put_ell",
]


@functools.partial(jax.jit, static_argnames=("nrows",))
def csr_spmv(values, col_idx, row_ids, x, *, nrows: int):
    """CSR SpMV: ``y = segment_sum(values * x[col_idx], row_ids)``.

    ``row_ids`` is the expanded per-entry row index (sorted ascending, as
    produced by :meth:`formats.csr.CSRMatrix.row_ids`).
    """
    prod = values * jnp.take(x, col_idx)
    return jax.ops.segment_sum(
        prod, row_ids, num_segments=nrows, indices_are_sorted=True
    )


@functools.partial(jax.jit, static_argnames=("nrows",))
def csr_spmm(values, col_idx, row_ids, X, *, nrows: int):
    """CSR multi-RHS SpMM: ``Y = segment_sum(values[:, None] * X[col_idx], row_ids)``.

    Each step streams A once for all columns of ``X`` (the multi-RHS
    operator of ``solvers.cg_multi`` and ``solvers.subspace_iteration``).
    It is elementwise products and sums, not a matrix product, so no
    reduced-precision (TF32) path applies to f32 inputs.
    """
    prod = values[:, None] * jnp.take(X, col_idx, axis=0)
    return jax.ops.segment_sum(
        prod, row_ids, num_segments=nrows, indices_are_sorted=True
    )


@jax.jit
def ell_spmv(ja, as_, x):
    """Padded-ELL SpMV over a rectangle: ``y[i] = sum_k as_[i,k] * x[ja[i,k]]``.

    Padding entries carry ``as_ == 0`` and an in-bounds column (reference
    hll_matrix.c:241-246), so they contribute nothing.
    """
    return jnp.sum(as_ * jnp.take(x, ja), axis=1)


# --------------------------------------------------------------------------
# Device-resident containers (≙ the reference's cudaMalloc/Memcpy upload layer,
# main_cuda.cu:134-145 / 376-402 — here a jax.device_put of packed arrays).
# --------------------------------------------------------------------------


@jax.tree_util.register_pytree_node_class
class DeviceCSR:
    """CSR arrays resident on device (a pytree, so it passes through jit as
    an argument rather than being baked into the program as a constant)."""

    def __init__(self, values, col_idx, row_ids, nrows, ncols):
        self.values = values
        self.col_idx = col_idx
        self.row_ids = row_ids
        self.nrows = int(nrows)
        self.ncols = int(ncols)

    @property
    def nnz(self):
        return int(self.values.shape[0])

    def spmv(self, x):
        return csr_spmv(self.values, self.col_idx, self.row_ids, x, nrows=self.nrows)

    def tree_flatten(self):
        return (self.values, self.col_idx, self.row_ids), (self.nrows, self.ncols)

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children, *aux)


@jax.tree_util.register_pytree_node_class
class DeviceELL:
    """Rectangular padded ELL arrays resident on device (HLL rect view)."""

    def __init__(self, ja, as_, nrows, ncols, nnz):
        self.ja = ja
        self.as_ = as_
        self.nrows = int(nrows)
        self.ncols = int(ncols)
        self.nnz = int(nnz)

    def spmv(self, x):
        return ell_spmv(self.ja, self.as_, x)[: self.nrows]

    def tree_flatten(self):
        return (self.ja, self.as_), (self.nrows, self.ncols, self.nnz)

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children, *aux)


def device_put_csr(csr, dtype=None, device=None) -> DeviceCSR:
    vals = csr.values if dtype is None else csr.values.astype(dtype)
    return DeviceCSR(
        jax.device_put(jnp.asarray(vals), device),
        jax.device_put(jnp.asarray(csr.col_idx), device),
        jax.device_put(jnp.asarray(csr.row_ids()), device),
        csr.nrows,
        csr.ncols,
    )


def device_put_ell(hll, dtype=None, device=None, max_elements: int = 1 << 31) -> DeviceELL:
    ja, as_ = hll.to_rect(max_elements=max_elements)
    if dtype is not None:
        as_ = as_.astype(dtype)
    return DeviceELL(
        jax.device_put(jnp.asarray(ja), device),
        jax.device_put(jnp.asarray(as_), device),
        hll.nrows,
        hll.ncols,
        hll.nnz,
    )
