"""SpMV framework for NVIDIA GPUs, in JAX.

A re-design of the capabilities of the C/OpenMP/CUDA reference
``MarcoLor01/SparseMatrixVectorMultiplication``: MatrixMarket IO, CSR / HLL
(hacked-ELLPACK) / SELL-C-σ layouts, XLA device operators in f32, bf16
values and native fp64, nnz-balanced scheduling, multi-device
sharding, iterative solvers, and a validating GFLOPS benchmark harness.
See SURVEY.md for the layer map and docs/DESIGN.md for the GPU design.
"""

from .formats.coo import COOMatrix
from .formats.csr import CSRMatrix
from .formats.hll import DEFAULT_HACK_SIZE, HLLMatrix
from .formats.sell import SellMatrix
from .ops.auto import auto_device_op
from .io.mmio import (
    MMIOError,
    MMTypeCode,
    read_banner,
    read_matrix_market,
    write_matrix_market,
)

__version__ = "0.1.0"

__all__ = [
    "COOMatrix",
    "CSRMatrix",
    "HLLMatrix",
    "SellMatrix",
    "auto_device_op",
    "DEFAULT_HACK_SIZE",
    "MMIOError",
    "MMTypeCode",
    "read_banner",
    "read_matrix_market",
    "write_matrix_market",
    "__version__",
]
