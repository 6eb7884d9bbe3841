"""The one-call user surface: convert, upload, and return an operator.

The reference makes the user pick a kernel (serial/OpenMP/CUDA x CSR/HLL,
main.c / main_cuda.cu). Here one layout serves both of its regimes:
SELL-C-σ with slot-major slices (the coalesced thread-per-row kernel that
won on short rows) and heavy-row splitting (for the long rows its
warp-per-row kernel served). :func:`auto_device_op` converts to it,
uploads, and returns the operator.
"""

from __future__ import annotations

from dataclasses import dataclass

import jax.numpy as jnp
import numpy as np

from ..formats.csr import CSRMatrix
from ..formats.sell import SellMatrix
from .sell import DeviceSell, device_put_sell, sell_spmv

__all__ = ["auto_device_op", "AutoOp"]


@dataclass
class AutoOp:
    """Uploaded SpMV operator. ``matvec(x)`` takes and returns numpy arrays
    (host round trip included); ``__call__`` takes and returns device
    arrays and can be used inside jitted code, such as the solvers."""

    host: SellMatrix       # the host conversion product (oracle ``.spmv``)
    device: DeviceSell

    @property
    def nrows(self) -> int:
        return self.host.nrows

    @property
    def ncols(self) -> int:
        return self.host.ncols

    @property
    def dtype(self):
        return self.device.dtype

    def __call__(self, x):
        return sell_spmv(self.device, x)

    def matvec(self, x) -> np.ndarray:
        return np.asarray(self(jnp.asarray(np.asarray(x, np.float64))),
                          np.float64)


def auto_device_op(csr: CSRMatrix, dtype=jnp.float32, *,
                   device=None) -> AutoOp:
    """CSR -> SELL-C-σ -> device, in one call."""
    host = SellMatrix.from_csr(csr)
    return AutoOp(host=host, device=device_put_sell(host, dtype, device))
