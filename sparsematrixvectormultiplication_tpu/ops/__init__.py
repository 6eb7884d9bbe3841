"""Device SpMV: the SELL-C-σ operator and the plain XLA CSR / ELL kernels."""

from .sell import DeviceSell, device_put_sell, sell_spmv
from .xla import (
    DeviceCSR,
    DeviceELL,
    csr_spmm,
    csr_spmv,
    device_put_csr,
    device_put_ell,
    ell_spmv,
)

__all__ = [
    "DeviceSell", "device_put_sell", "sell_spmv",
    "DeviceCSR", "DeviceELL", "csr_spmv", "csr_spmm", "device_put_csr",
    "device_put_ell", "ell_spmv",
]
