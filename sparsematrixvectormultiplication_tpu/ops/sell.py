"""SELL-C-σ SpMV on the device, in plain XLA.

It reads the layout of :mod:`..formats.sell`: per bin, ``(n, k, c)``
column and value planes and an ``(n, c)`` plane of destination slots. Per
bin, XLA fuses the gather ``x[cols]`` into the reduction over the bin's
``k`` slots, which reads each plane once with coalesced loads (slot-major
storage), and scatters the ``c`` sums of each slice to their slots. Every
slot, padding included, is distinct, so the scatter is declared
``unique_indices`` and needs no atomics.

Values in f32 and bf16 accumulate in f32 with an f32 ``x``; f64 values
accumulate in f64. Index planes stay int32 under ``jax_enable_x64``.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["DeviceSell", "device_put_sell", "sell_spmv", "acc_dtype"]


def acc_dtype(dtype):
    """Accumulation (and output) dtype for values of ``dtype``."""
    return jnp.float64 if jnp.dtype(dtype) == jnp.float64 else jnp.float32


@jax.tree_util.register_pytree_node_class
class DeviceSell:
    """A :class:`..formats.sell.SellMatrix` in device memory.

    A pytree, so it is passed to jitted code as an argument."""

    def __init__(self, bins, seg_owner, nrows, ncols, nnz, dtype):
        self.bins = tuple(tuple(b) for b in bins)   # ((cols, vals, rows), ...)
        self.seg_owner = seg_owner
        self.nrows = int(nrows)
        self.ncols = int(ncols)
        self.nnz = int(nnz)
        self.dtype = jnp.dtype(dtype)               # value dtype

    @property
    def n_dest(self) -> int:
        return self.nrows + int(self.seg_owner.shape[-1])

    def tree_flatten(self):
        return (self.bins, self.seg_owner), (self.nrows, self.ncols, self.nnz,
                                             self.dtype)

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children, *aux)


def device_put_sell(sell, dtype=jnp.float32, device=None) -> DeviceSell:
    """Upload a host SELL matrix with values cast to ``dtype``."""
    np_dtype = np.dtype(jnp.dtype(dtype))

    def put(a):
        return jax.device_put(a, device)

    bins = [(put(np.asarray(b.cols, np.int32)),
             put(np.asarray(b.vals).astype(np_dtype)),
             put(np.asarray(b.rows, np.int32))) for b in sell.bins]
    return DeviceSell(bins, put(np.asarray(sell.seg_owner, np.int32)),
                      sell.nrows, sell.ncols, sell.nnz, dtype)


@jax.jit
def sell_spmv(d: DeviceSell, x):
    """``y = A @ x`` over the SELL layout."""
    acc = acc_dtype(d.dtype)
    if not d.bins or d.ncols == 0:
        return jnp.zeros((d.nrows,), acc)
    x = x.astype(acc)
    y = jnp.zeros((d.n_dest,), acc)
    for cols, vals, rows in d.bins:
        part = jnp.sum(vals.astype(acc) * x[cols], axis=1)
        y = y.at[rows.reshape(-1)].set(part.reshape(-1), mode="drop",
                                       unique_indices=True)
    if d.n_dest == d.nrows:
        return y
    # the extra heavy-row segment slots, summed back into their rows
    return y[: d.nrows].at[d.seg_owner].add(y[d.nrows:])
