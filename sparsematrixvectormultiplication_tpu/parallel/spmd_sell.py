"""Row-sharded SELL-C-σ SpMV under ``shard_map``.

One program over a ``Mesh`` axis: rows are split into contiguous,
nnz-balanced ranges (``balanced_partition``), x is replicated, and each
device runs the SELL operator (:func:`..ops.sell.sell_spmv`) on its own
rows, with no collective in the product (the DP layout of SURVEY §2.4; the
reference's closest analogue is the per-thread contiguous row ranges of
csr_matrix.c:167-266, here promoted to devices).

``shard_map`` needs one static shape for every shard, so all shards are
converted with the whole matrix's geometry (slice height, sort window,
bin widths) and each bin is padded to the largest shard's slice count with
empty slices. A shard's local output has ``R`` row slots (the largest
shard's rows) followed by ``E`` heavy-row segment slots; padding rows and
slices get distinct slots from ``R + E`` up and are dropped, and unused
segment slots name row ``R``, outside the fold's range, so they add
nothing.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np
from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..formats.csr import CSRMatrix
from ..formats.sell import SellGeometry, SellMatrix, distinct_padding
from ..ops.sell import DeviceSell, sell_spmv
from .scheduler import balanced_partition

__all__ = ["SpmdSell", "build_spmd_sell", "sell_spmv_spmd"]

# rows per partition item: balancing per row would loop over every row
_BALANCE_BLOCK = 256


@dataclass
class SpmdSell:
    """Stacked, mesh-sharded SELL shards (leading axis = shard)."""

    stacked: DeviceSell      # every array leaf has a leading n_shards axis
    row_starts: np.ndarray   # (n_shards + 1,) global first row of each shard
    local_rows: int          # R: row slots per shard
    nrows: int
    ncols: int
    nnz: int
    axis: str = "rows"

    @property
    def n_shards(self) -> int:
        return int(self.row_starts.size - 1)


def _row_slice(csr: CSRMatrix, r0: int, r1: int) -> CSRMatrix:
    p0, p1 = int(csr.row_ptr[r0]), int(csr.row_ptr[r1])
    return CSRMatrix(r1 - r0, csr.ncols, csr.row_ptr[r0:r1 + 1] - p0,
                     csr.col_idx[p0:p1], csr.values[p0:p1])


def _pad_bin(cols, vals, rows, n):
    extra = n - rows.shape[0]
    if extra == 0:
        return cols, vals, rows
    k, c = cols.shape[1:]
    return (np.concatenate([cols, np.zeros((extra, k, c), cols.dtype)]),
            np.concatenate([vals, np.zeros((extra, k, c), vals.dtype)]),
            np.concatenate([rows, np.full((extra, c), -1, rows.dtype)]))


def build_spmd_sell(csr: CSRMatrix, n_shards: int, *, dtype=jnp.float32,
                    mesh: Mesh | None = None, axis: str = "rows") -> SpmdSell:
    """Split ``csr`` into ``n_shards`` nnz-balanced row ranges, convert each
    with the whole matrix's SELL geometry, and stack them (on ``mesh``,
    sharded along ``axis``, when given)."""
    n_shards = max(1, int(n_shards))
    M = csr.nrows
    nb = -(-M // _BALANCE_BLOCK)
    row_nnz = np.zeros(nb * _BALANCE_BLOCK, np.int64)
    row_nnz[:M] = csr.row_nnz()
    part = balanced_partition(
        row_nnz.reshape(nb, _BALANCE_BLOCK).sum(axis=1), n_shards)
    starts = [min(s * _BALANCE_BLOCK, M) for s, _, _ in part]
    starts += [M] * (n_shards + 1 - len(starts))   # empty trailing shards
    geometry = SellGeometry.of(csr)
    shards = [SellMatrix.from_csr(_row_slice(csr, a, b), geometry)
              for a, b in zip(starts[:-1], starts[1:])]

    R = max(max(s.nrows for s in shards), 1)
    E = max(s.seg_owner.size for s in shards)
    np_dtype = np.dtype(jnp.dtype(dtype))
    ks = sorted({b.k for s in shards for b in s.bins})
    bins = {k: [] for k in ks}
    seg = []
    for s in shards:
        by_k = {b.k: b for b in s.bins}
        for k in ks:
            b = by_k.get(k)
            if b is None:
                cols = np.zeros((0, k, geometry.c), np.int32)
                vals = np.zeros((0, k, geometry.c), np_dtype)
                rows = np.zeros((0, geometry.c), np.int32)
            else:
                # local slots: rows 0..nrows-1 stay, segment slots move
                # behind the R row slots, padding is marked -1
                rows = b.rows.astype(np.int64)
                rows = np.where(rows >= s.n_dest, -1,
                                np.where(rows >= s.nrows,
                                         rows - s.nrows + R, rows))
                cols, vals = b.cols, b.vals.astype(np_dtype)
            bins[k].append((cols, vals, rows))
        seg.append(np.concatenate(
            [s.seg_owner, np.full(E - s.seg_owner.size, R, np.int32)]))
    stacked_bins = []
    for k in ks:
        n = max(r.shape[0] for _, _, r in bins[k])
        bins[k] = [_pad_bin(*b, n) for b in bins[k]]
    for i in range(n_shards):   # distinct padding slots within each shard
        rows = distinct_padding([bins[k][i][2] for k in ks], R + E)
        for k, r in zip(ks, rows):
            bins[k][i] = bins[k][i][:2] + (r,)
    for k in ks:
        stacked_bins.append(tuple(np.stack([p[j] for p in bins[k]])
                                  for j in range(3)))
    seg_owner = np.stack(seg).astype(np.int32)

    if mesh is not None:
        def put(a):
            spec = P(axis, *([None] * (a.ndim - 1)))
            return jax.device_put(a, NamedSharding(mesh, spec))
    else:
        put = jnp.asarray
    stacked = DeviceSell([tuple(put(a) for a in b) for b in stacked_bins],
                         put(seg_owner), R, csr.ncols, csr.nnz, dtype)
    return SpmdSell(stacked, np.asarray(starts, np.int64), R, M, csr.ncols,
                    csr.nnz, axis)


@functools.partial(jax.jit, static_argnames=("mesh", "axis"))
def spmd_run(stacked, x, *, mesh, axis):
    """The sharded product: ``(n_shards * R,)`` local outputs, row-sharded."""
    def local(st, xl):
        d = jax.tree_util.tree_map(lambda a: a[0], st)
        return sell_spmv(d, xl)

    return shard_map(local, mesh=mesh, in_specs=(P(axis), P()),
                     out_specs=P(axis), check_vma=False)(stacked, x)


def sell_spmv_spmd(spmd: SpmdSell, x, mesh: Mesh):
    """``y = A @ x`` with the SELL operator running SPMD over ``mesh``.

    Returns the global y (host numpy) in natural row order."""
    xr = jax.device_put(jnp.asarray(x), NamedSharding(mesh, P()))
    y = np.asarray(spmd_run(spmd.stacked, xr, mesh=mesh, axis=spmd.axis))
    R = spmd.local_rows
    counts = np.diff(spmd.row_starts)
    return np.concatenate([y[i * R: i * R + int(n)]
                           for i, n in enumerate(counts)])
