"""Multi-device SpMV — mesh sharding via shard_map / jit shardings.

The reference has no distribution of any kind (SURVEY §2.4: single process,
OpenMP shared memory, one GPU). This module is the scaling layer, with
XLA's collectives (NCCL on GPUs) where MPI would have been:

* **Row sharding (the DP analogue)** — A's rows (ELL rectangles or SELL
  groups) are partitioned across the mesh's ``rows`` axis, balanced by nnz
  with :func:`..parallel.scheduler.balanced_partition` (≙ the reference's
  per-thread nnz-balanced row ranges, csr_matrix.c:167-266, promoted from
  threads to chips). x is replicated; y comes out row-sharded; no collective
  is needed in the hot loop — the cheapest layout when x fits per-chip HBM.

* **Column sharding (the TP analogue)** — A's columns and x are sharded;
  every chip computes a partial y over its column slice and a ``psum`` over
  the ``cols`` axis reduces partials (≙ SURVEY §2.4 "column-sharding
  of A with partial-sum reduce").

* **2-D sharding** — both at once on a (rows, cols) mesh.

All functions take an explicit ``Mesh`` so tests run them on a virtual
8-device CPU mesh (tests/conftest.py) and the driver's ``dryrun_multichip``
compiles them for N devices.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from .scheduler import balanced_partition

__all__ = [
    "make_mesh",
    "ShardedELL",
    "shard_ell_rows",
    "row_sharded_spmv",
    "shard_ell_2d",
    "sharded_spmv_2d",
    "col_sharded_spmv",
]


def make_mesh(n_devices: int | None = None, axis_names=("rows",), shape=None) -> Mesh:
    """Build a device mesh; defaults to all devices on one ``rows`` axis."""
    devs = jax.devices()
    n = n_devices or len(devs)
    devs = devs[:n]
    if shape is None:
        shape = (n,) if len(axis_names) == 1 else None
    arr = np.array(devs).reshape(shape)
    return Mesh(arr, axis_names)


class ShardedELL:
    """Row-sharded padded-ELL arrays + the padding bookkeeping."""

    def __init__(self, ja, as_, nrows, ncols, nnz, rows_padded):
        self.ja = ja
        self.as_ = as_
        self.nrows = int(nrows)
        self.ncols = int(ncols)
        self.nnz = int(nnz)
        self.rows_padded = int(rows_padded)


def _pad_rows(ja, as_, rows_padded):
    extra = rows_padded - ja.shape[0]
    if extra > 0:
        ja = np.concatenate([ja, np.zeros((extra, ja.shape[1]), ja.dtype)])
        as_ = np.concatenate([as_, np.zeros((extra, as_.shape[1]), as_.dtype)])
    return ja, as_


def shard_ell_rows(hll, mesh: Mesh, *, dtype=None, axis: str = "rows") -> ShardedELL:
    """Upload an HLL matrix as a row-sharded ELL rectangle.

    Rows are padded to a multiple of the mesh axis size and split into
    equal row counts (one static shape); for nnz-balanced shards use the
    SELL operator (parallel/spmd_sell.py, parallel/scheduler.py).
    """
    ja, as_ = hll.to_rect()
    if dtype is not None:
        as_ = as_.astype(dtype)
    n_shards = mesh.shape[axis]
    rows_padded = -(-ja.shape[0] // n_shards) * n_shards
    ja, as_ = _pad_rows(ja, as_, rows_padded)
    sharding = NamedSharding(mesh, P(axis, None))
    return ShardedELL(
        jax.device_put(jnp.asarray(ja), sharding),
        jax.device_put(jnp.asarray(as_), sharding),
        hll.nrows,
        hll.ncols,
        hll.nnz,
        rows_padded,
    )


def row_sharded_spmv(sharded: ShardedELL, x, mesh: Mesh, *, axis: str = "rows"):
    """y = A @ x with A row-sharded, x replicated. No hot-loop collective.

    Jitted with explicit shardings: XLA compiles one embarrassingly-parallel
    program per chip (the multi-chip generalization of the reference's
    per-thread row ranges).
    """
    x_sh = jax.device_put(x, NamedSharding(mesh, P()))

    @functools.partial(
        jax.jit,
        out_shardings=NamedSharding(mesh, P(axis)),
    )
    def run(ja, as_, x):
        return jnp.sum(as_ * jnp.take(x, ja), axis=1)

    y = run(sharded.ja, sharded.as_, x_sh)
    return y[: sharded.nrows]


class Sharded2D:
    """ELL sharded on rows with x/columns sharded on a second axis."""

    def __init__(self, ja, as_, col_starts, nrows, ncols, nnz, rows_padded, cols_padded):
        self.ja = ja
        self.as_ = as_
        self.col_starts = col_starts
        self.nrows = int(nrows)
        self.ncols = int(ncols)
        self.nnz = int(nnz)
        self.rows_padded = int(rows_padded)
        self.cols_padded = int(cols_padded)


def shard_ell_2d(hll, mesh: Mesh, *, dtype=None):
    """Prepare a (rows, cols)-sharded ELL: every entry is assigned to the
    column shard owning its column; per (row-shard, col-shard) sub-rectangles
    are padded to a common K so the array is uniform.

    The padded entries point at local column 0 with value 0 — same
    stays-in-bounds trick as the reference HLL padding (hll_matrix.c:241-246).
    """
    nr_sh = mesh.shape["rows"]
    nc_sh = mesh.shape["cols"]
    ja, as_ = hll.to_rect()
    if dtype is not None:
        as_ = as_.astype(dtype)
    M = ja.shape[0]
    rows_padded = -(-M // nr_sh) * nr_sh
    ja, as_ = _pad_rows(ja, as_, rows_padded)
    cols_padded = -(-hll.ncols // nc_sh) * nc_sh
    cols_per = cols_padded // nc_sh

    shard_of_entry = np.minimum(ja // cols_per, nc_sh - 1)
    # per (row, col-shard) counts -> common K2
    counts = np.zeros((rows_padded, nc_sh), dtype=np.int64)
    valid = as_ != 0
    np.add.at(counts, (np.repeat(np.arange(rows_padded), ja.shape[1]),
                       shard_of_entry.reshape(-1)), valid.reshape(-1))
    K2 = max(1, int(counts.max()))

    ja2 = np.zeros((rows_padded, nc_sh, K2), dtype=np.int32)
    as2 = np.zeros((rows_padded, nc_sh, K2), dtype=as_.dtype)
    # stable fill: iterate entries in row-major order, vectorized by cumcount
    r_idx = np.repeat(np.arange(rows_padded), ja.shape[1])[valid.reshape(-1)]
    s_idx = shard_of_entry.reshape(-1)[valid.reshape(-1)]
    flat_rs = r_idx * nc_sh + s_idx
    order = np.argsort(flat_rs, kind="stable")
    sorted_rs = flat_rs[order]
    first = np.ones(sorted_rs.size, dtype=bool)
    first[1:] = sorted_rs[1:] != sorted_rs[:-1]
    slot_sorted = np.arange(sorted_rs.size) - np.maximum.accumulate(
        np.where(first, np.arange(sorted_rs.size), 0)
    )
    slot = np.empty_like(slot_sorted)
    slot[order] = slot_sorted
    local_col = (ja.reshape(-1)[valid.reshape(-1)] - s_idx * cols_per).astype(np.int32)
    ja2[r_idx, s_idx, slot] = local_col
    as2[r_idx, s_idx, slot] = as_.reshape(-1)[valid.reshape(-1)]

    # (rows_padded, nc_sh, K2) -> shard rows on 'rows', axis 1 on 'cols'
    sharding = NamedSharding(mesh, P("rows", "cols", None))
    return Sharded2D(
        jax.device_put(jnp.asarray(ja2), sharding),
        jax.device_put(jnp.asarray(as2), sharding),
        None,
        hll.nrows,
        hll.ncols,
        hll.nnz,
        rows_padded,
        cols_padded,
    )


def sharded_spmv_2d(sharded: Sharded2D, x, mesh: Mesh):
    """y = A @ x on a (rows, cols) mesh: partial products per column shard,
    ``psum`` over the ``cols`` axis (the TP-style reduce)."""
    nc_sh = mesh.shape["cols"]
    cols_per = sharded.cols_padded // nc_sh
    xp = jnp.pad(jnp.asarray(x), (0, sharded.cols_padded - x.shape[0]))
    x2 = xp.reshape(nc_sh, cols_per)
    x2 = jax.device_put(x2, NamedSharding(mesh, P("cols", None)))

    @functools.partial(
        shard_map,
        mesh=mesh,
        in_specs=(P("rows", "cols", None), P("rows", "cols", None), P("cols", None)),
        out_specs=P("rows"),
    )
    def run(ja, as_, xloc):
        # ja/as_: (rows_local, 1, K2); xloc: (1, cols_per)
        partial = jnp.sum(as_[:, 0, :] * jnp.take(xloc[0], ja[:, 0, :]), axis=1)
        return jax.lax.psum(partial, "cols")

    y = run(sharded.ja, sharded.as_, x2)
    return y[: sharded.nrows]


def col_sharded_spmv(hll, x, mesh: Mesh, *, dtype=None):
    """Pure column sharding on a 1-axis mesh named 'cols': x sharded,
    partial y psum-reduced. Convenience wrapper over the 2-D path with a
    single row shard."""
    mesh2 = Mesh(mesh.devices.reshape(1, -1), ("rows", "cols"))
    sh = shard_ell_2d(hll, mesh2, dtype=dtype)
    return sharded_spmv_2d(sh, x, mesh2)
