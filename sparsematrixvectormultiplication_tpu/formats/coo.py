"""COO container — the "PreMatrix" of the framework.

Host-side (numpy) canonical triplet form every converter consumes, mirroring
the reference's ``PreMatrix`` struct (reference libs/matrix_parser.h:6-14) but
immutable and vectorized.
"""

from __future__ import annotations

from dataclasses import dataclass, replace

import numpy as np

__all__ = ["COOMatrix"]


@dataclass(frozen=True)
class COOMatrix:
    """Sparse matrix in coordinate (triplet) form, 0-based indices.

    ≙ reference ``PreMatrix{M,N,nz,I,J,val,type}`` (libs/matrix_parser.h:6-14).
    """

    nrows: int
    ncols: int
    row: np.ndarray  # int32/int64 (nnz,)
    col: np.ndarray  # int32/int64 (nnz,)
    val: np.ndarray  # float64 (nnz,)

    def __post_init__(self):
        row, col, val = map(np.asarray, (self.row, self.col, self.val))
        if not (row.shape == col.shape == val.shape and row.ndim == 1):
            raise ValueError("row/col/val must be 1-D arrays of equal length")
        if row.size:
            if int(row.min()) < 0 or int(row.max()) >= self.nrows:
                raise ValueError("row index out of range")
            if int(col.min()) < 0 or int(col.max()) >= self.ncols:
                raise ValueError("col index out of range")
        object.__setattr__(self, "row", row)
        object.__setattr__(self, "col", col)
        object.__setattr__(self, "val", val)

    @property
    def nnz(self) -> int:
        return int(self.row.size)

    @property
    def shape(self) -> tuple:
        return (self.nrows, self.ncols)

    @classmethod
    def from_mtx(cls, path, **kwargs) -> "COOMatrix":
        from ..io.mmio import read_matrix_market

        nrows, ncols, row, col, val, _tc = read_matrix_market(path, **kwargs)
        return cls(nrows, ncols, row, col, val)

    @classmethod
    def from_scipy(cls, m) -> "COOMatrix":
        """Adopt any ``scipy.sparse`` matrix/array (interop for users
        migrating from the reference's scipy-oracle workflow, SURVEY §2
        component 29)."""
        c = m.tocoo()
        return cls(int(c.shape[0]), int(c.shape[1]),
                   c.row.astype(np.int32), c.col.astype(np.int32),
                   np.asarray(c.data, np.float64))

    def to_scipy(self):
        """View as ``scipy.sparse.coo_matrix`` (zero-copy triplets)."""
        import scipy.sparse as sp

        return sp.coo_matrix((self.val, (self.row, self.col)),
                             shape=(self.nrows, self.ncols))

    def sum_duplicates(self) -> "COOMatrix":
        """Coalesce duplicate (row, col) entries by summation."""
        key = self.row.astype(np.int64) * self.ncols + self.col.astype(np.int64)
        order = np.argsort(key, kind="stable")
        key_s = key[order]
        first = np.ones(key_s.size, dtype=bool)
        first[1:] = key_s[1:] != key_s[:-1]
        seg = np.cumsum(first) - 1
        val_out = np.zeros(int(seg[-1]) + 1 if seg.size else 0, dtype=self.val.dtype)
        np.add.at(val_out, seg, self.val[order])
        row_out = self.row[order][first]
        col_out = self.col[order][first]
        return replace(self, row=row_out, col=col_out, val=val_out)

    def to_dense(self) -> np.ndarray:
        dense = np.zeros((self.nrows, self.ncols), dtype=self.val.dtype)
        np.add.at(dense, (self.row, self.col), self.val)
        return dense

    def row_counts(self) -> np.ndarray:
        """nnz per row (the load measure used by all schedulers)."""
        return np.bincount(self.row, minlength=self.nrows).astype(np.int64)

    def summary(self, full: bool = False) -> str:
        """Human summary (≙ print_pre_matrix, src/matrix_parser.c:152-177)."""
        lines = [
            f"matrix: {self.nrows} x {self.ncols}",
            f"nonzeros: {self.nnz}",
        ]
        if full and self.nrows <= 30:
            lines.append(f"rows (I): {self.row.tolist()}")
            lines.append(f"cols (J): {self.col.tolist()}")
            lines.append(f"values:   {self.val.tolist()}")
        return "\n".join(lines)

    def __repr__(self) -> str:
        return f"COOMatrix({self.nrows}x{self.ncols}, nnz={self.nnz})"
