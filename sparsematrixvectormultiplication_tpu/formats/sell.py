"""SELL-C-σ — the device layout for SpMV (Kreutzer et al., arXiv:1307.6209).

Rows are sorted by length inside windows of ``sigma`` rows, cut into
slices of ``c`` rows (a power of two), and every slice is padded to its
longest row. A slice is stored slot-major: slot ``k`` of its ``c`` rows
occupies ``c`` consecutive entries, so device code that sums each row
in its own thread (as XLA's fused reduction does) reads every slot with
one coalesced load. Slices that share a padded width ``k`` form a bin,
stored as ``(n_slices, k, c)`` planes with a static ``k``.

Column indices are plain global indices into ``x``. Padding entries repeat
the row's last column (column 0 for an empty row) with value 0, as the
reference HLL format does (hll_matrix.c:241-246), so padded gathers stay in
bounds and add nothing.

Rows longer than a cap are first split into segments
(:meth:`CSRMatrix.split_heavy_rows`), so no single row's sum serialises
a power-law head and no slice is padded out to it. Every row, and
segment 0 of a split row, writes its own destination slot
``0..nrows-1``; the extra segments write slots ``nrows..`` and are summed
back into ``seg_owner`` rows with one segment sum. Padding rows
of a slice hold slots from ``n_dest`` upward, each its own, so no two
entries of a matrix share a slot and a device scatter needs no atomics.

``c`` and ``sigma`` are chosen from the row-length statistics alone
(:func:`choose_slicing`); no option selects them.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .coo import COOMatrix
from .csr import CSRMatrix

__all__ = ["SellBin", "SellGeometry", "SellMatrix", "choose_slicing",
           "distinct_padding", "heavy_row_cap", "SLICE_HEIGHTS"]

# Slice heights tried, largest first. A slot of a slice is c consecutive
# entries, read together by the reduction over the slice's slots; at a
# multiple of 32 rows each such read covers whole 128-byte lines (4-byte
# columns), and taller slices mean fewer, longer reads.
SLICE_HEIGHTS = (128, 64, 32)
# A larger slice or a smaller sort window is taken while it pads at most
# this much more than the best candidate.
_PADDING_SLACK = 1.05
# Each bin is one gather-reduce-scatter fusion per product (a launch on
# the device) and one more static shape to compile; beyond this many
# distinct widths the cheapest neighbours are merged.
_MAX_BINS = 8


def heavy_row_cap(row_nnz: np.ndarray) -> int:
    """Longest row kept whole: 16 entries when rows are short (median at
    most 24, the reference's thread-per-row regime), else 256, and never
    under four times the median row, so only real outliers are split."""
    med = float(np.median(row_nnz)) if row_nnz.size else 0.0
    return max(16 if med <= 24 else 256, 4 * int(np.ceil(med)))


def _window_sort(lengths: np.ndarray, sigma: int) -> np.ndarray:
    """Row order with rows sorted by descending length inside each window
    of ``sigma`` rows (stable, so equal rows keep their order)."""
    idx = np.arange(lengths.size, dtype=np.int64)
    if sigma <= 1:
        return idx
    return np.lexsort((-lengths, idx // sigma))


def _slice_widths(sorted_lengths: np.ndarray, c: int) -> np.ndarray:
    """Padded width of each slice of ``c`` rows (at least 1)."""
    pad = (-sorted_lengths.size) % c
    a = np.concatenate([sorted_lengths, np.zeros(pad, sorted_lengths.dtype)])
    return np.maximum(a.reshape(-1, c).max(axis=1), 1)


def choose_slicing(lengths: np.ndarray) -> tuple:
    """Returns ``(c, sigma)`` for rows of the given lengths.

    The sort window grows in steps of 8x from no sorting to the whole
    matrix. ``c`` is the tallest slice whose best padding is within
    ``_PADDING_SLACK`` of the 32-row slice's; ``sigma`` is then the
    smallest window within the same slack of that slice height's best.
    Small windows keep neighbouring rows together, which keeps their x
    gathers close and their y writes coalesced.
    """
    n = int(lengths.size)
    sigmas = [1]
    while sigmas[-1] * 8 < n:
        sigmas.append(max(1024, sigmas[-1] * 8))
    if n > 1:
        sigmas.append(n)
    padded = {}
    for s in sigmas:
        srt = lengths[_window_sort(lengths, s)]
        for c in SLICE_HEIGHTS:
            padded[s, c] = int(_slice_widths(srt, c).sum()) * c
    best = {c: min(padded[s, c] for s in sigmas) for c in SLICE_HEIGHTS}
    c = next(c for c in SLICE_HEIGHTS
             if best[c] <= _PADDING_SLACK * best[SLICE_HEIGHTS[-1]])
    sigma = next(s for s in sigmas if padded[s, c] <= _PADDING_SLACK * best[c])
    return c, sigma


def _bin_edges(widths: np.ndarray) -> np.ndarray:
    """Bin widths: the distinct slice widths, unless there are more than
    ``_MAX_BINS`` — then the neighbouring pair whose merge adds the fewest
    padded slots is merged, repeatedly. A slice goes to the narrowest bin
    at least as wide as it."""
    ks, counts = np.unique(widths, return_counts=True)
    ks, counts = list(ks), list(counts)
    while len(ks) > _MAX_BINS:
        cost = [(ks[i + 1] - ks[i]) * counts[i] for i in range(len(ks) - 1)]
        i = int(np.argmin(cost))
        counts[i + 1] += counts[i]
        del ks[i], counts[i]
    return np.asarray(ks, np.int64)


def distinct_padding(planes, first: int) -> list:
    """``planes`` of destination slots with every negative entry (a padding
    row) replaced by its own slot, counting up from ``first``."""
    out = []
    for r in planes:
        r = np.array(r, np.int64)
        pad = r < 0
        r[pad] = first + np.arange(int(pad.sum()))
        first += int(pad.sum())
        out.append(r.astype(np.int32))
    return out


@dataclass(frozen=True)
class SellGeometry:
    """What the conversion decides from row lengths: the heavy-row cap, the
    slice height ``c``, the sort window ``sigma`` and the bin widths."""

    cap: int
    c: int
    sigma: int
    edges: np.ndarray

    @classmethod
    def of(cls, csr: CSRMatrix) -> "SellGeometry":
        cap = heavy_row_cap(csr.row_nnz())
        ext, _ = csr.split_heavy_rows(cap)
        lengths = ext.row_nnz().astype(np.int64)
        if lengths.size == 0:
            return cls(cap, SLICE_HEIGHTS[-1], 1, np.ones(1, np.int64))
        c, sigma = choose_slicing(lengths)
        widths = _slice_widths(lengths[_window_sort(lengths, sigma)], c)
        return cls(cap, c, sigma, _bin_edges(widths))


@dataclass(frozen=True)
class SellBin:
    """Slices padded to one width ``k``."""

    k: int
    cols: np.ndarray   # (n_slices, k, c) int32 global column indices
    vals: np.ndarray   # (n_slices, k, c) values, 0 in padding
    rows: np.ndarray   # (n_slices, c) int32 destination slot; padding rows
                       # hold distinct slots >= n_dest, out of range

    @property
    def n_slices(self) -> int:
        return int(self.rows.shape[0])

    @property
    def padded_nnz(self) -> int:
        return int(self.cols.size)


@dataclass(frozen=True)
class SellMatrix:
    """SELL-C-σ matrix: bins of slot-major slices plus the heavy-row map."""

    nrows: int
    ncols: int
    nnz: int
    c: int                  # rows per slice
    sigma: int              # rows per sort window (1: unsorted)
    bins: tuple
    seg_owner: np.ndarray   # (n_dest - nrows,) int32 row of each extra
                            # heavy-row segment slot

    @property
    def shape(self) -> tuple:
        return (self.nrows, self.ncols)

    @property
    def n_dest(self) -> int:
        return self.nrows + int(self.seg_owner.size)

    @property
    def padded_nnz(self) -> int:
        return sum(b.padded_nnz for b in self.bins)

    @property
    def padding_ratio(self) -> float:
        return self.padded_nnz / max(self.nnz, 1)

    def memory_stats(self) -> dict:
        byt = sum(b.cols.nbytes + b.vals.nbytes + b.rows.nbytes
                  for b in self.bins) + self.seg_owner.nbytes
        return {
            "rows": self.nrows,
            "cols": self.ncols,
            "nnz": self.nnz,
            "padded_nnz": self.padded_nnz,
            "padding_ratio": self.padding_ratio,
            "bytes_total": byt,
            "slice_rows": self.c,
            "sigma": self.sigma,
            "heavy_row_segments": int(self.seg_owner.size),
            "bins": [{"k": b.k, "n_slices": b.n_slices,
                      "padding_ratio": b.padded_nnz
                      / max(int(np.count_nonzero(b.vals)), 1)}
                     for b in self.bins],
        }

    @classmethod
    def from_csr(cls, csr: CSRMatrix,
                 geometry: SellGeometry | None = None) -> "SellMatrix":
        """Convert ``csr``. ``geometry`` defaults to the one its own row
        lengths give; row shards of one matrix pass the whole matrix's, so
        that every shard has the same slice height and bin widths."""
        g = geometry or SellGeometry.of(csr)
        M = csr.nrows
        ext, seg_map = csr.split_heavy_rows(g.cap)
        if seg_map is None:
            dest = np.arange(M, dtype=np.int64)
            seg_owner = np.zeros(0, np.int32)
        else:
            first = np.ones(ext.nrows, bool)
            first[1:] = seg_map[1:] != seg_map[:-1]
            dest = np.empty(ext.nrows, np.int64)
            dest[first] = seg_map[first]
            dest[~first] = M + np.arange(int((~first).sum()))
            seg_owner = np.asarray(seg_map[~first], np.int32)
        n_dest = M + int(seg_owner.size)

        lengths = ext.row_nnz().astype(np.int64)
        order = _window_sort(lengths, g.sigma)
        widths = _slice_widths(lengths[order], g.c) if lengths.size \
            else np.zeros(0, np.int64)
        pad = widths.size * g.c - order.size
        slices = np.concatenate(
            [order, np.full(pad, -1, np.int64)]).reshape(-1, g.c)
        bin_k = g.edges[np.searchsorted(g.edges, widths)]

        starts = ext.row_ptr[:-1].astype(np.int64)
        last_col = np.zeros(ext.nrows, np.int32)
        nz = lengths > 0
        last_col[nz] = ext.col_idx[ext.row_ptr[1:][nz] - 1]
        bins = []
        ks = np.unique(bin_k)
        for k in ks:
            rr = slices[bin_k == k]                       # (n, c) ext rows
            real = rr >= 0
            r = np.where(real, rr, 0)
            ln = np.where(real, lengths[r], 0)            # (n, c)
            j = np.arange(k, dtype=np.int64)[None, :, None]
            valid = j < ln[:, None, :]                    # (n, k, c)
            src = np.where(valid, starts[r][:, None, :] + j, 0)
            cols = np.where(valid, ext.col_idx[src] if ext.nnz else 0,
                            last_col[r][:, None, :]).astype(np.int32)
            vals = np.where(valid, ext.values[src] if ext.nnz else 0.0,
                            0.0).astype(csr.values.dtype)
            bins.append((cols, vals, np.where(real, dest[r], -1)))
        rows = distinct_padding([b[2] for b in bins], n_dest)
        bins = [SellBin(int(k), c, v, r)
                for k, (c, v, _), r in zip(ks, bins, rows)]
        return cls(M, csr.ncols, csr.nnz, int(g.c), int(g.sigma),
                   tuple(bins), seg_owner)

    @classmethod
    def from_coo(cls, coo: COOMatrix) -> "SellMatrix":
        return cls.from_csr(CSRMatrix.from_coo(coo))

    def spmv(self, x: np.ndarray) -> np.ndarray:
        """fp64 host SpMV over this layout (checks the conversion)."""
        x = np.asarray(x, np.float64)
        if self.ncols == 0:
            return np.zeros(self.nrows)
        y = np.zeros(self.n_dest)
        for b in self.bins:
            part = (b.vals.astype(np.float64) * x[b.cols]).sum(axis=1)
            r = b.rows.reshape(-1)
            live = r < self.n_dest
            y[r[live]] = part.reshape(-1)[live]
        out = y[: self.nrows].copy()
        np.add.at(out, self.seg_owner, y[self.nrows: self.n_dest])
        return out
