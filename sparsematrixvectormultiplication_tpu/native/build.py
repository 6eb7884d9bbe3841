"""Build + load the native C++ runtime components (ctypes, no pybind11).

Usage:
    python -m sparsematrixvectormultiplication_tpu.native.build   # force build
    from ..native.build import load_fast_mmio                     # lazy load

The library is compiled on first use into this directory; all consumers
degrade gracefully to the pure-numpy paths when a toolchain is unavailable.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys
import threading

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "fast_mmio.cpp")
_LIB = os.path.join(_DIR, "libfastmmio.so")
_CSR_SRC = os.path.join(_DIR, "fast_csr.cpp")
_CSR_LIB = os.path.join(_DIR, "libfastcsr.so")

_lock = threading.Lock()
_lib = None
_tried = False
_csr_lib = None
_csr_tried = False


def _compile(src: str, lib: str, what: str, force: bool = False) -> str | None:
    """Compile one shared library; returns its path or None on failure."""
    if not force and os.path.exists(lib) and os.path.getmtime(lib) >= os.path.getmtime(src):
        return lib
    cmd = [
        "g++", "-O3", "-march=native", "-std=c++17", "-shared", "-fPIC",
        "-pthread", src, "-o", lib,
    ]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=300)
        return lib
    except Exception as e:  # toolchain missing / compile error -> numpy fallback
        sys.stderr.write(f"{what} native build failed ({e}); using numpy path\n")
        return None


def build(force: bool = False) -> str | None:
    return _compile(_SRC, _LIB, "fast_mmio", force)


def build_csr(force: bool = False) -> str | None:
    return _compile(_CSR_SRC, _CSR_LIB, "fast_csr", force)


def load_fast_mmio():
    """Return the ctypes-wrapped parser entry point, or None."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        path = build()
        if path is None:
            return None
        try:
            lib = ctypes.CDLL(path)
            fn = lib.fast_mmio_parse_body
            fn.restype = ctypes.c_int64
            fn.argtypes = [
                ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
                ctypes.c_int, ctypes.c_int,
                ctypes.POINTER(ctypes.c_int32),
                ctypes.POINTER(ctypes.c_int32),
                ctypes.POINTER(ctypes.c_double),
            ]
            _lib = fn
        except OSError as e:
            sys.stderr.write(f"fast_mmio load failed ({e}); using numpy parser\n")
            _lib = None
        return _lib


def parse_body_native(body: bytes, nnz: int, per_line: int, num_threads: int = 0,
                      offset: int = 0):
    """Parse a coordinate body natively; returns (row, col, val) 1-based
    int32/float64 arrays, or None if the native path is unavailable/fails.

    ``offset`` lets the caller pass the whole file buffer without slicing
    (zero-copy: body[offset:] is parsed)."""
    import numpy as np

    fn = load_fast_mmio()
    if fn is None:
        return None
    if num_threads <= 0:
        num_threads = min(os.cpu_count() or 1, 16)
    rows = np.empty(nnz, dtype=np.int32)
    cols = np.empty(nnz, dtype=np.int32)
    vals = np.empty(nnz, dtype=np.float64)
    base = ctypes.cast(ctypes.c_char_p(body), ctypes.c_void_p).value
    got = fn(
        base + offset, len(body) - offset, nnz, per_line, num_threads,
        rows.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        cols.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        vals.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
    )
    if got != nnz:
        return None
    return rows, cols, vals


def load_fast_csr():
    """Return the ctypes-wrapped COO→CSR converter, or None."""
    global _csr_lib, _csr_tried
    with _lock:
        if _csr_lib is not None or _csr_tried:
            return _csr_lib
        _csr_tried = True
        path = build_csr()
        if path is None:
            return None
        try:
            lib = ctypes.CDLL(path)
            fn = lib.fast_coo_to_csr
            fn.restype = ctypes.c_int64
            fn.argtypes = [
                ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
                ctypes.POINTER(ctypes.c_double),
                ctypes.c_int64, ctypes.c_int64, ctypes.c_int,
                ctypes.POINTER(ctypes.c_int64),
                ctypes.POINTER(ctypes.c_int32),
                ctypes.POINTER(ctypes.c_double),
            ]
            _csr_lib = fn
        except OSError as e:
            sys.stderr.write(f"fast_csr load failed ({e}); using numpy path\n")
            _csr_lib = None
        return _csr_lib


def coo_to_csr_native(row, col, val, nrows: int, num_threads: int = 0):
    """Native COO→CSR (≙ reference convert_in_csr, src/csr_matrix.c:63-126,
    counting sort + per-row column sort). Returns (row_ptr, col_idx, values)
    or None when the native path is unavailable or dtypes don't match."""
    import numpy as np

    fn = load_fast_csr()
    if fn is None:
        return None
    row = np.ascontiguousarray(row, dtype=np.int32)
    col = np.ascontiguousarray(col, dtype=np.int32)
    val = np.ascontiguousarray(val, dtype=np.float64)
    nnz = int(row.size)
    if num_threads <= 0:
        num_threads = min(os.cpu_count() or 1, 16)
    row_ptr = np.empty(nrows + 1, dtype=np.int64)
    col_out = np.empty(nnz, dtype=np.int32)
    val_out = np.empty(nnz, dtype=np.float64)
    rc = fn(
        row.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        col.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        val.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        nnz, int(nrows), num_threads,
        row_ptr.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        col_out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        val_out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
    )
    if rc != 0:
        return None
    return row_ptr, col_out, val_out


if __name__ == "__main__":
    out = build(force=True)
    out_csr = build_csr(force=True)
    print(f"built: {out}" if out else "fast_mmio build FAILED")
    print(f"built: {out_csr}" if out_csr else "fast_csr build FAILED")
