"""MatrixMarket IO tests — parser vs scipy.io.mmread (the independent oracle,
SURVEY §4.2), writer round-trips, typecode queries, error paths."""

import io
import os

import numpy as np
import pytest
import scipy.io as sio
import scipy.sparse as sp

from sparsematrixvectormultiplication_tpu import (
    COOMatrix,
    MMIOError,
    MMTypeCode,
    read_banner,
    read_matrix_market,
    write_matrix_market,
)

# a general real matrix in the reference generator's layout
# (src/matrix_generator.py: 1-based, row-sorted coordinates)
REFERENCE_FIXTURE = os.path.join(os.path.dirname(__file__), "data",
                                 "general_matrix.mtx")


def test_reference_fixture_matches_scipy():
    nr, nc, r, c, v, tc = read_matrix_market(REFERENCE_FIXTURE)
    ref = sio.mmread(REFERENCE_FIXTURE).tocoo()
    assert (nr, nc) == ref.shape
    assert v.size == ref.nnz
    assert np.allclose(COOMatrix(nr, nc, r, c, v).to_dense(), ref.toarray())


def test_banner_queries():
    tc = read_banner(REFERENCE_FIXTURE)
    assert tc.is_matrix and tc.is_sparse and tc.is_real and tc.is_general
    assert not tc.is_pattern and not tc.is_symmetric


@pytest.mark.parametrize("seed", range(5))
def test_random_general_matches_scipy(tmp_path, seed):
    s = sp.random(
        73 + seed * 31, 61 + seed * 17, density=0.07,
        random_state=np.random.RandomState(seed), format="coo",
    )
    p = tmp_path / "m.mtx"
    sio.mmwrite(p, s)
    nr, nc, r, c, v, tc = read_matrix_market(p)
    assert np.allclose(COOMatrix(nr, nc, r, c, v).to_dense(), s.toarray())


def test_symmetric_expansion(tmp_path):
    s = sp.random(50, 50, density=0.08, random_state=np.random.RandomState(5), format="coo")
    s = s + s.T  # symmetric
    p = tmp_path / "sym.mtx"
    sio.mmwrite(p, s, symmetry="symmetric")
    nr, nc, r, c, v, tc = read_matrix_market(p)
    assert tc.is_symmetric
    assert np.allclose(COOMatrix(nr, nc, r, c, v).to_dense(), s.toarray())
    # without expansion only the stored triangle comes back
    nr, nc, r2, c2, v2, _ = read_matrix_market(p, expand_symmetry=False)
    assert v2.size < v.size


def test_skew_symmetric_expansion(tmp_path):
    a = sp.random(30, 30, density=0.1, random_state=np.random.RandomState(7), format="coo")
    lower = sp.tril(a, k=-1).tocoo()
    skew = lower - lower.T
    p = tmp_path / "skew.mtx"
    sio.mmwrite(p, sp.coo_matrix(lower), symmetry="skew-symmetric")
    nr, nc, r, c, v, tc = read_matrix_market(p)
    assert tc.is_skew
    assert np.allclose(COOMatrix(nr, nc, r, c, v).to_dense(), skew.toarray())


def test_pattern_values_forced_to_one(tmp_path):
    s = sp.random(40, 60, density=0.05, random_state=np.random.RandomState(3), format="coo")
    p = tmp_path / "pat.mtx"
    sio.mmwrite(p, s, field="pattern")
    nr, nc, r, c, v, tc = read_matrix_market(p)
    assert tc.is_pattern
    assert np.all(v == 1.0)
    assert v.size == s.nnz


def test_integer_field(tmp_path):
    p = tmp_path / "int.mtx"
    p.write_text(
        "%%MatrixMarket matrix coordinate integer general\n"
        "2 2 2\n1 1 3\n2 2 -7\n"
    )
    nr, nc, r, c, v, tc = read_matrix_market(p)
    assert tc.is_integer
    assert np.allclose(COOMatrix(nr, nc, r, c, v).to_dense(), [[3, 0], [0, -7]])


def test_array_format(tmp_path):
    dense = np.arange(6, dtype=float).reshape(3, 2) + 1
    p = tmp_path / "arr.mtx"
    sio.mmwrite(p, dense)
    nr, nc, r, c, v, tc = read_matrix_market(p)
    assert tc.is_array
    assert np.allclose(COOMatrix(nr, nc, r, c, v).to_dense(), dense)


def test_out_of_range_index_raises(tmp_path):
    p = tmp_path / "bad.mtx"
    p.write_text(
        "%%MatrixMarket matrix coordinate real general\n"
        "2 2 1\n3 1 5.0\n"
    )
    with pytest.raises(MMIOError):
        read_matrix_market(p)


def test_bad_banner_raises(tmp_path):
    p = tmp_path / "nobanner.mtx"
    p.write_text("hello world\n2 2 1\n1 1 5.0\n")
    with pytest.raises(MMIOError):
        read_matrix_market(p)


def test_truncated_body_raises(tmp_path):
    p = tmp_path / "trunc.mtx"
    p.write_text(
        "%%MatrixMarket matrix coordinate real general\n"
        "2 2 3\n1 1 5.0\n"
    )
    with pytest.raises(MMIOError):
        read_matrix_market(p)


def test_writer_roundtrip(tmp_path):
    s = sp.random(25, 35, density=0.1, random_state=np.random.RandomState(11), format="coo")
    p = tmp_path / "w.mtx"
    write_matrix_market(p, 25, 35, s.row, s.col, s.data)
    back = sio.mmread(p).tocoo()  # scipy reads what we write
    assert np.allclose(back.toarray(), s.toarray())


def test_writer_pattern_roundtrip(tmp_path):
    s = sp.random(20, 20, density=0.1, random_state=np.random.RandomState(12), format="coo")
    p = tmp_path / "wp.mtx"
    write_matrix_market(p, 20, 20, s.row, s.col, field="pattern")
    nr, nc, r, c, v, tc = read_matrix_market(p)
    assert tc.is_pattern and v.size == s.nnz


def test_comments_and_blank_lines(tmp_path):
    p = tmp_path / "c.mtx"
    p.write_text(
        "%%MatrixMarket matrix coordinate real general\n"
        "% a comment\n"
        "%another\n"
        "\n"
        "2 3 2\n"
        "1 2 1.5\n"
        "2 3 -2.5\n"
    )
    nr, nc, r, c, v, tc = read_matrix_market(p)
    assert (nr, nc) == (2, 3)
    assert np.allclose(v, [1.5, -2.5])


def test_typecode_validation():
    with pytest.raises(MMIOError):
        MMTypeCode(object="tensor")
    with pytest.raises(MMIOError):
        MMTypeCode(field="boolean")


def test_malformed_big_body_raises_mmio_error(tmp_path):
    """Large bodies route through the native parser; malformed content must
    still surface as MMIOError (not a numpy ValueError)."""
    n = 20000
    p = tmp_path / "bad_big.mtx"
    with open(p, "w") as f:
        f.write("%%MatrixMarket matrix coordinate real general\n")
        f.write(f"{n} {n} {n}\n")
        for i in range(1, 10000):
            f.write(f"{i} {i} 1.0\n")
        f.write("garbage line here\n")
    with pytest.raises(MMIOError):
        read_matrix_market(p)


def test_native_parser_number_formats(tmp_path):
    """Exponent, Fortran-D, and long-mantissa values through the native
    C++ parser (nnz above its activation threshold)."""
    n = 20000
    p = tmp_path / "expo.mtx"
    with open(p, "w") as f:
        f.write("%%MatrixMarket matrix coordinate real general\n")
        f.write(f"{n} {n} {n}\n")
        for i in range(1, n + 1):
            v = ["1.5e-3", "2.25E+2", "-7.5d-1", "0.123456789012345678901"][i % 4]
            f.write(f"{i} {i} {v}\n")
    nr, nc, r, c, v, tc = read_matrix_market(p)
    assert np.allclose(v[0::4], 2.25e2, rtol=1e-14)
    assert np.allclose(v[1::4], -0.75, rtol=1e-14)
    assert np.allclose(v[2::4], 0.123456789012345678901, rtol=1e-14)
    assert np.allclose(v[3::4], 1.5e-3, rtol=1e-14)


def test_write_read_roundtrip_large(tmp_path):
    """Writer -> native/numpy parser round-trip at a nontrivial size."""
    import numpy as np

    from sparsematrixvectormultiplication_tpu import COOMatrix
    from sparsematrixvectormultiplication_tpu.io.mmio import write_matrix_market

    rng = np.random.default_rng(42)
    n = 200_000
    M = N = 50_000
    row = rng.integers(0, M, n).astype(np.int32)
    col = rng.integers(0, N, n).astype(np.int32)
    key = row.astype(np.int64) * N + col
    _, idx = np.unique(key, return_index=True)
    row, col = row[idx], col[idx]
    val = rng.standard_normal(row.size)
    p = tmp_path / "big.mtx"
    write_matrix_market(str(p), M, N, row, col, val)
    coo = COOMatrix.from_mtx(str(p))
    assert coo.nnz == row.size
    order = np.lexsort((col, row))
    got = np.lexsort((coo.col, coo.row))
    assert np.array_equal(coo.row[got], row[order])
    assert np.array_equal(coo.col[got], col[order])
    assert np.allclose(coo.val[got], val[order], rtol=1e-15)
