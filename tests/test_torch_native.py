"""The port's native host library against speck_tpu's, on the CPU.

The reference's ``use_native`` cases of ``tests/test_formats.py`` (general,
symmetric, pattern and complex .mtx) go through both packages' ``load_mtx``
with ``use_native`` True and False, and every array must be equal; the
port's counting-sort COO->CSR must equal the numpy lexsort element for
element, as in the reference's own test. ``g++`` builds the library at its
first use into ``build/speck_tpu_torch/``."""

import numpy as np
import pytest

from speck_tpu.formats.csr import coo_to_csr as j_coo_to_csr
from speck_tpu.formats.mtx import load_mtx as j_load_mtx
from speck_tpu_torch import native
from speck_tpu_torch.formats.csr import HostCOO, coo_to_csr
from speck_tpu_torch.formats.mtx import load_mtx, store_mtx

from test_formats import (COMPLEX_MTX, GENERAL_MTX, PATTERN_MTX,
                          SYMMETRIC_MTX)

MTX = {"general": GENERAL_MTX, "symmetric": SYMMETRIC_MTX,
       "pattern": PATTERN_MTX, "complex": COMPLEX_MTX}


def test_native_library_builds():
    """g++ is present here, so the library builds, lands in build/ and
    loads; nothing of it is in the package directory."""
    assert native.available()
    path = native.library_path(native._compiler())
    assert path.exists() and path.parent.name == "speck_tpu_torch"
    assert path.parent.parent.name == "build"


@pytest.mark.parametrize("use_native", [False, True])
@pytest.mark.parametrize("name", list(MTX))
def test_load_mtx_matches_reference(tmp_path, name, use_native):
    path = tmp_path / f"{name}.mtx"
    path.write_text(MTX[name])
    want = j_load_mtx(str(path), use_native=use_native)
    for native_flag in (True, False):
        got = load_mtx(str(path), use_native=native_flag)
        assert (got.rows, got.cols) == (want.rows, want.cols)
        np.testing.assert_array_equal(got.row_ids, want.row_ids)
        np.testing.assert_array_equal(got.col_ids, want.col_ids)
        np.testing.assert_array_equal(got.data, want.data)
        assert got.data.dtype == want.data.dtype
    # and the CSR of both converts
    jc, tc = j_coo_to_csr(want), coo_to_csr(got)
    np.testing.assert_array_equal(tc.row_offsets, jc.row_offsets)
    np.testing.assert_array_equal(tc.col_ids, jc.col_ids)
    np.testing.assert_array_equal(tc.data, jc.data)


def test_native_coo_to_csr_matches_lexsort(rng):
    """The counting sort equals the numpy lexsort element for element:
    stable within (row, col), so duplicates keep their order."""
    m, n, nnz = 50, 40, 600
    rows = rng.integers(0, m, nnz).astype(np.uint32)
    cols = rng.integers(0, n, nnz).astype(np.uint32)  # duplicates likely
    for dtype in (np.float64, np.float32):
        vals = rng.standard_normal(nnz).astype(dtype)
        offsets, c_out, v_out = native.coo_to_csr_native(rows, cols, vals, m)
        order = np.lexsort((cols, rows))
        counts = np.bincount(rows, minlength=m)
        exp_off = np.concatenate([[0], np.cumsum(counts)]).astype(np.uint32)
        np.testing.assert_array_equal(offsets, exp_off)
        np.testing.assert_array_equal(c_out, cols[order])
        np.testing.assert_array_equal(v_out, vals[order])
        assert v_out.dtype == dtype


def test_native_coo_to_csr_rejects_bad_row():
    rows = np.array([0, 5], np.uint32)   # row 5 out of bounds for m=3
    cols = np.array([0, 1], np.uint32)
    with pytest.raises(ValueError):
        native.coo_to_csr_native(rows, cols, np.ones(2), 3)


@pytest.mark.parametrize("field", ["real", "pattern"])
def test_store_mtx_native_round_trip(tmp_path, rng, field):
    """store_mtx's native writer and the numpy writer give files that load
    to the same COO (float64 exactly, %.17g)."""
    m, n, nnz = 30, 20, 200
    coo = HostCOO(rows=m, cols=n,
                  row_ids=rng.integers(0, m, nnz).astype(np.uint32),
                  col_ids=rng.integers(0, n, nnz).astype(np.uint32),
                  data=(np.ones(nnz) if field == "pattern"
                        else rng.standard_normal(nnz)))
    p_nat = tmp_path / "native.mtx"
    store_mtx(str(p_nat), coo, field)
    p_np = tmp_path / "numpy.mtx"
    lib = native._lib
    native._lib, native._failed = None, True     # the numpy writer
    try:
        store_mtx(str(p_np), coo, field)
    finally:
        native._lib, native._failed = lib, False
    for p in (p_nat, p_np):
        got = load_mtx(str(p), use_native=False)
        np.testing.assert_array_equal(got.row_ids, coo.row_ids)
        np.testing.assert_array_equal(got.col_ids, coo.col_ids)
        np.testing.assert_array_equal(got.data, coo.data)
