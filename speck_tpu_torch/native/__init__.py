"""The native host library (the port of ``speck_tpu/native``): the .mtx
body tokenizer and writer and the counting-sort COO->CSR convert, in
plain C++ (``speck_native.cpp``, a copy of the reference's source), bound
with ctypes.

The library is built with ``g++ -O3 -std=c++17 -shared -fPIC`` at first
use, never at import, into ``build/speck_tpu_torch/`` beside the package,
named by a hash of the source, the flags and the compiler, so an edited
source or another compiler rebuilds and nothing built is committed. No
``-march=native``: a library built on one host may be loaded on another.
Where it cannot be built (no ``g++``) or loaded, every caller takes the
numpy path, which gives the same result; ``available()`` says which path
runs.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

SOURCE = Path(__file__).resolve().parent / "speck_native.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "speck_tpu_torch"
FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_failed = False

_U32P = ctypes.POINTER(ctypes.c_uint)
_F64P = ctypes.POINTER(ctypes.c_double)
_I64 = ctypes.c_longlong
_SIGNATURES = {
    # (body text, body length, expected entries, values per entry (2/3/4),
    #  out rows, out cols, out vals) -> entries parsed
    "speck_mtx_parse": [ctypes.c_char_p, _I64, _I64, ctypes.c_int, _U32P,
                        _U32P, _F64P],
    # (rows, cols (0-based), vals, count, ncol (2/3), out buffer, capacity)
    # -> bytes written, or < 0 when the buffer is too small
    "speck_mtx_format": [_U32P, _U32P, _F64P, _I64, ctypes.c_int,
                         ctypes.c_char_p, _I64],
    # (row ids, col ids, vals (opaque bytes), nnz, rows, value itemsize,
    #  out row offsets, out col ids, out vals) -> 0, or != 0 for a bad row
    "speck_coo_to_csr": [_U32P, _U32P, ctypes.c_char_p, _I64, _I64,
                         ctypes.c_int, _U32P, _U32P, ctypes.c_char_p],
}


def _compiler() -> Optional[str]:
    return shutil.which("g++")


def library_path(cxx: str) -> Path:
    """The library's path for this source, these flags and compiler."""
    ver = subprocess.run([cxx, "-dumpfullversion", "-dumpmachine"],
                         capture_output=True, text=True, timeout=60).stdout
    h = hashlib.sha256(" ".join(FLAGS + [ver, platform.machine()]).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libspeck_native_{h.hexdigest()[:16]}.so"


def _build(cxx: str) -> Path:
    """Compile the library unless one of this source and compiler exists;
    a failed compile raises."""
    out = library_path(cxx)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run([cxx, *FLAGS, str(SOURCE), "-o", str(tmp)],
                          capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed ({proc.returncode}): {proc.stderr}")
    os.replace(tmp, out)
    return out


def get_lib() -> Optional[ctypes.CDLL]:
    """The loaded library (built on first use), or None where it cannot be
    built or loaded."""
    global _lib, _failed
    with _lock:
        if _lib is not None or _failed:
            return _lib
        cxx = _compiler()
        try:
            if cxx is None:
                raise RuntimeError("g++ not found")
            lib = ctypes.CDLL(str(_build(cxx)))
        except (OSError, RuntimeError, subprocess.SubprocessError):
            _failed = True
            return None
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = _I64
        _lib = lib
        return _lib


def available() -> bool:
    """True when the native library is built and loaded (the .mtx parse
    and write and the COO->CSR convert then run natively), False when
    every caller takes the numpy path."""
    return get_lib() is not None


def coo_to_csr_native(row_ids, col_ids, data, m: int):
    """Counting-sort COO->CSR: (row_offsets, cols, vals), equal element for
    element to a stable lexsort by (row, col), or None (the caller takes
    the numpy lexsort). A row id past ``m`` raises."""
    lib = get_lib()
    if lib is None:
        return None
    n = int(row_ids.shape[0])
    if n >= 2**32 - 1 or m >= 2**32 - 1:
        return None
    r = np.ascontiguousarray(row_ids, np.uint32)
    c = np.ascontiguousarray(col_ids, np.uint32)
    d = np.ascontiguousarray(data)
    if d.dtype.itemsize not in (4, 8) or d.dtype.hasobject:
        return None
    offsets = np.empty(m + 1, np.uint32)
    cols = np.empty(n, np.uint32)
    vals = np.empty(n, d.dtype)
    rc = lib.speck_coo_to_csr(
        r.ctypes.data_as(_U32P), c.ctypes.data_as(_U32P),
        d.ctypes.data_as(ctypes.c_char_p), n, m, int(d.dtype.itemsize),
        offsets.ctypes.data_as(_U32P), cols.ctypes.data_as(_U32P),
        vals.ctypes.data_as(ctypes.c_char_p))
    if rc != 0:
        raise ValueError(
            f"row index out of bounds in COO->CSR convert (rows={m})")
    return offsets, cols, vals


def mtx_write_native(fh, row_ids, col_ids, data, field: str,
                     chunk: int = 1 << 20) -> bool:
    """Write a COO body as MatrixMarket text to ``fh``, ``chunk`` entries
    at a time through one reused buffer (about 64 bytes an entry). Returns
    False when the library is unavailable (the caller formats with
    numpy); a buffer overflow leaves no partial body behind."""
    lib = get_lib()
    if lib is None:
        return False
    n = int(row_ids.shape[0])
    ncol = 2 if field == "pattern" else 3
    cap = min(n, chunk) * 64 + 64
    buf = ctypes.create_string_buffer(cap)
    start = fh.tell()
    for lo in range(0, n, chunk):
        hi = min(n, lo + chunk)
        r = np.ascontiguousarray(row_ids[lo:hi], np.uint32)
        c = np.ascontiguousarray(col_ids[lo:hi], np.uint32)
        d = np.ascontiguousarray(data[lo:hi], np.float64)
        wrote = lib.speck_mtx_format(
            r.ctypes.data_as(_U32P), c.ctypes.data_as(_U32P),
            d.ctypes.data_as(_F64P), hi - lo, ncol, buf, cap)
        if wrote < 0:
            fh.seek(start)
            fh.truncate()
            return False
        fh.write(ctypes.string_at(buf, int(wrote)))
    return True


def mtx_parse_native(path: str, dtype):
    """Parse a .mtx file with the native tokenizer: a HostCOO, or None
    where the library is unavailable or the body is malformed (the caller
    parses with numpy). Header checks, bounds checks and the symmetric
    mirror are the numpy path's."""
    from ..formats.csr import HostCOO
    from ..formats.mtx import _parse_header

    lib = get_lib()
    if lib is None:
        return None
    with open(path, "rb") as fh:
        field, symmetry = _parse_header(
            fh.readline().decode("ascii", "replace"))
        while True:
            line = fh.readline()
            if not line:
                raise ValueError(
                    f"Failed to read matrix market header from {path!r}")
            s = line.strip()
            if not s or s.startswith(b"%"):
                continue
            parts = s.split()
            num_rows, num_cols, num_nnz = (int(parts[0]), int(parts[1]),
                                           int(parts[2]))
            break
        body = fh.read()

    ncol = {"pattern": 2, "complex": 4}.get(field, 3)
    r = np.empty(num_nnz, dtype=np.uint32)
    c = np.empty(num_nnz, dtype=np.uint32)
    d = np.empty(num_nnz, dtype=np.float64)
    got = lib.speck_mtx_parse(body, len(body), num_nnz, ncol,
                              r.ctypes.data_as(_U32P),
                              c.ctypes.data_as(_U32P),
                              d.ctypes.data_as(_F64P))
    if got != num_nnz:
        return None
    if (r < 1).any() or (r > num_rows).any():
        raise ValueError(
            f"Row index out of bounds in matrix market file {path!r}")
    if (c < 1).any() or (c > num_cols).any():
        raise ValueError(
            f"Column index out of bounds in matrix market file {path!r}")
    r -= 1
    c -= 1
    if field == "pattern":
        d[:] = 1.0
    dd = d.astype(dtype) if np.dtype(dtype) != np.float64 else d
    if symmetry in ("symmetric", "hermitian"):
        off = r != c
        r, c, dd = (np.concatenate([r, c[off]]), np.concatenate([c, r[off]]),
                    np.concatenate([dd, dd[off]]))
    return HostCOO(rows=num_rows, cols=num_cols, row_ids=r, col_ids=c,
                   data=dd)
