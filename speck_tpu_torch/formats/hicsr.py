"""Binary CSR cache (.hicsr), byte-compatible with ``speck_tpu``'s.

Format: an 80-byte little-endian header (magic ``Hi\\x01Compsd``, 7 pad
bytes, then typesize, compresseddir=0, indexsize=4, fixedoffset=0,
offsetsize=4, rows, columns, nnz as uint64), a State block (16 bytes for
double, 8 for float), then data[nnz], col_ids[nnz] (uint32) and
row_offsets[rows+1] (uint32).
"""

from __future__ import annotations

import struct

import numpy as np

from .csr import HostCSR

MAGIC = b"Hi\x01Compsd"
_HEADER_FMT = "<9s7x8Q"  # 80 bytes
_HEADER_SIZE = struct.calcsize(_HEADER_FMT)


def _state_size(dtype) -> int:
    return 16 if np.dtype(dtype).itemsize == 8 else 8


def load_hicsr(path: str, dtype=np.float64) -> HostCSR:
    """Load a .hicsr binary CSR cache file."""
    with open(path, "rb") as fh:
        raw = fh.read(_HEADER_SIZE)
        if len(raw) != _HEADER_SIZE:
            raise ValueError("Could not read CSR header")
        (magic, typesize, _cdir, indexsize, _foff, offsetsize,
         num_rows, num_cols, num_nnz) = struct.unpack(_HEADER_FMT, raw)
        if magic != MAGIC:
            raise ValueError("File does not appear to be a CSR Matrix")
        if typesize != np.dtype(dtype).itemsize:
            raise ValueError(
                "File does not contain a CSR matrix with matching type")
        if indexsize != 4 or offsetsize != 4:
            raise ValueError("Unsupported index/offset size in .hicsr file")
        fh.read(_state_size(dtype))
        data = np.fromfile(fh, dtype=dtype, count=num_nnz)
        col_ids = np.fromfile(fh, dtype=np.uint32, count=num_nnz)
        row_offsets = np.fromfile(fh, dtype=np.uint32, count=num_rows + 1)
        if (data.shape[0] != num_nnz or col_ids.shape[0] != num_nnz
                or row_offsets.shape[0] != num_rows + 1):
            raise ValueError("Could not read CSR matrix data")
    return HostCSR(rows=int(num_rows), cols=int(num_cols),
                   row_offsets=row_offsets, col_ids=col_ids, data=data)


def store_hicsr(path: str, mat: HostCSR) -> None:
    """Store a HostCSR as .hicsr."""
    dtype = mat.data.dtype
    header = struct.pack(_HEADER_FMT, MAGIC, np.dtype(dtype).itemsize, 0, 4,
                         0, 4, mat.rows, mat.cols, mat.nnz)
    state = np.zeros(_state_size(dtype), dtype=np.uint8)
    state[: np.dtype(dtype).itemsize] = np.frombuffer(
        np.asarray(1, dtype=dtype).tobytes(), dtype=np.uint8)
    with open(path, "wb") as fh:
        fh.write(header)
        fh.write(state.tobytes())
        fh.write(np.ascontiguousarray(mat.data, dtype=dtype).tobytes())
        fh.write(np.ascontiguousarray(mat.col_ids, dtype=np.uint32).tobytes())
        fh.write(np.ascontiguousarray(mat.row_offsets,
                                      dtype=np.uint32).tobytes())
