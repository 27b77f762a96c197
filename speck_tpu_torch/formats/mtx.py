"""MatrixMarket (.mtx) coordinate-file parser and writer.

The port of ``speck_tpu/formats/mtx.py``: only ``matrix coordinate``
files; real/integer/double, ``pattern`` (values 1) and ``complex`` (real
part) fields; general, symmetric and Hermitian symmetry (off-diagonal
entries mirrored); 1-based indices in the file; duplicates kept;
out-of-range indices raise. The native tokenizer and writer
(``speck_tpu_torch.native``) run where the library builds; the numpy
path gives the same result where it does not.
"""

from __future__ import annotations

import numpy as np

from .csr import HostCOO

_REAL_FIELDS = {"real", "integer", "double"}


def _parse_header(line: str):
    if not line.startswith("%%MatrixMarket matrix coordinate"):
        raise ValueError(
            "Can only read MatrixMarket format that is in coordinate form"
        )
    tokens = line.split()
    field = tokens[3].lower()
    symmetry = tokens[4].lower() if len(tokens) > 4 else "general"
    if field not in _REAL_FIELDS and field not in ("pattern", "complex"):
        raise ValueError(
            "MatrixMarket data type does not match matrix format")
    if symmetry not in ("general", "symmetric", "hermitian"):
        raise ValueError(
            "Can only read MatrixMarket format that is either symmetric,"
            " general or hermitian"
        )
    return field, symmetry


def load_mtx(path: str, dtype=np.float64, use_native: bool = True
             ) -> HostCOO:
    """Parse a .mtx file into a HostCOO (duplicates kept, symmetry
    expanded), natively unless ``use_native`` is False or the library is
    unavailable."""
    if use_native:
        try:
            from ..native import mtx_parse_native

            out = mtx_parse_native(path, dtype)
            if out is not None:
                return out
        except Exception:
            pass  # the numpy parser below gives the answer or the error
    with open(path, "r") as fh:
        field, symmetry = _parse_header(fh.readline())
        while True:
            line = fh.readline()
            if not line:
                raise ValueError(
                    f"Failed to read matrix market header from {path!r}")
            s = line.strip()
            if not s or s.startswith("%"):
                continue
            parts = s.split()
            num_rows, num_cols, num_nnz = (int(parts[0]), int(parts[1]),
                                           int(parts[2]))
            break
        body = fh.read()

    lines = [ln for ln in body.split("\n")
             if ln.strip() and not ln.lstrip().startswith("%")]
    if len(lines) < num_nnz:
        raise ValueError(
            f"Failed to read data from matrix market file {path!r}")
    ncol = {"pattern": 2, "complex": 4}.get(field, 3)
    tok = np.array("\n".join(lines[:num_nnz]).split(), dtype=np.float64)
    if tok.size != ncol * num_nnz:
        raise ValueError(
            f"Failed to read data from matrix market file {path!r}")
    tok = tok.reshape(num_nnz, ncol)
    r = tok[:, 0].astype(np.int64)
    c = tok[:, 1].astype(np.int64)
    d = (np.ones(num_nnz, dtype=dtype) if field == "pattern"
         else tok[:, 2].astype(dtype))

    if (r < 1).any() or (r > num_rows).any():
        raise ValueError(
            f"Row index out of bounds in matrix market file {path!r}")
    if (c < 1).any() or (c > num_cols).any():
        raise ValueError(
            f"Column index out of bounds in matrix market file {path!r}")
    r -= 1
    c -= 1
    if symmetry in ("symmetric", "hermitian"):
        off = r != c
        r, c, d = (np.concatenate([r, c[off]]), np.concatenate([c, r[off]]),
                   np.concatenate([d, d[off]]))
    return HostCOO(rows=num_rows, cols=num_cols, row_ids=r.astype(np.uint32),
                   col_ids=c.astype(np.uint32), data=d)


def store_mtx(path: str, coo: HostCOO, field: str = "real") -> None:
    """Write a HostCOO as a general MatrixMarket coordinate file (1-based).
    The body is formatted by the native writer where the library is
    available (%.17g: float64 round-trips exactly), else by numpy."""
    from ..native import mtx_write_native

    with open(path, "wb") as fh:
        fh.write(f"%%MatrixMarket matrix coordinate {field} general\n"
                 .encode())
        fh.write(f"{coo.rows} {coo.cols} {coo.nnz}\n".encode())
        if mtx_write_native(fh, coo.row_ids, coo.col_ids,
                            np.asarray(coo.data, np.float64), field):
            pass
        elif field == "pattern":
            np.savetxt(fh, np.stack([coo.row_ids + 1, coo.col_ids + 1],
                                    axis=1), fmt="%d %d")
        else:
            rec = np.rec.fromarrays([
                coo.row_ids.astype(np.int64) + 1,
                coo.col_ids.astype(np.int64) + 1,
                np.asarray(coo.data, np.float64),
            ])
            np.savetxt(fh, rec, fmt="%d %d %.17g")
