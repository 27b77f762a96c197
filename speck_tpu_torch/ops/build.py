"""Build and load the port's CUDA kernels (``speck_tpu_torch/csrc``).

Each ``.cu`` source compiles with its own ``nvcc`` for ``sm_90a``, all
started together, and the objects link into one shared library with a
plain C interface, loaded with ctypes. The library lands in
``build/speck_tpu_torch/`` beside the package, named by a hash of the
sources and flags, so an edited source rebuilds and an unchanged one is
reused. Nothing builds at import: the first kernel launch calls
``library()``. A missing ``nvcc`` or a failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Optional

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "speck_tpu_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-lineinfo"]

_LIB: Optional[ctypes.CDLL] = None

_P = ctypes.c_void_p
_I64 = ctypes.c_longlong
_SIGNATURES = {
    # (rid plane or null for a per-row rid, col, val, last, sums, R, W,
    #  n_cols, scratch or null, stream)
    "speck_stream_contract": [_P, _P, _P, _P, _P, _I64, _I64, ctypes.c_int,
                              _P, _P],
    # (col, val, last, sums, R, W, n_cols, scratch or null, stream)
    "speck_contract_runs": [_P, _P, _P, _P, _I64, _I64, ctypes.c_int, _P,
                            _P],
    # the same two with double, bfloat16 and half values and sums
    **{f"speck_stream_contract_{t}": [_P, _P, _P, _P, _P, _I64, _I64,
                                      ctypes.c_int, _P, _P]
       for t in ("f64", "bf16", "f16")},
    **{f"speck_contract_runs_{t}": [_P, _P, _P, _P, _I64, _I64, ctypes.c_int,
                                    _P, _P]
       for t in ("f64", "bf16", "f16")},
    # (key_in, key_out, p_in[3], p_out[3], n_payloads, R, W, tile,
    #  scratch, stream)
    "speck_row_sort": [_P, _P, _P, _P, _P, _P, _P, _P, ctypes.c_int, _I64,
                       _I64, _I64, _P, _P],
    # (e, m, p0, su, sa, pend, nnz_a, window, sid_base, b_rec or null,
    #  a_data, n_a, a_type, b_indices, b_data, b_type, nnz_b, out_type,
    #  chunk_start, slots, n_cols, rid, col, val, stream)
    "speck_stream_expand": [_P, _I64, _P, _P, _P, _P, _I64, _I64, _P, _P,
                            _P, _I64, ctypes.c_int, _P, _P, ctypes.c_int,
                            _I64, ctypes.c_int, _I64, _I64, ctypes.c_int, _P,
                            _P, _P, _P],
    # (idx, tab, out, rows, S, stream)
    "speck_sublane_gather": [_P, _P, _P, _I64, ctypes.c_int, _P],
    # (offs, src, out, n_runs, L, stream)
    "speck_run_copy": [_P, _P, _P, _I64, ctypes.c_int, _P],
}


def _sources():
    return sorted(p for p in CSRC.iterdir()
                  if p.suffix in (".cu", ".cuh", ".h"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path("/usr/local/cuda/bin/nvcc")
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in _sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"libspeck_kernels_{h.hexdigest()[:16]}.so"


def _run(procs, verbose: bool) -> None:
    """Wait for every (command, process) and raise if one failed."""
    failed = []
    for cmd, proc in procs:
        stdout, stderr = proc.communicate()
        if verbose or proc.returncode != 0:
            print(stdout + stderr)
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}")
    if failed:
        raise RuntimeError("\n".join(failed))


def build(verbose: bool = False) -> Path:
    """Compile the kernels unless a library of these sources exists: one
    ``nvcc -c`` per source, all at once, then one link."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{out.stem}.{os.getpid()}"
    nvcc = _nvcc()
    flags = (["-Xptxas=-v"] if verbose else []) + NVCC_FLAGS
    objs, procs = [], []
    for src in (p for p in _sources() if p.suffix == ".cu"):
        obj = BUILD_DIR / f"{tag}.{src.stem}.o"
        cmd = [nvcc, *flags, "-c", "-o", str(obj), str(src)]
        procs.append((cmd, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
        objs.append(obj)
    _run(procs, verbose)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp), *map(str, objs)]
    _run([(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                 stderr=subprocess.PIPE, text=True))],
         verbose)
    for obj in objs:
        obj.unlink()
    os.replace(tmp, out)
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.speck_error_string.argtypes = [ctypes.c_int]
        lib.speck_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def check(err: int, what: str) -> None:
    """Raise if a launch returned a CUDA error code."""
    if err != 0:
        msg = library().speck_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")


if __name__ == "__main__":
    # build with the compiler's register and shared-memory report
    print(build(verbose=True))
