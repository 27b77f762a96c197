"""Matrix loading with binary caching and the A/B pairing rule.

The cache sits beside the input as ``<path><ext>.hicsr`` (ext "d_" for
float64, "" for float32); a cache older than its .mtx is reparsed. B = A
when A is square, else B = A^T.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np

from .csr import HostCSR, coo_to_csr, csr_transpose
from .hicsr import load_hicsr, store_hicsr
from .mtx import load_mtx


def _cache_path(path: str, dtype) -> str:
    ext = "d_" if np.dtype(dtype).itemsize == 8 else ""
    return path + ext + ".hicsr"


def load_matrix(path: str, dtype=np.float64, use_cache: bool = True,
                verbose: bool = False) -> HostCSR:
    """Load a matrix from .mtx (or its .hicsr cache) into a HostCSR."""
    cache = _cache_path(path, dtype)
    if (use_cache and os.path.exists(cache)
            and not (os.path.exists(path)
                     and os.path.getmtime(cache) < os.path.getmtime(path))):
        try:
            if verbose:
                print(f'trying to load csr file "{cache}"')
            return load_hicsr(cache, dtype=dtype)
        except (OSError, ValueError) as ex:  # corrupt or mismatched cache
            if verbose:
                print(f"could not load csr file:\n\t{ex}")
    if verbose:
        print(f'trying to load mtx file "{path}"')
    csr = coo_to_csr(load_mtx(path, dtype=dtype))
    if use_cache:
        try:
            store_hicsr(cache, csr)
        except OSError as ex:
            if verbose:
                print(f"could not write csr cache: {ex}")
    return csr


@dataclasses.dataclass
class DataLoader:
    """Loads A (cached) and derives B: B = A if square else A^T."""

    cpuA: HostCSR
    cpuB: HostCSR

    def __init__(self, path: str, dtype=np.float64, use_cache: bool = True,
                 verbose: bool = False):
        self.cpuA = load_matrix(path, dtype=dtype, use_cache=use_cache,
                                verbose=verbose)
        self.cpuB = (csr_transpose(self.cpuA)
                     if self.cpuA.rows != self.cpuA.cols else self.cpuA)
