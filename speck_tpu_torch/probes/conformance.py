"""A seeded conformance sweep: every route and entry point of the port on
one device, held against the port's own CPU path and the scipy oracle.

    python -m speck_tpu_torch.probes.conformance [--device cuda|cpu]
        [--cases N] [--seed S] [--seconds T]

One seed names one case on any machine: ``case(seed)`` draws the inputs
(one of ``SHAPES``, sizes from 1 to about 2000, values), the value types,
the ``SpgemmConfig`` knobs and the entry point (one of ``ENTRIES``) from
``numpy.random.default_rng(seed)`` alone. Negative seeds name the
hand-built cases of ``FIXED`` (seed -1 is the first), one or more for each
route that random seeds may miss. The sweep runs seeds S, S + 1, ... until
N cases have run or T seconds have passed; S defaults to -len(FIXED), so
the fixed list comes first. ``--seed S --cases 1`` reruns one case.

Before the seeded cases, the three kernels (K1 ``stream_contract``, K2
``row_sort``, K3 ``contract_runs``) run at adversarial shapes against their
plain versions (``kernel_cases``): widths on and off their tiles, all keys
equal, every key INT32_MAX, rows sorted and reversed, one run over a whole
multi-tile row, every slot dead, each value type; two launches must give
the same bits. Then the device analysis and the routing gate run past 2^24
products (``ANALYSIS_CASES``), where a float32 sum rounds on each device
in its own order: every count and total must be exact.

Each seeded case runs twice on the device and, when the device is a card,
once on the CPU (the kernels' plain versions). The checks:

- plan fields (``plan_fields``: the route flags, the stream layout,
  ``pack_bits``, ``fused``, ``nnz``; the mesh's ``meta``) equal on the
  card and the CPU;
- C's ``row_offsets`` and ``col_ids`` equal bit for bit; its values
  within the bound of a sum taken in another order: 1e-6 + 1e-5 sum|a||b|
  in float32, 1e-12 sum|a||b| in float64, ``compare_csr_bound`` in 16
  bits;
- C within ``compare_csr`` of the scipy oracle of the inputs rounded to
  their types (rel_tol 2e-3, or 1e-9 for a float64 C; 16-bit C within
  ``compare_csr_bound``); a transpose equal to scipy's;
- a raise (TypeError where the reference refuses the value types,
  ``ProductOverflow``) the same raise on every run; any other exception
  is a failure;
- the two device runs return the same bits.

Each failure prints the seed, the case, the check and the first differing
row; the run ends with one summary line (cases, cases by route and by
entry point, raises, the deterministic share, failures, seconds) and exits
1 on any failure. It never falls back: ``--device cuda`` without a card
raises.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import dataclasses
import importlib
import math
import sys
import time
import traceback
import zlib
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from ..entry import esc_args, fixed_cap
from ..formats.csr import HostCSR
from ..ops import bitonic, contract
from ..ops.device_csr import DeviceCSR, device_get_csr, device_put_csr
from ..ops.esc import esc_fixed
from ..ops.stream import COMPACT_IMPLS, EXPAND_IMPLS, SORT_IMPLS
from ..ops.transpose import transpose
from ..parallel import (make_row_mesh, mesh_spgemm_fixed_cap,
                        mesh_stream_spgemm, mesh_stream_to_host_csr,
                        padded_to_host_csr)
from ..utils.compare import (compare_csr, compare_csr_bound,
                             product_magnitudes)
from ..utils.config import ProductOverflow, SpgemmConfig
from ..utils.device import resolve_device
from ..utils.oracle import oracle_spgemm

SHAPES = ("uniform", "banded", "block", "dense_row", "powerlaw", "singles",
          "zeros", "rect", "b_empty", "a_empty")
SHAPE_P = (0.08, 0.2, 0.1, 0.14, 0.12, 0.08, 0.06, 0.08, 0.07, 0.07)
ENTRIES = ("spgemm", "plan_execute", "transpose", "esc_fixed", "mesh")
ENTRY_P = (0.36, 0.18, 0.1, 0.1, 0.26)
TYPES = ("float32", "float64", "float16", "bfloat16")
EXCHANGES = ("allgather", "needset", "needset_overlap")
# the knobs a case may set away from their defaults
KNOBS = ("stream_width", "product_budget", "stream_max_width",
         "stream_level_factor", "fused_staging_budget", "enable_accum",
         "block_products", "host_analysis", "stream_compact_impl",
         "stream_expand_impl", "stream_sort_impl", "stream_pallas_contract",
         "dense_densify", "enable_dia", "enable_sdia", "dia_rows",
         "enable_dense", "enable_direct", "dia_gate_early",
         "dia_uniform_emit", "mesh_split_min_ops", "mesh_exchange_auto",
         "mesh_balance_rows")
# the routes a card run must hit (chip_smoke.py phase 8d)
ROUTES = ("dia", "sdia", "dia_rows", "dense", "direct", "stream_fused",
          "stream_two_phase", "ladder", "accum", "row_blocks", "esc_fixed",
          "transpose", "new_values", "mesh_stream_allgather",
          "mesh_stream_needset", "mesh_stream_needset_overlap",
          "mesh_ksplit", "mesh_sdia", "mesh_dense", "mesh_fixed_cap")
# routes whose values may differ between two calls on the card by design
# (ROADMAP.md standing decision 13): the accumulator sums its products by
# float64 atomics (index_add_), in the order the card runs them
NONDETERMINISTIC_ROUTES = frozenset({"accum"})
# raises the reference makes too: value types it refuses (TypeError), a
# row past the per-block budget (ProductOverflow)
EXPECTED_RAISES = (TypeError, ProductOverflow)

# the orchestrator's module: ``recording`` wraps its plan_spgemm
spgemm_mod = importlib.import_module("..ops.spgemm", __package__)

MAX_DIM = 2000
PRODUCT_CAP = 1 << 20        # products of one case
MESH_PRODUCT_CAP = 1 << 18
ESC_SLOT_CAP = 1 << 21       # esc_fixed's m * cap rectangle


@dataclasses.dataclass
class Case:
    """One conformance case: C = A @ B (or Aᵀ) through one entry point."""

    seed: int
    shape: str
    entry: str
    a: HostCSR
    b: HostCSR              # ``b is a``: A·A, one DeviceCSR for both
    types: Tuple[str, str]
    knobs: dict
    a2: Optional[HostCSR] = None      # plan_execute's new values of A
    shards: int = 0                   # mesh shards
    exchange: Optional[str] = None    # mesh: an exchange or "fixed_cap"
    name: str = ""                    # a fixed case's name

    def describe(self) -> str:
        what = f"{self.name}: " if self.name else ""
        mesh = (f" shards={self.shards} exchange={self.exchange}"
                if self.entry == "mesh" else "")
        same = " (A·A)" if self.b is self.a else ""
        return (f"{what}seed {self.seed} {self.shape} {self.entry}{mesh} "
                f"A {self.a.rows}x{self.a.cols} nnz {self.a.nnz}, B "
                f"{self.b.rows}x{self.b.cols} nnz {self.b.nnz}{same}, "
                f"types {self.types[0]} x {self.types[1]}, knobs "
                f"{self.knobs}")


# ---------------------------------------------------------------------------
# The generator
# ---------------------------------------------------------------------------


def _csr(rows, cols, vals, shape) -> HostCSR:
    """A canonical HostCSR (duplicates summed, columns sorted; explicit
    zeros kept) from coordinates."""
    import scipy.sparse as sp

    m = sp.csr_matrix((np.asarray(vals, np.float64),
                       (np.asarray(rows, np.int64),
                        np.asarray(cols, np.int64))), shape=shape)
    m.sum_duplicates()
    m.sort_indices()
    return HostCSR.from_scipy(m)


def _dim(rng, hi: int = MAX_DIM) -> int:
    """A size from 1 to hi, log-uniform."""
    return int(min(hi, math.exp(rng.uniform(0.0, math.log(hi + 1)))))


def _values(rng, n: int, ints: bool = False) -> np.ndarray:
    if ints:    # small integers: explicit zeros and sums that cancel
        return rng.integers(-2, 3, n).astype(np.float64)
    return rng.standard_normal(n)


def _uniform(rng, m: int, k: int, per_row: float, ints=False) -> HostCSR:
    nnz = int(rng.poisson(max(per_row, 0.0) * m)) if m and k else 0
    return _csr(rng.integers(0, m, nnz), rng.integers(0, k, nnz),
                _values(rng, nnz, ints), (m, k))


def _powerlaw(rng, m: int, k: int, avg: float, alpha: float) -> HostCSR:
    lens = np.minimum((rng.pareto(alpha, m) + 1) * avg * 0.5,
                      max(1, k // 2)).astype(np.int64)
    rows = np.repeat(np.arange(m), lens)
    return _csr(rows, rng.integers(0, k, rows.shape[0]),
                _values(rng, rows.shape[0]), (m, k))


def _band(rng, n: int, offsets, keep: float = 1.0) -> HostCSR:
    """The diagonals ``offsets`` of an n x n matrix, each entry kept with
    probability ``keep``."""
    rows, cols = [], []
    for o in offsets:
        r = np.arange(max(0, -o), min(n, n - o))
        rows.append(r)
        cols.append(r + o)
    rows = np.concatenate(rows) if rows else np.zeros(0, np.int64)
    cols = np.concatenate(cols) if cols else np.zeros(0, np.int64)
    if keep < 1.0:
        sel = rng.random(rows.shape[0]) < keep
        rows, cols = rows[sel], cols[sel]
    return _csr(rows, cols, _values(rng, rows.shape[0]), (n, n))


def _banded(rng, n: int) -> HostCSR:
    """A contiguous band, a stencil of far diagonals (sparse DIA), or a
    band with a block of outlier rows (the per-row DIA split)."""
    kind = rng.choice(3, p=(0.35, 0.3, 0.35))
    if kind == 0:
        hb = int(rng.integers(0, 13))
        return _band(rng, n, range(-hb, hb + 1),
                     1.0 if rng.random() < 0.7 else rng.uniform(0.5, 1.0))
    if kind == 1:
        g = max(2, int(round(n ** (1.0 / 3.0))))
        offs = sorted({0, 1, -1, g, -g, g * g, -g * g})
        return _band(rng, n, offs)
    hb = int(rng.integers(1, 9))
    base = _band(rng, n, range(-hb, hb + 1))
    n_out = max(1, int(n * rng.uniform(0.005, 0.03)))
    per = int(rng.integers(4, 33))
    rows = np.repeat(np.arange(n_out), per)
    extra = _csr(rows, rng.integers(0, n, rows.shape[0]),
                 _values(rng, rows.shape[0]), (n, n))
    return _add(base, extra)


def _add(x: HostCSR, y: HostCSR) -> HostCSR:
    s = (x.to_scipy() + y.to_scipy()).tocsr()
    s.sum_duplicates()
    s.sort_indices()
    return HostCSR.from_scipy(s)


def _block(rng, n: int) -> HostCSR:
    """Rows of a block of at least one 256-row tile whose entries lie in a
    window about the diagonal (the dense tiles' class), plus noise rows."""
    n = max(n, 300)
    r0 = int(rng.integers(0, max(1, n - 256)))
    r1 = min(n, r0 + int(rng.integers(256, 700)))
    w = int(rng.integers(16, 97))
    per = int(rng.integers(4, min(40, 2 * w)))
    rows = np.repeat(np.arange(r0, r1), per)
    cols = np.clip(rows + rng.integers(-w, w + 1, rows.shape[0]), 0, n - 1)
    noise = int(rng.integers(0, 3 * n))
    rows = np.concatenate([rows, rng.integers(0, n, noise)])
    cols = np.concatenate([cols, rng.integers(0, n, noise)])
    return _csr(rows, cols, _values(rng, rows.shape[0]), (n, n))


def _dense_row(rng, m: int, k: int) -> HostCSR:
    """A sparse base with one to three rows of k/4 .. k entries (wide rows,
    the merge ladder, the accumulator, the mesh's k-split)."""
    base = _uniform(rng, m, k, rng.uniform(1.0, 8.0))
    rows, cols = [], []
    for r in rng.choice(m, size=min(m, int(rng.integers(1, 4))),
                        replace=False):
        c = rng.choice(k, size=max(1, int(k * rng.uniform(0.25, 1.0))),
                       replace=False)
        rows.append(np.full(c.shape[0], r))
        cols.append(c)
    rows, cols = np.concatenate(rows), np.concatenate(cols)
    return _add(base, _csr(rows, cols, _values(rng, rows.shape[0]), (m, k)))


def _singles(rng, m: int, k: int) -> HostCSR:
    """Rows of one nonzero (direct copies) among empty rows and a few
    longer rows."""
    lens = np.where(rng.random(m) < rng.uniform(0.2, 0.7), 0, 1)
    lens[rng.random(m) < 0.1] = rng.integers(2, 12)
    rows = np.repeat(np.arange(m), lens)
    return _csr(rows, rng.integers(0, k, rows.shape[0]),
                _values(rng, rows.shape[0]), (m, k))


def _empty(m: int, k: int) -> HostCSR:
    return _csr([], [], [], (m, k))


def _operands(rng, shape: str, scale: float, dims=None):
    """(A, B) of a shape class at a size scaled by ``scale`` (<= 1), each
    size drawn from ``dims`` when it is given."""
    def dim():
        if dims is not None:
            return max(1, int(dims[int(rng.integers(len(dims)))] * scale))
        return max(1, int(_dim(rng) * scale))

    n = dim()
    if shape == "uniform":
        a = _uniform(rng, n, n, rng.uniform(0.5, 20.0))
        b = a if rng.random() < 0.5 else _uniform(rng, n, n,
                                                  rng.uniform(0.5, 20.0))
    elif shape == "banded":
        a = _banded(rng, max(n, 8))
        b = a if rng.random() < 0.7 else _banded(rng, a.rows)
    elif shape == "block":
        a = _block(rng, int(n * 0.5 + 300))
        b = a if rng.random() < 0.6 else _uniform(rng, a.rows, a.rows,
                                                  rng.uniform(1.0, 8.0))
    elif shape == "dense_row":
        n, k = max(n, 64), max(dim(), 64)
        a = _dense_row(rng, n, k)
        b = a if n == k and rng.random() < 0.5 else _uniform(
            rng, k, dim(), rng.uniform(1.0, 12.0))
    elif shape == "powerlaw":
        a = _powerlaw(rng, n, n, rng.uniform(2.0, 16.0),
                      rng.uniform(1.5, 2.5))
        b = a if rng.random() < 0.6 else _powerlaw(
            rng, n, n, rng.uniform(2.0, 16.0), rng.uniform(1.5, 2.5))
    elif shape == "singles":
        k = dim()
        a = _singles(rng, n, k)
        b = _uniform(rng, k, dim(), rng.uniform(0.5, 12.0))
    elif shape == "zeros":
        a = _uniform(rng, n, n, rng.uniform(1.0, 12.0), ints=True)
        b = a if rng.random() < 0.5 else _uniform(rng, n, n,
                                                  rng.uniform(1.0, 12.0),
                                                  ints=True)
    elif shape == "rect":
        m, k, nn = dim(), dim(), dim()
        pick = rng.integers(4)
        if pick == 1:
            m = 1          # 1 x k times k x n
        elif pick == 2:
            k = 1          # m x 1 times 1 x n: an outer product
            m, nn = min(m, 700), min(nn, 700)
        elif pick == 3:
            nn = 1         # k x 1 columns
        a = _uniform(rng, m, k, rng.uniform(0.5, 10.0) if k > 1 else 0.8)
        b = _uniform(rng, k, nn, rng.uniform(0.5, 10.0) if nn > 1 else 0.8)
    elif shape == "b_empty":
        k = dim()
        a = _uniform(rng, n, k, rng.uniform(0.5, 10.0))
        b = _empty(k, dim())
    elif shape == "a_empty":
        k = dim()
        a = _empty(n, k)
        b = _uniform(rng, k, dim(), rng.uniform(0.5, 10.0))
    else:
        raise ValueError(f"unknown shape class {shape!r}")
    return a, b


def row_products(a: HostCSR, b: HostCSR) -> np.ndarray:
    """Exact products of each row of A @ B (int64)."""
    b_len = np.diff(np.asarray(b.row_offsets, np.int64))
    per = b_len[np.asarray(a.col_ids, np.int64)]
    out = np.zeros(a.rows, np.int64)
    np.add.at(out, np.repeat(np.arange(a.rows), np.diff(
        np.asarray(a.row_offsets, np.int64))), per)
    return out


def c_widest(a: HostCSR, b: HostCSR) -> int:
    """The longest row of A @ B's structure."""
    import scipy.sparse as sp

    def pattern(h):
        return sp.csr_matrix((np.ones(h.nnz), np.asarray(h.col_ids, np.int64),
                              np.asarray(h.row_offsets, np.int64)),
                             shape=(h.rows, h.cols))

    return int(np.diff((pattern(a) @ pattern(b)).indptr).max(initial=0))


def _pow2(x: int) -> int:
    return 1 << (int(x) - 1).bit_length() if x > 1 else 1


def _types(rng, entry: str) -> Tuple[str, str]:
    u = rng.random()
    if u < 0.5:
        t = ("float32", "float32")
    elif u < 0.7:
        t = ("float64", "float64")
    elif u < 0.85:
        x = TYPES[2 + int(rng.integers(2))]
        t = (x, x)
    else:
        t = (TYPES[int(rng.integers(4))], TYPES[int(rng.integers(4))])
    if entry in ("esc_fixed", "mesh", "transpose"):
        t = (t[0], t[0])
    return t


def _knobs(rng, shape: str, entry: str, exchange: Optional[str],
           ops: np.ndarray, c_widest: int) -> dict:
    """SpgemmConfig keywords away from the defaults, each with its own
    probability."""
    kw = {}

    def maybe(p):
        return rng.random() < p

    # rows of many products (wide rows, the ladder) meet narrow widths
    wide = shape in ("dense_row", "powerlaw")
    W = 1 << int(rng.integers(6, 11 if wide else 14))
    if maybe(0.8 if wide else 0.5):
        kw["stream_width"] = W
    if maybe(0.5):
        kw["product_budget"] = W << int(rng.integers(0, 6))
    if maybe(0.2):
        kw["stream_level_factor"] = int(rng.choice([2, 3, 3, 8]))
    if maybe(0.6 if wide else 0.15):
        # below the widest C row, so that its wide rows merge in levels
        F = kw.get("stream_level_factor", 4)
        kw["stream_max_width"] = max(
            W, _pow2(c_widest) // F ** int(rng.integers(1, 3)))
    if maybe(0.25):
        kw["fused_staging_budget"] = 0
    if maybe(0.2):
        kw["enable_accum"] = True
        kw["accum_min_ops"] = int(rng.choice([16, 64, 256]))
    total, widest = int(ops.sum()), int(ops.max(initial=0))
    if entry == "spgemm" and maybe(0.12) and total > 2 * widest + 2:
        kw["block_products"] = max(2 * widest + 2, total // 2)
    if maybe(0.15):
        kw["host_analysis"] = False
    if maybe(0.15):
        kw["stream_compact_impl"] = str(rng.choice(COMPACT_IMPLS))
    if maybe(0.15):
        kw["stream_expand_impl"] = str(rng.choice(EXPAND_IMPLS))
    if maybe(0.15):
        kw["stream_sort_impl"] = str(rng.choice(SORT_IMPLS))
    if maybe(0.1):
        kw["stream_pallas_contract"] = True
    if maybe(0.1):
        kw["dense_densify"] = "scatter"
    for name in ("enable_dia", "enable_sdia", "dia_rows", "enable_dense",
                 "enable_direct", "dia_gate_early", "dia_uniform_emit"):
        if maybe(0.08):
            kw[name] = False
    if exchange == "allgather" and maybe(0.5):
        kw["enable_dense"] = False    # the stream route, not the window
    if entry == "mesh":
        if maybe(0.4) and widest > 1:
            kw["mesh_split_min_ops"] = max(1, widest // 2)
        if maybe(0.5):
            kw["mesh_exchange_auto"] = False
        if maybe(0.2):
            kw["mesh_balance_rows"] = False
    return kw


def _draw(rng, seed: int, dims=None) -> Case:
    entry = ENTRIES[int(rng.choice(len(ENTRIES), p=ENTRY_P))]
    shape = SHAPES[int(rng.choice(len(SHAPES), p=SHAPE_P))]
    exchange = None
    if entry == "mesh":
        exchange = ("fixed_cap" if rng.random() < 0.15
                    else EXCHANGES[int(rng.integers(3))])
    cap = MESH_PRODUCT_CAP if entry == "mesh" else PRODUCT_CAP
    scale = 1.0
    while True:
        a, b = _operands(rng, shape, scale, dims)
        ops = row_products(a, b)
        work = max(int(np.maximum(ops, np.diff(a.row_offsets)).max(
            initial=0)), 1)
        fits = int(ops.sum()) <= cap
        if entry == "esc_fixed":
            fits = fits and a.rows * _pow2(work) <= ESC_SLOT_CAP
        if fits:
            break
        scale *= 0.5
    widest = c_widest(a, b)
    if entry == "transpose":
        b = a
    types = _types(rng, entry)
    if b is a and types[0] != types[1]:
        b = HostCSR.from_parts(a.rows, a.cols, a.row_offsets, a.col_ids,
                               a.data)
    knobs = _knobs(rng, shape, entry, exchange, ops, widest)
    c = Case(seed=seed, shape=shape, entry=entry, a=a, b=b, types=types,
             knobs=knobs)
    if entry == "plan_execute":
        c.knobs.pop("block_products", None)
        c.a2 = HostCSR.from_parts(a.rows, a.cols, a.row_offsets, a.col_ids,
                                  _values(rng, a.nnz, shape == "zeros"))
    if entry == "mesh":
        c.shards, c.exchange = int(rng.integers(2, 5)), exchange
    return c


def case(seed: int, dims=None) -> Case:
    """The case of ``seed``: a fixed case for a negative seed (``FIXED``),
    else drawn from ``numpy.random.default_rng(seed)`` alone, its sizes
    from ``dims`` when given (a few sizes: the CPU test against the
    reference, whose compiles are then shared), else from 1 to
    ``MAX_DIM``."""
    if seed < 0:
        name, build = FIXED[-seed - 1]
        c = build(np.random.default_rng(1000 + seed))
        c.seed, c.name = seed, name
        return c
    return _draw(np.random.default_rng(seed), seed, dims)


# ---------------------------------------------------------------------------
# The fixed cases: one or more a route
# ---------------------------------------------------------------------------


F32, F64, BF16 = (("float32",) * 2, ("float64",) * 2, ("bfloat16",) * 2)


def _fixed(shape, entry, a, b, types=F32, a2=None, shards=0, exchange=None,
           **knobs):
    return Case(seed=0, shape=shape, entry=entry, a=a, b=b, types=types,
                knobs=knobs, a2=a2, shards=shards, exchange=exchange)


def _fx_band(rng, n=1024, hb=4):
    return _band(rng, n, range(-hb, hb + 1))


def _fx_stencil(rng, g=12):
    return _band(rng, g ** 3, sorted({0, 1, -1, g, -g, g * g, -g * g}))


def _fx_mixed(rng, n=2048, hb=4, n_out=32, per=24):
    rows = np.repeat(np.arange(n_out), per)
    return _add(_fx_band(rng, n, hb), _csr(
        rows, rng.integers(0, n, rows.shape[0]),
        _values(rng, rows.shape[0]), (n, n)))


def _fx_block(rng, n=768):
    rows = np.repeat(np.arange(n), 24)
    cols = np.clip(rows + rng.integers(-48, 49, rows.shape[0]), 0, n - 1)
    return _csr(rows, cols, _values(rng, rows.shape[0]), (n, n))


def _fx_wide(rng, n=1500):
    return _dense_row(rng, n, n)


def _aa(shape, entry, a, types=F32, **kw):
    """A·A through ``entry``."""
    return _fixed(shape, entry, a, a, types, **kw)


def _aa_new(r, shape, a, types=F32, **kw):
    """A·A planned once, then executed with A's values and with new ones."""
    a2 = HostCSR.from_parts(a.rows, a.cols, a.row_offsets, a.col_ids,
                            r.standard_normal(a.nnz))
    return _aa(shape, "plan_execute", a, types, a2=a2, **kw)


def _fx_row_blocks(r):
    """A power law under a block budget of a third of its products: spgemm
    runs it in row blocks."""
    a = _powerlaw(r, 1500, 1500, 6.0, 2.2)
    ops = row_products(a, a)
    return _aa("powerlaw", "spgemm", a, block_products=max(
        int(ops.sum()) // 3, 2 * int(ops.max()) + 2))


FIXED: List[Tuple[str, Callable]] = [
    ("dia", lambda r: _aa("banded", "spgemm", _fx_band(r))),
    ("dia float64 new values",
     lambda r: _aa_new(r, "banded", _fx_band(r), F64)),
    ("sdia", lambda r: _aa("banded", "spgemm", _fx_stencil(r))),
    ("dia_rows", lambda r: _aa("banded", "spgemm", _fx_mixed(r))),
    ("dia_rows float64 new values",
     lambda r: _aa_new(r, "banded", _fx_mixed(r), F64)),
    ("dia_rows bfloat16", lambda r: _aa(
        "banded", "spgemm", _fx_mixed(r, 1536, 3, 24, 16), BF16)),
    ("sdia bfloat16",
     lambda r: _aa("banded", "spgemm", _fx_stencil(r, 10), BF16)),
    ("dense", lambda r: _aa("block", "spgemm", _fx_block(r),
                            enable_dia=False)),
    ("direct", lambda r: _fixed("singles", "spgemm", _singles(r, 1200, 800),
                                _uniform(r, 800, 900, 6.0))),
    ("stream two-phase", lambda r: _aa(
        "powerlaw", "spgemm", _powerlaw(r, 1200, 1200, 6.0, 2.0),
        fused_staging_budget=0, stream_width=256)),
    ("stream two-phase float64", lambda r: _aa(
        "dense_row", "spgemm", _fx_wide(r, 900), F64,
        fused_staging_budget=0, stream_width=128)),
    ("ladder", lambda r: _aa(
        "dense_row", "spgemm", _fx_wide(r), stream_width=64,
        product_budget=1 << 10, stream_max_width=256)),
    ("ladder, level factor 3", lambda r: _aa(
        "dense_row", "spgemm", _fx_wide(r), stream_width=128,
        product_budget=1 << 11, stream_level_factor=3,
        stream_max_width=3 * 3 * 128)),
    ("ladder float64 new values", lambda r: _aa_new(
        r, "dense_row", _fx_wide(r, 1200), F64, stream_width=64,
        product_budget=1 << 10, stream_max_width=256)),
    ("accum", lambda r: _aa(
        "dense_row", "spgemm", _fx_wide(r), enable_accum=True,
        accum_min_ops=64, stream_width=256)),
    ("accum float64", lambda r: _aa(
        "dense_row", "spgemm", _fx_wide(r), F64, enable_accum=True,
        accum_min_ops=64, stream_width=256)),
    ("accum, B without nonzeros", lambda r: _fixed(
        "b_empty", "spgemm", _uniform(r, 130, 7, 3.0), _empty(7, 257),
        enable_accum=True, accum_min_ops=16)),
    ("row blocks", _fx_row_blocks),
    ("esc_fixed", lambda r: _aa("uniform", "esc_fixed",
                                _uniform(r, 700, 700, 6.0))),
    ("esc_fixed, B without nonzeros", lambda r: _fixed(
        "b_empty", "esc_fixed", _uniform(r, 90, 40, 4.0), _empty(40, 70))),
    ("transpose", lambda r: _aa("rect", "transpose",
                                _uniform(r, 900, 1300, 5.0))),
    ("mesh allgather", lambda r: _aa(
        "powerlaw", "mesh", _powerlaw(r, 800, 800, 6.0, 2.0), shards=4,
        exchange="allgather", enable_dense=False)),
    ("mesh needset", lambda r: _aa(
        "powerlaw", "mesh", _powerlaw(r, 800, 800, 6.0, 2.0), shards=3,
        exchange="needset", mesh_exchange_auto=False)),
    ("mesh needset_overlap", lambda r: _aa(
        "powerlaw", "mesh", _powerlaw(r, 800, 800, 6.0, 2.0), shards=4,
        exchange="needset_overlap", mesh_exchange_auto=False)),
    ("mesh k-split", lambda r: _aa(
        "dense_row", "mesh", _fx_wide(r, 600), shards=4, exchange="needset",
        mesh_split_min_ops=200, mesh_exchange_auto=False, stream_width=64,
        product_budget=1 << 12)),
    ("mesh sdia", lambda r: _aa("banded", "mesh", _fx_band(r, 1024, 3),
                                shards=4, exchange="needset")),
    ("mesh sdia float64", lambda r: _aa(
        "banded", "mesh", _fx_stencil(r, 9), F64, shards=3,
        exchange="allgather")),
    ("mesh dense", lambda r: _aa(
        "banded", "mesh", _fx_band(r, 1024, 8), shards=2,
        exchange="allgather", enable_sdia=False)),
    ("mesh fixed cap", lambda r: _aa("uniform", "mesh",
                                     _uniform(r, 600, 600, 5.0), shards=4,
                                     exchange="fixed_cap")),
]


# ---------------------------------------------------------------------------
# Running a case
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Output:
    """One result of a case: C on the host, its type, and the inputs its
    oracle multiplies (or, for a transpose, the exact expected matrix)."""

    label: str
    c: HostCSR
    ctype: str
    a: Optional[HostCSR] = None
    b: Optional[HostCSR] = None
    exact: Optional[HostCSR] = None


@dataclasses.dataclass
class Outcome:
    raised: Optional[str] = None
    fields: list = dataclasses.field(default_factory=list)
    outs: List[Output] = dataclasses.field(default_factory=list)
    routes: set = dataclasses.field(default_factory=set)


def _tdtype(name: str) -> torch.dtype:
    return getattr(torch, name)


def _dtype_name(dt: torch.dtype) -> str:
    return str(dt).replace("torch.", "")


def rounded(h: HostCSR, dtype: str) -> HostCSR:
    """``h`` with its values rounded to ``dtype`` (held as float64)."""
    return HostCSR.from_parts(h.rows, h.cols, h.row_offsets, h.col_ids,
                              torch.as_tensor(np.asarray(h.data, np.float64))
                              .to(_tdtype(dtype)).double().numpy())


def _config(c: Case) -> SpgemmConfig:
    return SpgemmConfig(**c.knobs)


def _put(c: Case, device):
    A = device_put_csr(c.a, _tdtype(c.types[0]), device=device)
    B = A if c.b is c.a else device_put_csr(c.b, _tdtype(c.types[1]),
                                            device=device)
    return A, B


def plan_fields(plan) -> dict:
    """The plan's route flags and layout as plain values (the same names in
    the reference's plans): the DIA state, the per-row split, the dense
    tiles, the direct groups, the stream layout, ``pack_bits``, ``fused``,
    ``n_accum``, the merge levels, ``nnz`` and the widest row."""
    f = {"nnz": int(plan.nnz), "max_count": int(plan.max_count)}
    d = plan.dia
    f["dia"] = None if d is None else (
        "sparse" if d.off_a is not None else "contiguous", d.span_a,
        d.span_b, d.span_c, d.dmin_a, d.dmin_b,
        None if d.uniform is None else tuple(int(x) for x in d.uniform),
        d.staged is not None, d.off_a, d.off_b)
    r = plan.dia_rows
    f["dia_rows"] = None if r is None else (r.span_a, r.span_b, r.span_c,
                                            r.dmin_a, r.dmin_b)
    g = plan.dense
    f["dense"] = None if g is None else (
        int(len(g.r0s)), tuple(int(x) for x in g.boffs), g.tile_rows, g.kw,
        g.cw, g.la, g.lb, bool(g.full_cover))
    f["direct"] = [(x.cap, x.rows, tuple(int(v) for v in x.starts),
                    tuple(int(v) for v in x.valids)) for x in plan.groups]
    s = plan.stream
    if s is None:
        f["stream"] = None
    else:
        lo = s.layout
        f["stream"] = dict(
            {k: int(getattr(lo, k)) for k in (
                "W", "G", "g_last", "n_chunks", "total_q", "n_wide",
                "r_wide", "n_stream_rows", "n_direct_rows")},
            pack_bits=int(s.pack_bits), fused=bool(s.fused),
            n_accum=int(s.n_accum), levels=len(s.lplans))
    return f


def plan_routes(plan) -> set:
    """The routes a plan takes (``ROUTES``' single-device names)."""
    r = set()
    if plan.dia is not None:
        r.add("sdia" if plan.dia.off_a is not None else "dia")
    if plan.dia_rows is not None:
        r.add("dia_rows")
    if plan.dense is not None:
        r.add("dense")
    if plan.groups:
        r.add("direct")
    s = plan.stream
    if s is not None:
        if s.layout.n_stream_rows > 0:
            r.add("stream_fused" if s.fused else "stream_two_phase")
        if (s.layout.n_wide > 0 and s.finish is not None
                and s.finish.get("ladder_levels", 0) > 0):
            r.add("ladder")
        if s.n_accum > 0:
            r.add("accum")
    return r


@contextlib.contextmanager
def recording(plans: list, module=spgemm_mod):
    """Record every plan the ``spgemm`` of ``module`` makes (the port's
    orchestrator by default; a test passes the reference's, whose names
    are the same), None for one that raised ProductOverflow: the call then
    runs in row blocks."""
    made, overflow = module.plan_spgemm, module.ProductOverflow

    def plan_spgemm(*args, **kw):
        try:
            p = made(*args, **kw)
        except overflow:
            plans.append(None)
            raise
        plans.append(p)
        return p

    module.plan_spgemm = plan_spgemm
    try:
        yield
    finally:
        module.plan_spgemm = made


def _host_c(C: DeviceCSR) -> Tuple[HostCSR, str]:
    return device_get_csr(C), _dtype_name(C.data.dtype)


def _run_spgemm(c: Case, device) -> Outcome:
    A, B = _put(c, device)
    plans: list = []
    with recording(plans):
        C = spgemm_mod.spgemm(A, B, _config(c))
    out = Outcome(fields=[None if p is None else plan_fields(p)
                          for p in plans])
    for p in plans:
        out.routes |= {"row_blocks"} if p is None else plan_routes(p)
    h, t = _host_c(C)
    out.outs.append(Output("C", h, t, c.a, c.b))
    return out


def _run_plan_execute(c: Case, device) -> Outcome:
    A, B = _put(c, device)
    plan = spgemm_mod.plan_spgemm(A, B, _config(c))
    C1 = plan.execute()
    A2 = device_put_csr(c.a2, _tdtype(c.types[0]), device=device)
    same = c.b is c.a
    C2 = plan.execute(A2, A2 if same else B)
    out = Outcome(fields=[plan_fields(plan)],
                  routes=plan_routes(plan) | {"new_values"})
    h, t = _host_c(C1)
    out.outs.append(Output("execute()", h, t, c.a, c.b))
    h, t = _host_c(C2)
    out.outs.append(Output("execute(A2, B)", h, t, c.a2,
                           c.a2 if same else c.b))
    return out


def _run_transpose(c: Case, device) -> Outcome:
    A = device_put_csr(c.a, _tdtype(c.types[0]), device=device)
    h, t = _host_c(transpose(A))
    s = rounded(c.a, c.types[0]).to_scipy().T.tocsr()
    s.sort_indices()
    return Outcome(routes={"transpose"},
                   outs=[Output("A^T", h, t, exact=HostCSR.from_scipy(s))])


def _run_esc_fixed(c: Case, device) -> Outcome:
    dt = _tdtype(c.types[0])
    cap = fixed_cap(c.a, c.b)
    args = list(esc_args(c.a, c.b, resolve_device(device), np.float64))
    args[2], args[6] = args[2].to(dt), args[6].to(dt)
    counts, cols, vals = esc_fixed(*args, cap=cap, n_cols=c.b.cols)
    h = padded_to_host_csr(counts, cols, vals, c.a.rows, c.b.cols)
    return Outcome(fields=[{"cap": cap, "type": _dtype_name(vals.dtype)}],
                   routes={"esc_fixed"},
                   outs=[Output("C", h, _dtype_name(vals.dtype), c.a, c.b)])


def mesh_fields(meta) -> dict:
    """The mesh's plan fields: its route, shard ranges, per-shard sizes,
    k-split plan and exchange mode and bytes."""
    st = meta.get("stats")
    return {"route": meta["route"],
            "ranges": [tuple(int(x) for x in r) for r in meta["ranges"]],
            "m_loc": meta["m_loc"], "out_cap": meta["out_cap"],
            "ksplit": meta.get("ksplit"),
            "stats": None if st is None else (
                st.mode, int(st.allgather_bytes), int(st.needset_bytes))}


def _run_mesh(c: Case, device) -> Outcome:
    dt = _tdtype(c.types[0])
    mesh = make_row_mesh(c.shards, devices=[resolve_device(device)])
    if c.exchange == "fixed_cap":
        counts, cols, vals = mesh_spgemm_fixed_cap(c.a, c.b, mesh, dtype=dt)
        h = padded_to_host_csr(counts, cols, vals, c.a.rows, c.b.cols)
        return Outcome(fields=[{"cap": int(cols.shape[1])}],
                       routes={"mesh_fixed_cap"},
                       outs=[Output("C", h, _dtype_name(vals.dtype), c.a,
                                    c.b)])
    out = mesh_stream_spgemm(c.a, c.b, mesh, _config(c), exchange=c.exchange,
                             dtype=dt)
    meta = out[3]
    routes = {f"mesh_{meta['route']}"}
    if meta["route"] == "stream":
        # all_gather keeps no exchange statistics; "allgather(auto)" is
        # the need-set call that fell back to it
        st = meta["stats"]
        mode = "allgather" if st is None else st.mode.split("(")[0]
        routes = {f"mesh_stream_{mode}"}
        if meta.get("ksplit") is not None:
            routes.add("mesh_ksplit")
    return Outcome(fields=[mesh_fields(meta)], routes=routes,
                   outs=[Output("C", mesh_stream_to_host_csr(*out),
                                _dtype_name(out[2].dtype), c.a, c.b)])


_RUNNERS = {"spgemm": _run_spgemm, "plan_execute": _run_plan_execute,
            "transpose": _run_transpose, "esc_fixed": _run_esc_fixed,
            "mesh": _run_mesh}


def run_case(c: Case, device) -> Outcome:
    """One run of a case on ``device``; an expected raise is recorded as
    its type and message, any other exception propagates."""
    try:
        return _RUNNERS[c.entry](c, device)
    except EXPECTED_RAISES as e:
        return Outcome(raised=f"{type(e).__name__}: {e}")


# ---------------------------------------------------------------------------
# The checks
# ---------------------------------------------------------------------------


def _first_row(off, pos) -> int:
    return int(np.searchsorted(np.asarray(off, np.int64), pos,
                               side="right")) - 1


def same_bits(x: HostCSR, y: HostCSR) -> Optional[str]:
    """None when x and y hold the same bits, else where they first
    differ."""
    for what in ("row_offsets", "col_ids", "data"):
        u, v = np.asarray(getattr(x, what)), np.asarray(getattr(y, what))
        if u.shape != v.shape or u.dtype != v.dtype:
            return f"{what} shape or type {u.shape} {u.dtype} != {v.shape} " \
                   f"{v.dtype}"
        neq = u.view(np.uint8).reshape(u.shape[0], -1) != \
            v.view(np.uint8).reshape(v.shape[0], -1) if u.size else \
            np.zeros((0, 1), bool)
        if neq.any():
            pos = int(np.argmax(neq.any(axis=1)))
            row = pos if what == "row_offsets" else _first_row(
                x.row_offsets, pos)
            return f"{what} differ first at {pos} (row {row})"
    return None


def same_structure(x: HostCSR, y: HostCSR) -> Optional[str]:
    """None when x and y have the same ``row_offsets`` and ``col_ids``,
    else where they first differ."""
    for what in ("row_offsets", "col_ids"):
        u = np.asarray(getattr(x, what), np.int64)
        v = np.asarray(getattr(y, what), np.int64)
        if u.shape != v.shape:
            return f"{what}: {u.shape} != {v.shape}"
        if not np.array_equal(u, v):
            pos = int(np.argmax(u != v))
            row = pos if what == "row_offsets" else _first_row(
                x.row_offsets, pos)
            return f"{what} differ first at {pos} (row {row})"
    return None


def order_bound_diff(c: Case, o: Output, y: HostCSR) -> Optional[str]:
    """o's C against y (the same output of another device or package):
    structure equal bit for bit, values within the bound of a sum taken in
    another order (16-bit values are held to the oracle's bound instead, a
    transpose's bit for bit); None when they agree, else where they first
    differ."""
    x = o.c
    diff = same_structure(x, y)
    if diff:
        return diff
    if o.exact is not None:      # a transpose moves values: exactly
        u = np.asarray(x.data, np.float64)
        v = np.asarray(y.data, np.float64)
        if not np.array_equal(u, v):
            pos = int(np.argmax(u != v))
            return (f"values differ first at nnz {pos} (row "
                    f"{_first_row(x.row_offsets, pos)})")
        return None
    if o.ctype in ("float16", "bfloat16"):
        return None
    mag = product_magnitudes(rounded(o.a, c.types[0]),
                             rounded(o.b, c.types[1]))[1]
    if mag.shape[0] != x.nnz:
        return f"the oracle's pattern has {mag.shape[0]} entries, C {x.nnz}"
    err = np.abs(np.asarray(x.data, np.float64)
                 - np.asarray(y.data, np.float64))
    bound = (1e-6 + 1e-5 * mag if o.ctype == "float32"
             else 1e-300 + 1e-12 * mag)
    bad = err > bound
    if bad.any():
        pos = int(np.argmax(bad))
        return (f"values past the sum-order bound at nnz {pos} (row "
                f"{_first_row(x.row_offsets, pos)}): {x.data[pos]!r} against "
                f"{y.data[pos]!r}, bound {bound[pos]:.3g}")
    return None


def oracle_diff(c: Case, o: Output) -> Optional[str]:
    """C against the scipy oracle of the inputs rounded to their types."""
    if o.exact is not None:
        r = compare_csr(o.exact, o.c, compare_data=True, rel_tol=0.0,
                        abs_tol=0.0)
        return None if r.ok else r.message
    ra, rb = rounded(o.a, c.types[0]), rounded(o.b, c.types[1])
    if o.ctype in ("float16", "bfloat16"):
        r = compare_csr_bound(ra, rb, o.c, o.ctype)
    else:
        r = compare_csr(oracle_spgemm(ra, rb), o.c, compare_data=True,
                        rel_tol=2e-3 if o.ctype == "float32" else 1e-9)
    if not np.isfinite(np.asarray(o.c.data, np.float64)).all():
        return "non-finite values in C"
    return None if r.ok else r.message


@dataclasses.dataclass
class Verdict:
    failures: List[str]
    routes: set
    raised: Optional[str]
    deterministic: bool


def check(c: Case, runs: List[Outcome], cpu: Optional[Outcome]) -> Verdict:
    """The checks of one case: ``runs`` are the device's two runs, ``cpu``
    the CPU's (None when the device is the CPU). Two runs of a route in
    ``NONDETERMINISTIC_ROUTES`` may differ in their values, each held to
    the CPU's bound and the oracle; any other difference is a failure."""
    fails = []
    first = runs[0]
    others = runs[1:] + ([cpu] if cpu is not None else [])
    raises = {o.raised for o in [first] + others}
    if len(raises) > 1:
        fails.append(f"raises differ: {sorted(map(str, raises))}")
        return Verdict(fails, set(), None, False)
    if first.raised is not None:
        return Verdict(fails, set(), first.raised, True)
    deterministic = True
    by_design = bool(first.routes & NONDETERMINISTIC_ROUTES)
    held = [first]
    for o in runs[1:]:
        if o.fields != first.fields or o.routes != first.routes:
            fails.append("plan fields differ between two runs")
            deterministic = False
        for x, y in zip(first.outs, o.outs):
            diff = same_bits(x.c, y.c)
            if diff:
                deterministic = False
                if not (by_design and diff.startswith("data")):
                    fails.append(f"two runs differ in {x.label}: {diff}")
                elif all(o is not h for h in held):
                    held.append(o)
    if cpu is not None:
        if cpu.fields != first.fields:
            fails.append(f"plan fields differ from the CPU's: "
                         f"{field_diff(first.fields, cpu.fields)}")
        if cpu.routes != first.routes:
            fails.append(f"routes differ from the CPU's: "
                         f"{sorted(first.routes)} != {sorted(cpu.routes)}")
        for run in held:
            for x, y in zip(run.outs, cpu.outs):
                if x.ctype != y.ctype:
                    fails.append(f"{x.label}: type {x.ctype} against the "
                                 f"CPU's {y.ctype}")
                    continue
                diff = order_bound_diff(c, x, y.c)
                if diff:
                    fails.append(f"{x.label} against the CPU's: {diff}")
    for run in held + ([cpu] if cpu is not None else []):
        for o in run.outs:
            msg = oracle_diff(c, o)
            if msg:
                fails.append(f"{o.label} against the oracle: {msg}")
    return Verdict(fails, first.routes, None, deterministic)


def field_diff(x: list, y: list) -> str:
    """Where two lists of plan fields first differ."""
    if len(x) != len(y):
        return f"{len(x)} plans against {len(y)}"
    for i, (u, v) in enumerate(zip(x, y)):
        if u != v:
            if isinstance(u, dict) and isinstance(v, dict):
                keys = [k for k in u if u.get(k) != v.get(k)]
                return (f"plan {i}: " + "; ".join(
                    f"{k} {u.get(k)!r} != {v.get(k)!r}" for k in keys))
            return f"plan {i}: {u!r} != {v!r}"
    return "equal"


# ---------------------------------------------------------------------------
# The kernels at adversarial shapes
# ---------------------------------------------------------------------------

INT32_MAX = 2 ** 31 - 1
KERNEL_WIDTHS = (1, 2, 31, 32, 33, 4095, 4096, 4097, 8191, 8192, 8193,
                 3 * 8192, (1 << 20) + 1)
K2_PATTERNS = ("equal", "int32_max", "sorted", "reversed", "random",
               "random_max")
K13_PATTERNS = ("one_run", "dead", "sorted", "reversed")
N_COLS = 4096


def _rows_for(W: int) -> int:
    """Rows at width W: R * W across several 4096-, 2048- and 8192-slot
    tiles and off their multiples where W allows, at most ~2^21 slots."""
    return max(1, min((1 << 13) // W + 1, (1 << 21) // W))


def kernel_cases() -> list:
    """(kernel, R, W, pattern, variant) of the adversarial kernel cases:
    K2 at every width and pattern with 0 to 3 payloads in turn; K1 and K3
    at every width and pattern, the value type in turn (K1's rid a plane or
    a per-row broadcast in turn)."""
    out = []
    i = 0
    for W in KERNEL_WIDTHS:
        R = _rows_for(W)
        for p in K2_PATTERNS:
            out.append(("K2", R, W, p, i % 4))
            i += 1
        for p in K13_PATTERNS:
            out.append(("K1", R, W, p, (TYPES[i % 4],
                                        ("plane", "row")[i // 4 % 2])))
            out.append(("K3", R, W, p, TYPES[(i + 1) % 4]))
            i += 1
    return out


def _keys(gen, R: int, W: int, pattern: str, dev) -> torch.Tensor:
    if pattern in ("equal", "one_run"):
        return torch.full((R, W), 7, dtype=torch.int32, device=dev)
    if pattern in ("int32_max", "dead"):
        return torch.full((R, W), INT32_MAX, dtype=torch.int32, device=dev)
    k = torch.randint(0, 1 << 12, (R, W), generator=gen,
                      dtype=torch.int32).to(dev)
    if pattern == "random_max":
        k = torch.where(torch.rand((R, W), generator=gen).to(dev) < 0.25,
                        INT32_MAX, k).to(torch.int32)
    if pattern == "sorted":
        k = torch.sort(k, dim=1).values
    elif pattern == "reversed":
        k = torch.sort(k, dim=1, descending=True).values
    return k.contiguous()


def _values_t(gen, R, W, dtype, dev):
    return torch.randn((R, W), generator=gen, dtype=torch.float64
                       ).to(dtype).to(dev)


def _bits(x: torch.Tensor) -> torch.Tensor:
    return x.view({8: torch.int64, 4: torch.int32, 2: torch.int16,
                   1: torch.uint8}[x.element_size()])


def run_kernel_case(kc, device) -> Optional[str]:
    """One adversarial kernel case on ``device`` against the plain version
    on the same inputs, and a second launch bit for bit; None when it
    holds, else what differs."""
    from .contract_profile import sums_close

    kernel, R, W, pattern, variant = kc
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(
        zlib.crc32(repr((kernel, R, W, pattern)).encode()))
    if kernel == "K2":
        key = _keys(gen, R, W, pattern, dev)
        pays = [torch.randint(-(1 << 30), 1 << 30, (R, W), generator=gen,
                              dtype=torch.int32).to(dev)
                for _ in range(variant)]
        if variant:
            pays[-1] = pays[-1].view(torch.float32)
        k1, p1 = bitonic.row_sort(key, pays)
        k2, p2 = bitonic.row_sort(key, pays)
        kp, pp = bitonic.sort_plain(key, pays)
        if not torch.equal(k1, kp):
            return "keys differ from sort_plain"
        for x, y, z in zip(p1, pp, p2):
            if not torch.equal(_bits(x), _bits(y)):
                return "payloads differ from sort_plain"
            if not torch.equal(_bits(x), _bits(z)):
                return "two launches differ"
        return None if torch.equal(k1, k2) else "two launches differ"
    dtype = variant[0] if kernel == "K1" else variant
    val = _values_t(gen, R, W, _tdtype(dtype), dev)
    col = _keys(gen, R, W, pattern, dev)
    if pattern == "dead":
        col = torch.full((R, W), N_COLS, dtype=torch.int32, device=dev)
    elif pattern != "one_run":
        col = torch.remainder(col, N_COLS).contiguous()
    if kernel == "K1":
        if variant[1] == "row":
            rid = torch.arange(R, dtype=torch.int32, device=dev)[:, None
                                                                 ].expand(R, W)
        else:
            rid = torch.div(_keys(gen, R, W, pattern, dev), 1 << 10,
                            rounding_mode="floor").to(torch.int32)
            if pattern in ("one_run", "dead"):
                rid = torch.zeros((R, W), dtype=torch.int32, device=dev)
            rid = rid.contiguous()

        def fn(v):
            return contract.stream_contract(rid, col, v, N_COLS)

        def plain(v):
            return contract.contract_plain(rid, col, v, N_COLS)
    else:
        def fn(v):
            return contract.contract_runs(col, v, N_COLS)

        def plain(v):
            return contract.contract_runs_plain(col, v, N_COLS)
    l1, s1 = fn(val)
    l2, s2 = fn(val)
    lp, sp_ = plain(val)
    mag = plain(val.abs())[1]
    if not torch.equal(l1, lp):
        return "run-last mask differs from the plain version"
    if not sums_close(s1, sp_, mag):
        return (f"sums differ from the plain version: max abs "
                f"{float((s1.double() - sp_.double()).abs().max()):.3g}")
    if not (torch.equal(l1, l2) and torch.equal(_bits(s1), _bits(s2))):
        return "two launches differ"
    return None


# ---------------------------------------------------------------------------
# The device analysis past 2^24 products
# ---------------------------------------------------------------------------


def _analysis_band():
    return _band(np.random.default_rng(7), 16384, range(-16, 17))


def _analysis_powerlaw():
    return _powerlaw(np.random.default_rng(8), 262144, 262144, 12.0, 2.2)


# A·A past 2^24 products (where a float32 sum rounds, on each device in its
# own order): the band 16384 x 16384 of 33 diagonals (17,827,216 products),
# a power law of config 3's size and law
ANALYSIS_CASES = (("band 16384, 33 diagonals", _analysis_band),
                  ("power law 262144", _analysis_powerlaw))


def run_analysis_case(h: HostCSR, device) -> Optional[str]:
    """The device analysis (``ops.analysis.analyze``) and the routing gate
    (``ops.stream.plan_gate``) of A·A on ``device`` against the exact host
    counts: every row's int32 and float32 count (rounded once), the
    float32 total, and the gate's saturated total, widest row and exact
    total. None when they hold, else what differs."""
    from ..ops.analysis import analyze
    from ..ops.stream import plan_gate

    ops = row_products(h, h)
    A = device_put_csr(h, torch.float32, device=device)
    st = analyze(A, A)
    for what, got, want in (
            ("row_ops", st.row_ops, ops.astype(np.int32)),
            ("row_ops_f", st.row_ops_f, ops.astype(np.float32))):
        got = got.cpu().numpy()
        if not np.array_equal(got, want):
            bad = np.flatnonzero(got != want)
            return (f"{what} differs from the exact count in {bad.size} "
                    f"rows, first row {bad[0]}: {got[bad[0]]} != "
                    f"{ops[bad[0]]}")
    total = float(np.float32(ops.sum()))
    if float(st.sum_products) != total:
        return f"sum_products {float(st.sum_products)} != {total}"
    gate = plan_gate(A.indptr, A.indices, A.indptr, A.indices, st.row_ops,
                     st.row_ops_f, m=h.rows).cpu().numpy()
    sat = 2 ** 31 - 2
    want = (min(int(ops.sum()), sat), min(int(ops.max(initial=0)), sat),
            int(ops.sum()) % 2 ** 32)
    got = (int(gate[4]), int(gate[5]), int(gate[6]) % 2 ** 32)
    if got != want:
        return f"gate (sp_sat, mxrow_sat, sp_exact) {got} != exact {want}"
    return None


# ---------------------------------------------------------------------------
# The sweep
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Report:
    device: str
    cases: int = 0
    kernel_cases: int = 0
    raises: int = 0
    deterministic: int = 0
    failures: List[str] = dataclasses.field(default_factory=list)
    routes: collections.Counter = dataclasses.field(
        default_factory=collections.Counter)
    entries: collections.Counter = dataclasses.field(
        default_factory=collections.Counter)
    # the cases of a route in NONDETERMINISTIC_ROUTES, and those whose two
    # runs differed, by C's value type
    by_design_cases: collections.Counter = dataclasses.field(
        default_factory=collections.Counter)
    by_design: collections.Counter = dataclasses.field(
        default_factory=collections.Counter)
    seconds: float = 0.0
    last_seed: Optional[int] = None

    def summary(self) -> str:
        share = self.deterministic / max(self.cases - self.raises, 1)
        return (f"conformance on {self.device}: {self.cases} cases (seeds to "
                f"{self.last_seed}), {self.kernel_cases} kernel and "
                f"analysis cases; by "
                f"route {dict(sorted(self.routes.items()))}; by entry "
                f"{dict(sorted(self.entries.items()))}; {self.raises} "
                f"raises; deterministic {self.deterministic} of "
                f"{self.cases - self.raises} ({share:.4f}); differing by "
                f"design (the accumulator) "
                f"{dict(sorted(self.by_design.items()))} of "
                f"{dict(sorted(self.by_design_cases.items()))}; "
                f"{len(self.failures)} failures; {self.seconds:.1f} s")


def _fail(report: Report, what: str, lines, out) -> None:
    report.failures.append(what)
    print(f"FAIL {what}", file=out, flush=True)
    for line in lines:
        print(f"  {line}", file=out, flush=True)


def sweep_direct(device, report: Report, out=sys.stdout) -> None:
    """The adversarial kernel cases (``kernel_cases``) and the analysis
    cases (``ANALYSIS_CASES``) on ``device``."""
    for kc in kernel_cases():
        msg = run_kernel_case(kc, device)
        report.kernel_cases += 1
        if msg:
            _fail(report, f"kernel {kc}", [msg], out)
    for name, build in ANALYSIS_CASES:
        msg = run_analysis_case(build(), device)
        report.kernel_cases += 1
        if msg:
            _fail(report, f"analysis of {name}", [msg], out)


def sweep(device="cuda", cases: int = 300, seed: Optional[int] = None,
          seconds: float = float("inf"), kernels: bool = True,
          out=sys.stdout) -> Report:
    """Run the kernel cases, then the cases of seeds ``seed``, ``seed + 1``,
    ... (from the first fixed case by default) on ``device`` until
    ``cases`` have run or ``seconds`` have passed; each case's failures
    are printed as they are found."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    report = Report(device=str(dev) if dev.type == "cpu" else
                    f"{dev} ({torch.cuda.get_device_name(dev)})")
    t0 = time.perf_counter()
    if kernels:
        sweep_direct(dev, report, out)
    s = -len(FIXED) if seed is None else seed
    while report.cases < cases and time.perf_counter() - t0 < seconds:
        c = case(s)
        report.last_seed = s
        s += 1
        report.cases += 1
        report.entries[c.entry] += 1
        try:
            runs = [run_case(c, dev) for _ in range(2)]
            cpu = run_case(c, "cpu") if dev.type != "cpu" else None
            v = check(c, runs, cpu)
        except Exception:        # noqa: BLE001 - reported as a failure
            _fail(report, c.describe(),
                  ["raised:"] + traceback.format_exc().splitlines(), out)
            continue
        report.routes.update(v.routes)
        if v.routes & NONDETERMINISTIC_ROUTES:
            report.by_design_cases[runs[0].outs[0].ctype] += 1
        if v.raised is not None:
            report.raises += 1
        elif v.deterministic:
            report.deterministic += 1
        elif not v.failures:
            report.by_design[runs[0].outs[0].ctype] += 1
        if v.failures:
            _fail(report, c.describe(), v.failures, out)
    report.seconds = time.perf_counter() - t0
    return report


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m speck_tpu_torch.probes.conformance",
        description="The port's seeded conformance sweep on one device.")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--cases", type=int, default=300)
    ap.add_argument("--seed", type=int, default=None,
                    help="the first seed (default: the first fixed case, "
                         f"-{len(FIXED)})")
    ap.add_argument("--seconds", type=float, default=float("inf"))
    args = ap.parse_args(argv)
    report = sweep(args.device, args.cases, args.seed, args.seconds,
                   kernels=args.seed is None)
    print(report.summary(), flush=True)
    return 1 if report.failures else 0


if __name__ == "__main__":
    sys.exit(main())
