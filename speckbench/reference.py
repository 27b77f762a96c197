"""The plain reference of a call's steps and the comparison that decides
``correct``.

A call is a chain of steps over named operands (``check``; the format is
``operands.py``'s): ``spgemm``, C = A @ B, and ``transpose``. Plain
PyTorch in float64, on the device the run uses. A product runs in blocks
of rows of at most ``BLOCK_PRODUCTS`` products: each block expands its
products, sorts them by (row, column) and sums each run, with the sum of
the products' magnitudes beside it. A transpose is a stable sort of the
entries by column. Each operand carries
a magnitude plane beside its values, the scale of its entries' rounding
error: absent on the inputs, where it stands for ``|v|``; a product's is
``|A| @ |B|`` of its operands' planes, and a transpose moves it with the
values, so that the chain Pt (A P) carries ``|Pt| (|A| |P|)``. It imports
nothing of the program: it is given the inputs' structure and values as
the benchmark made them.

``compare`` holds the program's output to the last step, a product, block
by block, so that no whole reference of it is ever held (the steps before
it are held whole). Two numbers come of it:

- ``struct_rows``: rows of C whose columns differ from the reference's
  (sorted, distinct), or the whole of C where its offsets are unusable.
  The structure is exact, so its limit is 0.
- ``val_err``: the largest ``|c - r| / m`` over the entries of the rows
  whose structure matches, ``r`` the reference's value and ``m`` the sum of
  ``|a| |b|`` over the entry's products (of the operands' magnitude
  planes), the scale of any rounding error. An entry whose products are
  all 0 must be 0.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .inputs import Structure
from .operands import Step, check_steps

BLOCK_PRODUCTS = 1 << 26


@dataclasses.dataclass
class Operand:
    """A CSR matrix on the device, int64 indices, with each entry's row,
    its values and its magnitude plane (None: ``|v|``)."""

    st: Structure
    ip: torch.Tensor
    ix: torch.Tensor
    row: torch.Tensor
    v: torch.Tensor
    m: Optional[torch.Tensor] = None

    @staticmethod
    def of(st: Structure, values: torch.Tensor,
           m: Optional[torch.Tensor] = None) -> "Operand":
        dev = values.device
        ip = torch.as_tensor(st.indptr, device=dev)
        rows = torch.arange(st.rows, device=dev)
        return Operand(st=st, ip=ip,
                       ix=torch.as_tensor(st.indices, device=dev).long(),
                       row=torch.repeat_interleave(rows, ip[1:] - ip[:-1],
                                                   output_size=st.nnz),
                       v=values, m=m)


def product_counts(a: Structure, b: Structure) -> np.ndarray:
    """(nnz(A) + 1,) int64: products before each entry of A, on the host."""
    blen = np.diff(b.indptr)[a.indices]
    out = np.zeros(a.nnz + 1, np.int64)
    np.cumsum(blen, out=out[1:])
    return out


def row_blocks(a: Structure, cs: np.ndarray,
               budget: int = BLOCK_PRODUCTS) -> List[Tuple[int, int]]:
    """Greedy runs of rows of at most ``budget`` products (a row past it
    alone)."""
    cum = cs[a.indptr]
    blocks, r0 = [], 0
    while r0 < a.rows:
        r1 = int(np.searchsorted(cum, cum[r0] + budget, side="right")) - 1
        r1 = min(a.rows, max(r1, r0 + 1))
        blocks.append((r0, r1))
        r0 = r1
    return blocks


def block_product(a: Operand, b: Operand, cs: np.ndarray, r0: int, r1: int):
    """Rows [r0, r1) of A @ B: (entries a row, columns, float64 values,
    float64 magnitudes), columns ascending within each row."""
    dev = a.v.device
    s, t = int(a.st.indptr[r0]), int(a.st.indptr[r1])
    n_prod = int(cs[t] - cs[s])
    k = a.ix[s:t]
    blen = b.ip[k + 1] - b.ip[k]

    def rep(x):
        return torch.repeat_interleave(x, blen, output_size=n_prod)

    src = rep(torch.arange(s, t, device=dev))
    first = torch.cumsum(blen, 0) - blen
    pos = torch.arange(n_prod, device=dev) - rep(first) + rep(b.ip[k])
    del first
    va = a.v[src].double()
    vb = b.v[pos].double()
    ma = va.abs() if a.m is None else a.m[src]
    mb = vb.abs() if b.m is None else b.m[pos]
    key = (a.row[src] - r0) * b.st.cols + b.ix[pos]
    del src, pos
    key, perm = torch.sort(key)
    val = (va * vb)[perm]
    mag = (ma * mb)[perm]
    del va, vb, ma, mb, perm
    new = torch.ones(n_prod, dtype=torch.bool, device=dev)
    new[1:] = key[1:] != key[:-1]
    seg = torch.cumsum(new, 0) - 1
    n_out = int(seg[-1]) + 1 if n_prod else 0
    vals = torch.zeros(n_out, dtype=torch.float64, device=dev).index_add_(
        0, seg, val)
    mags = torch.zeros(n_out, dtype=torch.float64, device=dev).index_add_(
        0, seg, mag)
    ukey = key[new]
    urow = torch.div(ukey, b.st.cols, rounding_mode="floor")
    counts = torch.bincount(urow, minlength=r1 - r0)
    return counts, ukey - urow * b.st.cols, vals, mags


def product(a: Operand, b: Operand, budget: int = BLOCK_PRODUCTS
            ) -> Operand:
    """A @ B whole, in float64, with its magnitude plane."""
    cs = product_counts(a.st, b.st)
    counts, cols, vals, mags = zip(*(block_product(a, b, cs, r0, r1)
                                     for r0, r1 in row_blocks(a.st, cs,
                                                              budget)))
    indptr = np.zeros(a.st.rows + 1, np.int64)
    np.cumsum(torch.cat(counts).cpu().numpy(), out=indptr[1:])
    st = Structure(rows=a.st.rows, cols=b.st.cols, indptr=indptr,
                   indices=torch.cat(cols).int().cpu().numpy())
    return Operand.of(st, torch.cat(vals), torch.cat(mags))


def transpose(a: Operand) -> Operand:
    """A's transpose, in float64, with its magnitude plane: the entries in
    a stable sort by column, so rows ascend within each column."""
    ix, perm = torch.sort(a.ix, stable=True)
    indptr = np.zeros(a.st.cols + 1, np.int64)
    np.cumsum(torch.bincount(ix, minlength=a.st.cols).cpu().numpy(),
              out=indptr[1:])
    st = Structure(rows=a.st.cols, cols=a.st.rows, indptr=indptr,
                   indices=a.row[perm].int().cpu().numpy())
    v = a.v.double()
    m = v.abs() if a.m is None else a.m
    return Operand.of(st, v[perm], m[perm])


def check(c_indptr: torch.Tensor, c_indices: torch.Tensor,
          c_data: torch.Tensor, shape, operands: Dict[str, Operand],
          steps: Sequence[Step], budget: int = BLOCK_PRODUCTS
          ) -> Dict[str, float]:
    """The program's output of ``steps`` over ``operands`` against the
    reference of the last step, the steps before it evaluated whole:
    ``struct_rows`` and ``val_err`` (``compare``)."""
    check_steps(steps, operands)
    env = dict(operands)
    for name, op, *args in steps[:-1]:
        ops = [env[x] for x in args]
        env[name] = (product(*ops, budget) if op == "spgemm"
                     else transpose(*ops))
    a, b = (env[x] for x in steps[-1][2:])
    del env
    return compare(c_indptr, c_indices, c_data, shape, a, b, budget)


def rel_err(c: torch.Tensor, r: torch.Tensor, m: torch.Tensor) -> float:
    """max |c - r| / m; an entry with m == 0 reads 0 if c == r, else inf;
    a NaN reads inf."""
    if c.numel() == 0:
        return 0.0
    d = (c - r).abs()
    err = torch.where(m > 0, d / torch.where(m > 0, m, 1.0),
                      torch.where(d == 0, 0.0, math.inf))
    return float(torch.nan_to_num(err, nan=math.inf, posinf=math.inf).max())


def compare(c_indptr: torch.Tensor, c_indices: torch.Tensor,
            c_data: torch.Tensor, shape, a: Operand, b: Operand,
            budget: int = BLOCK_PRODUCTS) -> Dict[str, float]:
    """The program's C (its offsets, columns and values) against the
    reference of A @ B: ``struct_rows`` and ``val_err``."""
    m = a.st.rows
    dev = a.v.device
    ip = c_indptr.to(dev).long()
    usable = (tuple(shape) == (m, b.st.cols) and ip.shape == (m + 1,)
              and int(ip[0]) == 0 and bool((ip[1:] >= ip[:-1]).all())
              and int(ip[-1]) <= c_indices.shape[0] <= c_data.shape[0])
    if not usable:
        return {"struct_rows": m, "val_err": math.inf}
    ip_h = ip.cpu().numpy()
    cs = product_counts(a.st, b.st)
    bad_rows, val_err = 0, 0.0
    for r0, r1 in row_blocks(a.st, cs, budget):
        counts, cols, vals, mags = block_product(a, b, cs, r0, r1)
        s, t = int(ip_h[r0]), int(ip_h[r1])
        c_cnt = ip[r0 + 1:r1 + 1] - ip[r0:r1]
        c_col = c_indices[s:t].to(dev).long()
        c_val = c_data[s:t].to(dev).double()
        good = c_cnt == counts
        rows = torch.arange(r1 - r0, device=dev)
        r_row = torch.repeat_interleave(rows, counts, output_size=cols.shape[0])
        c_row = torch.repeat_interleave(rows, c_cnt, output_size=t - s)
        rsel, csel = good[r_row], good[c_row]
        col_ok = c_col[csel] == cols[rsel]
        good[r_row[rsel][~col_ok]] = False
        bad_rows += int((~good).sum())
        val_err = max(val_err, rel_err(c_val[csel][col_ok],
                                       vals[rsel][col_ok],
                                       mags[rsel][col_ok]))
        del counts, cols, vals, mags, c_col, c_val, r_row, c_row
    return {"struct_rows": bad_rows, "val_err": val_err}
