"""The expand stage of a stream chunk: each slot's sorted row, its A-slot
record and its product, as (rid, col, val) planes (kernel K4).

``stream_expand`` is the stage, whatever ``stream_expand_impl`` names
(the reference's "fill" and "decode" forms compute the same planes). On
a CUDA tensor it launches the hand-written kernel
``csrc/stream_expand.cu``, once a chunk; on a CPU tensor it runs
``expand_plain``, the torch form (two ``searchsorted`` decodes, the record
window's gathers, one B gather per product). K4 replaces no TPU kernel:
the reference's expand is XLA (the chunk expand of
``speck_tpu/ops/stream.py``), whose torch form issued some 26 launches a
chunk on the card. The kernel computes each slot as the plain version
does, product for product in the same type, so the two agree bit for bit
in all three planes, dead slots included, and two launches agree bit for
bit.

B's operand is the packed (nnz, 2) int32 record of a float32 A (``sa`` the
A value bits) or ``Unpacked`` (``sa`` the A-source map). The unpacked
products take the promoted type of A's and B's values, as torch's
multiply gives it: a 16-bit product is taken in float and rounded once,
float32 and float64 in their own type.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Tuple

import torch

from . import build
from .analysis import _decode
from .bitonic import count_live
from .contract import VALUE_DTYPES

I32 = torch.int32

# launches of the CUDA kernel in this process (the plain version does not
# count), in all and by (G, W, "packed" or "unpacked", product dtype); and
# by the same key, [launches, live slots] of the launches whose caller gave
# the live slots (``live``, a stream chunk's share of the call's products,
# as ``bitonic.LAUNCH_LIVE``'s)
LAUNCHES = 0
LAUNCH_SHAPES: Dict[Tuple[int, int, str, str], int] = {}
LAUNCH_LIVE: Dict[Tuple[int, int, str, str], List[int]] = {}

# the C entry point's type codes (kF32 ... in csrc/stream_expand.cu)
_TYPE_CODE = {torch.float32: 0, torch.float64: 1, torch.bfloat16: 2,
              torch.float16: 3}


class Unpacked(NamedTuple):
    """float64 and 16-bit operands of the expand stage: A's values (read
    through the A-source map on the record channel) and B's columns and
    values, gathered apart (only a float32 A takes the packed record)."""

    a_data: torch.Tensor
    b_indices: torch.Tensor
    b_data: torch.Tensor


def expand_plain(e, p0, su, sa, pend, b_packed, chunk_start: int, sid_base,
                 G: int, W: int, n_cols: int, window: Optional[int] = None):
    """The expand stage for chunk [chunk_start, chunk_start + G*W): each
    slot's sorted row (the last row start e <= t) and its A-slot record
    (the last record start p0 <= t, which is the reference's forward fill
    from the record starts, the winner among equal starts included), live
    while t < that record's pend; then one packed B-record gather per
    live product. ``b_packed`` is the (nnz, 2) int32 record of float32
    values with ``sa`` the A value bits, or ``Unpacked`` operands with
    ``sa`` the A-source map. Returns (rid, col, val); dead slots carry
    col = n_cols and val = 0.

    ``window`` (default G * W) is the slots of the plan's full chunk: the
    records are read from a window of window + 2 of them, which holds
    every record a chunk can meet when they are compacted and all of them
    when they are not (``build_srec(compact=False)`` keeps that many at
    most). The reference sizes the window by the chunk's own G, which
    misses records in a shorter last chunk over uncompacted records."""
    dev = e.device
    CP = G * W
    t = chunk_start + torch.arange(CP, dtype=I32, device=dev).reshape(G, W)
    rid = _decode(e, t)
    nnzA = su.shape[0]
    K = min(nnzA, (window or CP) + 2)
    # window of the records that can intersect this chunk (kept p0 is
    # strictly increasing) plus the run straddling its start
    if K < nnzA:
        widx = torch.clamp(sid_base - 1, 0, nnzA - K) + torch.arange(
            K, dtype=I32, device=dev)
        p0w, uw, aw, pw = p0[widx], su[widx], sa[widx], pend[widx]
    else:
        p0w, uw, aw, pw = p0, su, sa, pend
    rec = _decode(p0w, t)
    has = rec >= 0
    rec = torch.clamp(rec, min=0)
    live = has & (t < pw[rec])
    dead = ~live | (rid < 0)
    bsrc = torch.where(dead, 0, uw[rec] + t)
    if isinstance(b_packed, Unpacked):
        a_data, b_indices, b_data = b_packed
        aval = a_data[torch.clamp(aw[rec], 0, a_data.shape[0] - 1)]
        col = torch.where(dead, n_cols, b_indices[bsrc])
        val = torch.where(dead, 0.0, aval * b_data[bsrc])
        return rid, col.to(I32), val
    bp = b_packed[bsrc.reshape(-1)].reshape(G, W, 2)
    col = torch.where(dead, n_cols, bp[..., 0])
    bval = bp[..., 1].contiguous().view(torch.float32)
    aval = aw[rec].view(torch.float32)
    val = torch.where(dead, 0.0, aval * bval)
    return rid, col.to(I32), val


def _vector(name, x, dtypes, what):
    if (not isinstance(x, torch.Tensor) or x.dim() != 1
            or x.dtype not in dtypes or not x.is_contiguous()):
        raise ValueError(f"stream_expand: {name} must be a contiguous 1-D "
                         f"{what} tensor")


def _check(e, p0, su, sa, pend, b_packed, sid_base, G, W):
    """Raise ValueError for what the kernel does not take (on any device):
    the int32 planes, B's operands, the device scalar sid_base, the
    shape."""
    for name, x in (("e", e), ("p0", p0), ("su", su), ("sa", sa),
                    ("pend", pend)):
        _vector(name, x, (I32,), "int32")
    if not p0.shape == su.shape == sa.shape == pend.shape:
        raise ValueError("stream_expand: p0, su, sa and pend must hold one "
                         "entry a record")
    if isinstance(b_packed, Unpacked):
        _vector("a_data", b_packed.a_data, VALUE_DTYPES, "float")
        _vector("b_indices", b_packed.b_indices, (I32,), "int32")
        _vector("b_data", b_packed.b_data, VALUE_DTYPES, "float")
        if b_packed.b_data.shape != b_packed.b_indices.shape:
            raise ValueError("stream_expand: b_data and b_indices must hold "
                             "one entry a B nonzero")
        operands = tuple(b_packed)
    else:
        if (not isinstance(b_packed, torch.Tensor) or b_packed.dim() != 2
                or b_packed.shape[1] != 2 or b_packed.dtype != I32
                or not b_packed.is_contiguous()):
            raise ValueError("stream_expand: b_packed must be a contiguous "
                             "(nnz, 2) int32 record, or Unpacked operands")
        operands = (b_packed,)
    if (not isinstance(sid_base, torch.Tensor) or sid_base.dim() != 0
            or sid_base.dtype != I32):
        raise ValueError("stream_expand: sid_base must be a 0-d int32 "
                         "tensor")
    if any(x.device != e.device
           for x in (p0, su, sa, pend, sid_base) + operands):
        raise ValueError("stream_expand: tensors on different devices")
    if G < 0 or W < 1:
        raise ValueError("stream_expand: G must be at least 0 and W at "
                         "least 1")


def stream_expand(e, p0, su, sa, pend, b_packed, chunk_start: int, sid_base,
                  G: int, W: int, n_cols: int, window: Optional[int] = None,
                  live: Optional[int] = None):
    """(rid, col, val), each (G, W), of chunk [chunk_start, chunk_start +
    G*W), as ``expand_plain`` computes them.
    ``live``: the chunk's products, where the caller knows them
    (``LAUNCH_LIVE``)."""
    _check(e, p0, su, sa, pend, b_packed, sid_base, G, W)
    if e.device.type == "cpu":
        return expand_plain(e, p0, su, sa, pend, b_packed, chunk_start,
                            sid_base, G, W, n_cols, window)
    if e.device.type != "cuda":
        raise ValueError(f"stream_expand: unsupported device {e.device}")
    CP = G * W
    if chunk_start < 0 or chunk_start + CP > 2 ** 31:
        raise ValueError("stream_expand: the chunk's slots must be int32 "
                         "stream positions")
    unpacked = isinstance(b_packed, Unpacked)
    out_dtype = (torch.promote_types(b_packed.a_data.dtype,
                                     b_packed.b_data.dtype)
                 if unpacked else torch.float32)
    dev = e.device
    rid = torch.empty((G, W), dtype=I32, device=dev)
    col = torch.empty((G, W), dtype=I32, device=dev)
    val = torch.empty((G, W), dtype=out_dtype, device=dev)
    if CP == 0:
        return rid, col, val
    nnz_a = su.shape[0]
    if unpacked:
        a_data, b_indices, b_data = b_packed
        b_args = (None, a_data.data_ptr(), a_data.shape[0],
                  _TYPE_CODE[a_data.dtype], b_indices.data_ptr(),
                  b_data.data_ptr(), _TYPE_CODE[b_data.dtype],
                  b_indices.shape[0])
    else:
        b_args = (b_packed.data_ptr(), None, 0, 0, None, None, 0,
                  b_packed.shape[0])
    lib = build.library()
    # the launch runs on the tensors' card (the current device is the
    # launcher's, which a mesh over several cards does not set)
    with torch.cuda.device(dev):
        err = lib.speck_stream_expand(
            e.data_ptr(), e.shape[0], p0.data_ptr(), su.data_ptr(),
            sa.data_ptr(), pend.data_ptr(), nnz_a,
            min(nnz_a, (window or CP) + 2), sid_base.data_ptr(), *b_args,
            _TYPE_CODE[out_dtype], int(chunk_start), CP, int(n_cols),
            rid.data_ptr(), col.data_ptr(), val.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    build.check(err, "stream_expand launch")
    global LAUNCHES
    LAUNCHES += 1
    shape = (G, W, "unpacked" if unpacked else "packed",
             str(out_dtype).replace("torch.", ""))
    LAUNCH_SHAPES[shape] = LAUNCH_SHAPES.get(shape, 0) + 1
    count_live(LAUNCH_LIVE, shape, live, CP)
    return rid, col, val
