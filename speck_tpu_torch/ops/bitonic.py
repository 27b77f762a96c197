"""The row sort: each row of an int32 key sorted ascending, stably, with up
to three 32-bit payloads permuted the same way. A plane of 16 or 64 bits
moves by its sorted slot: the slot index rides as the payload and the
plane is gathered after the sort (``slot_payload``, ``by_slot``), inside
the range ``speck.values.by_slot`` and counted in ``BY_SLOT``.

``row_sort`` replaces ``speck_tpu``'s Pallas kernel
``bitonic.bitonic_sort_pairs_pallas`` and, for rows of 2^20 and wider,
``bitonic.blocked_sort_pairs``; the module keeps the name of its
counterpart, but the kernel is no longer a network. On a CUDA tensor it
launches ``csrc/row_sort.cu``: a stable radix sort of (key, slot) pairs in
shared memory, one CTA per tile of up to ``TILE`` slots, with as few 8-bit
digit passes as the row's key range needs; rows wider than a tile then
take merge-path passes over device memory. Each payload moves once, by the
sorted slot. On a CPU tensor it runs ``sort_plain``: a stable
``torch.sort`` and a gather of the payloads. Both are stable, so the
kernel's keys and payloads equal the plain version's.

``sort_plan`` is the host side of a launch: the tile width, the number of
merge passes and the scratch planes the wrapper allocates.

The kernel sorts power-of-two widths. A row of another width (the merge
levels under a level factor that is not a power of two: 3 * 8192,
3 * 65536) is padded on the card to the next power of two with INT32_MAX
keys after its last slot and cut back after the sort: a stable sort keeps
every real key, INT32_MAX ones included, before the pad, so keys and
payloads equal the plain sort's. The pad costs the kernel the wider
row's time (4/3 of the slots at 3 * 2^k) and two copies of the planes.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch

from ..utils.timings import span
from . import build

INT32_MAX = 2 ** 31 - 1

# launches of the CUDA kernel in this process (the plain version does not
# count), in all and by (R, W, payloads); and by the same key, [launches,
# live slots] of the launches whose caller gave the live slots (``live``).
# A stream chunk's live slots are its share of the call's products
# (``spgemm.chunk_live``), exact only summed over the call's chunks: read
# the live share over a whole call, not of one shape
LAUNCHES = 0
LAUNCH_SHAPES: Dict[Tuple[int, int, int], int] = {}
LAUNCH_LIVE: Dict[Tuple[int, int, int], List[int]] = {}

# planes of 16 or 64 bits moved by their sorted slot in this process (on
# any device; a 32-bit plane rides the sort and counts nothing): {value
# type: [gathers, slots]}
BY_SLOT: Dict[str, List[int]] = {}

MAX_PAYLOADS = 3
# slots one CTA sorts in shared memory (kMaxTile in csrc/row_sort.cu)
TILE = 8192


class SortPlan(NamedTuple):
    tile: int               # slots a CTA sorts in shared memory
    merge_passes: int       # merge passes over device memory after the tiles
    scratch_shape: Tuple[int, ...]  # int32 (key, slot) planes, () for none


def padded_width(W: int) -> int:
    """The power-of-two width the kernel sorts a row of W slots at."""
    return 1 << (W - 1).bit_length() if W > 1 else 1


def sort_plan(R: int, W: int, n_payloads: int = 0) -> SortPlan:
    """The launch of a (R, W) sort (at ``padded_width(W)``). The payloads
    ride on neither the tiles nor the merges (each moves once at the end),
    so their number changes nothing here. A single merge pass reads one
    (key, slot) plane pair and writes the outputs; more passes alternate
    between two pairs."""
    if n_payloads > MAX_PAYLOADS:
        raise ValueError(f"row_sort: at most {MAX_PAYLOADS} payloads")
    W = padded_width(W)
    tile = min(W, TILE)
    passes = (W // tile).bit_length() - 1
    scratch = (min(passes, 2), 2, R, W) if passes else ()
    return SortPlan(tile, passes, scratch)


def slot_payload(val):
    """The payload that moves ``val`` through ``row_sort``: the plane
    itself when it is 32-bit, else each slot's index in its row (a plane
    of 16 or 64 bits is then gathered after the sort, ``by_slot``)."""
    if val.dtype.itemsize == 4:
        return val.contiguous()
    R, W = val.shape
    return torch.arange(W, dtype=torch.int32, device=val.device).expand(
        R, W).contiguous()


def by_slot(val, moved):
    """``val`` in sorted order from its moved ``slot_payload``; a gather
    inside the range ``speck.values.by_slot``, counted in ``BY_SLOT``
    (no synchronize, no stage of a ``Timings``)."""
    if val.dtype.itemsize == 4:
        return moved
    with span("speck.values.by_slot"):
        out = torch.gather(val, 1, moved.long())
    n = BY_SLOT.setdefault(str(val.dtype).replace("torch.", ""), [0, 0])
    n[0] += 1
    n[1] += moved.numel()
    return out


def sort_plain(key, payloads):
    key_s, perm = torch.sort(key, dim=1, stable=True)
    return key_s, tuple(torch.gather(p, 1, perm) for p in payloads)


def _check(key, payloads):
    if key.dim() != 2 or key.dtype != torch.int32 or not key.is_contiguous():
        raise ValueError("row_sort: key must be a contiguous (R, W) int32 "
                         "tensor")
    if key.shape[1] < 1:
        raise ValueError("row_sort: rows must be at least 1 wide")
    if len(payloads) > MAX_PAYLOADS:
        raise ValueError(f"row_sort: at most {MAX_PAYLOADS} payloads")
    for p in payloads:
        if (p.shape != key.shape or p.dtype not in (torch.int32,
                                                    torch.float32)
                or not p.is_contiguous() or p.device != key.device):
            raise ValueError("row_sort: payloads must be contiguous 32-bit "
                             "tensors shaped like the key")


def count_live(counter: dict, shape: tuple, live: Optional[int],
               slots: int) -> None:
    """Add a launch of ``shape`` with ``live`` of its ``slots`` holding a
    product or a real entry to ``counter`` ([launches, live slots]); a
    launch without a count adds nothing. It never checks the count: a
    counter must not fail a call (the tests hold ``live <= slots``)."""
    if live is None:
        return
    n = counter.setdefault(shape, [0, 0])
    n[0] += 1
    n[1] += int(live)


def row_sort(key: torch.Tensor, payloads: Sequence[torch.Tensor] = (),
             live: Optional[int] = None
             ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, ...]]:
    """Sort each row of ``key`` ascending, stably; permute ``payloads``
    alike. ``live``: the slots that hold a product or a real entry, where
    the caller knows them (``LAUNCH_LIVE``)."""
    payloads = tuple(payloads)
    _check(key, payloads)
    if key.device.type == "cpu":
        return sort_plain(key, payloads)
    if key.device.type != "cuda":
        raise ValueError(f"row_sort: unsupported device {key.device}")
    R, W = key.shape
    if R == 0:
        return torch.empty_like(key), tuple(map(torch.empty_like, payloads))
    Wp = padded_width(W)
    if Wp != W:
        key = _pad_cols(key, Wp, INT32_MAX)
        payloads = tuple(_pad_cols(p, Wp, 0) for p in payloads)
    key_out = torch.empty_like(key)
    outs = tuple(torch.empty_like(p) for p in payloads)
    plan = sort_plan(R, Wp, len(payloads))
    scratch = (torch.empty(plan.scratch_shape, dtype=torch.int32,
                           device=key.device) if plan.merge_passes else None)
    pad = [None] * (MAX_PAYLOADS - len(payloads))
    ins = [p.data_ptr() for p in payloads] + pad
    ptr_out = [p.data_ptr() for p in outs] + pad
    lib = build.library()
    # the launch runs on the key's card (the current device is the
    # launcher's, which a mesh over several cards does not set)
    with torch.cuda.device(key.device):
        err = lib.speck_row_sort(
            key.data_ptr(), key_out.data_ptr(), *ins, *ptr_out,
            len(payloads), R, Wp, plan.tile,
            None if scratch is None else scratch.data_ptr(),
            torch.cuda.current_stream(key.device).cuda_stream)
    build.check(err, "row_sort launch")
    global LAUNCHES
    LAUNCHES += 1
    shape = (R, W, len(payloads))
    LAUNCH_SHAPES[shape] = LAUNCH_SHAPES.get(shape, 0) + 1
    count_live(LAUNCH_LIVE, shape, live, R * W)
    if Wp != W:
        return (key_out[:, :W].contiguous(),
                tuple(p[:, :W].contiguous() for p in outs))
    return key_out, outs


def _pad_cols(x, Wp: int, fill):
    """``x`` (R, W) widened to (R, Wp) with ``fill`` after its last slot."""
    R, W = x.shape
    return torch.cat([x, torch.full((R, Wp - W), fill, dtype=x.dtype,
                                    device=x.device)], dim=1)
