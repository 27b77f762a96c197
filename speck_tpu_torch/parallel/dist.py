"""Multi-device SpGEMM: A row-partitioned over a row mesh (the port of
``speck_tpu/parallel/dist.py``).

PyTorch has no ``shard_map``, so the port stands in for it with a single
controller over a list of devices, the counterpart of the reference's CI
mesh (8 virtual CPU devices in one process):

- ``make_row_mesh`` returns a ``RowMesh``: the D shards' devices, and the
  shards this process runs (all of them under one controller).
  ``make_row_mesh(4, devices=["cuda:0"])`` puts four shards on one card,
  ``devices=["cpu"]`` on the CPU; the default is every CUDA card, and a
  call for more shards than that raises (it never repeats a card or falls
  back to the CPU unless asked).
- Shard d's tensors live on ``devices[d]``. The reference's per-shard step
  becomes a loop over the local shards, cut at every collective: every
  shard finishes its work before the collective, the collective runs, then
  every shard goes on.
- The collectives are ``all_gather`` and the round-robin ``ppermute``
  (shard s sends to (s + shift) % D), one helper each; ``ppermute_start``
  issues a round and returns at once (the overlapped need-set exchange).
  Within a process they move tensors with ``.to(devices[dst])`` (shards
  on one card share the gathered tensor; a permute there copies nothing).
  Across processes
  (``parallel/multihost.py``) they go through ``torch.distributed``:
  ``all_gather_into_tensor`` (``all_gather`` of a list on gloo) and
  ``batch_isend_irecv``; host metadata moves as CPU tensors over a gloo
  group (``_host_all_gather``). A process runs a contiguous block of
  shards, so a process-level gather lists the shards in order.

Two execution paths live here:

1. ``mesh_spgemm_fixed_cap``: B's row shards all-gathered, then the port's
   fused ESC (``ops.esc.esc_fixed``: kernels K2 and K3) on every shard's
   rows at one global capacity. Legacy: see its deprecation note.
2. ``distributed_spgemm``: the port's ``spgemm`` per device on its A
   slice, B replicated, no cross-device dependency.

``parallel/mesh_stream.py`` holds the stream mesh (``mesh_stream_spgemm``).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..formats.csr import HostCSR
from ..ops.device_csr import (DeviceCSR, device_get_csr, device_put_csr,
                              host_numpy, torch_dtype)
from ..utils.config import SpgemmConfig
from ..utils.device import resolve_device

ROW_AXIS = "rows"

# the gloo group for host metadata across processes (set by
# multihost.initialize; the default group when that is gloo itself)
_HOST_GROUP = None


def _dist():
    import torch.distributed as tdist

    return tdist


def process_count() -> int:
    """Processes in the job: torch.distributed's world size, else 1."""
    tdist = _dist()
    if tdist.is_available() and tdist.is_initialized():
        return tdist.get_world_size()
    return 1


def process_index() -> int:
    tdist = _dist()
    if tdist.is_available() and tdist.is_initialized():
        return tdist.get_rank()
    return 0


@dataclasses.dataclass(frozen=True)
class RowMesh:
    """A one-axis row mesh: shard d runs on ``devices[d]``; this process
    runs the shards in ``local`` (every shard under one controller)."""

    devices: Tuple[torch.device, ...]
    local: Tuple[int, ...]
    process_index: int = 0
    process_count: int = 1

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def axis_names(self):
        return (ROW_AXIS,)

    def key(self):
        """What a cached step depends on of the mesh."""
        return (tuple(str(d) for d in self.devices), self.local,
                self.process_index, self.process_count, self.axis_names)


def _cuda_cards() -> List[torch.device]:
    resolve_device("cuda")      # raises without a card
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_row_mesh(n_devices: Optional[int] = None, devices=None) -> RowMesh:
    """A row mesh of ``n_devices`` shards over ``devices`` (every CUDA card
    by default). A one-device list is repeated to ``n_devices`` (several
    shards on one card, or on the CPU); asking the default list for more
    shards than it has raises."""
    if devices is None:
        devs = _cuda_cards()
        if n_devices is not None and n_devices > len(devs):
            raise ValueError(
                f"make_row_mesh: {n_devices} shards asked for, "
                f"{len(devs)} CUDA card(s) present; pass devices=[...] to "
                "put several shards on one device")
    else:
        devs = [torch.device(d) for d in devices]
        for d in devs:
            if d.type == "cuda":
                resolve_device(d)
        if not devs:
            raise ValueError("make_row_mesh: empty device list")
        if n_devices is not None:
            if len(devs) == 1:
                devs = devs * n_devices
            elif n_devices > len(devs):
                raise ValueError(
                    f"make_row_mesh: {n_devices} shards over "
                    f"{len(devs)} devices; give one device to repeat or "
                    "at least n_devices")
    if n_devices is not None:
        devs = devs[:n_devices]
    return RowMesh(devices=tuple(devs), local=tuple(range(len(devs))))


# ---------------------------------------------------------------------------
# Per-shard tensors and the collectives
# ---------------------------------------------------------------------------


def upload(x, dev: torch.device) -> torch.Tensor:
    """A host array on ``dev``. To a card it goes through pinned memory
    and an asynchronous copy, so the host does not wait for the card (the
    reference's device_put does not either); on the CPU the tensor shares
    the array's memory."""
    t = torch.from_numpy(np.ascontiguousarray(x))
    if dev.type != "cuda":
        return t
    return t.pin_memory().to(dev, non_blocking=True)


def put(mesh: RowMesh, x, live=None) -> Dict[int, torch.Tensor]:
    """A host (D, ...) array as per-shard tensors: shard d's row on
    ``devices[d]``, for the local shards (``upload``). With ``live`` (a
    length per shard) only each row's first live[d] entries are copied to
    the device and the zero padding behind them is made there: the shapes
    stay the common padded ones, the host-to-device bytes are the live
    ones."""
    x = np.asarray(x)
    out = {}
    for d in mesh.local:
        dev = mesh.devices[d]
        if live is None:
            out[d] = upload(x[d], dev)
            continue
        n = int(live[d])
        head = upload(x[d, :n], dev)
        out[d] = head.new_zeros(x.shape[1:])
        out[d][:n] = head
    return out


def _by_device(mesh: RowMesh, parts: Dict[int, torch.Tensor]):
    """The local parts stacked in shard order on the first local device."""
    dev0 = mesh.devices[mesh.local[0]]
    return torch.stack([parts[d].to(dev0) for d in mesh.local])


def _world_gather(mesh: RowMesh, local_stack: torch.Tensor) -> torch.Tensor:
    """(L, ...) per process -> (D, ...) in shard order, over the default
    process group (through the CPU on gloo)."""
    tdist = _dist()
    W = mesh.process_count
    backend = tdist.get_backend()
    dev = local_stack.device
    x = local_stack
    if backend == "gloo" and x.device.type != "cpu":
        x = x.cpu()
    x = x.contiguous()
    if backend == "nccl":
        out = torch.empty((W * x.shape[0],) + tuple(x.shape[1:]),
                          dtype=x.dtype, device=x.device)
        tdist.all_gather_into_tensor(out, x)
    else:
        outs = [torch.empty_like(x) for _ in range(W)]
        tdist.all_gather(outs, x)
        out = torch.cat(outs)
    return out.to(dev)


def all_gather(mesh: RowMesh, parts: Dict[int, torch.Tensor]
               ) -> Dict[int, torch.Tensor]:
    """Every local shard gets the (D, ...) stack of all shards' parts (the
    reference's ``jax.lax.all_gather`` over the row axis). Shards on one
    device share one gathered tensor."""
    if mesh.process_count > 1:
        full = _world_gather(mesh, _by_device(mesh, parts))
        src = {d: full[d] for d in range(mesh.size)}
    else:
        src = parts
    out, by_dev = {}, {}
    for d in mesh.local:
        dev = mesh.devices[d]
        if dev not in by_dev:
            by_dev[dev] = torch.stack([src[s].to(dev)
                                       for s in range(mesh.size)])
        out[d] = by_dev[dev]
    return out


def ppermute(mesh: RowMesh, parts: Dict[int, torch.Tensor], shift: int
             ) -> Dict[int, torch.Tensor]:
    """Shard s's part goes to shard (s + shift) % D (one round of the
    reference's round-robin ``jax.lax.ppermute``)."""
    rnd = ppermute_start(mesh, parts, shift)
    return {d: rnd.wait(d) for d in mesh.local}


# a copy stream a card, for the permutes that cross cards in one process
_COPY_STREAMS: Dict[torch.device, "torch.cuda.Stream"] = {}


def _copy_stream(dev: torch.device):
    if dev not in _COPY_STREAMS:
        _COPY_STREAMS[dev] = torch.cuda.Stream(device=dev)
    return _COPY_STREAMS[dev]


class PermuteRound:
    """One issued ``ppermute_start`` round: ``wait(d)`` gives shard d's
    received part once it has landed, ordering the caller's stream after
    its copy. Only what crosses a card or a process is in flight; a part
    for a shard on the same device is the sent tensor itself."""

    def __init__(self, mesh: RowMesh, out, events, reqs=None, recv=None,
                 ops=None):
        self.mesh, self.out, self.events = mesh, out, events
        # the P2P ops hold the sent tensors until the round has landed
        self.reqs, self.recv, self.ops = reqs, recv or {}, ops

    def wait(self, d: int) -> torch.Tensor:
        if self.reqs:
            for req in self.reqs:
                req.wait()
            self.reqs = self.ops = None
            for dst, buf in self.recv.items():
                self.out[dst] = buf.to(self.mesh.devices[dst])
        ev = self.events.pop(d, None)
        if ev is not None:
            stream = torch.cuda.current_stream(self.mesh.devices[d])
            stream.wait_event(ev)
            self.out[d].record_stream(stream)
        return self.out[d]


def ppermute_start(mesh: RowMesh, parts: Dict[int, torch.Tensor],
                   shift: int) -> PermuteRound:
    """Issue one ppermute round (shard s's part to shard (s + shift) % D)
    and return without waiting for it. Across processes it is one
    ``batch_isend_irecv`` whose handles ``wait`` waits on (tags name the
    round and the source shard, so several rounds may be in flight);
    across cards of one process the copy runs on a copy stream of each
    card and ``wait`` waits on its event, so work queued on the cards
    meanwhile runs beside it."""
    D = mesh.size
    out, events = {}, {}
    if mesh.process_count == 1:
        for s in mesh.local:
            dst = (s + shift) % D
            src, ddev = parts[s], mesh.devices[dst]
            if src.device == ddev or "cuda" not in (src.device.type,
                                                   ddev.type):
                out[dst] = src.to(ddev)
                continue
            s_cs, d_cs = _copy_stream(src.device), _copy_stream(ddev)
            s_cs.wait_stream(torch.cuda.current_stream(src.device))
            with torch.cuda.stream(s_cs), torch.cuda.stream(d_cs):
                out[dst] = src.to(ddev, non_blocking=True)
            src.record_stream(s_cs)
            events[dst] = torch.cuda.Event()
            events[dst].record(d_cs)
        return PermuteRound(mesh, out, events)
    tdist = _dist()
    L = len(mesh.local)
    gloo = tdist.get_backend() == "gloo"
    ops, recv = [], {}
    rnd = (shift % D) * D
    for s in mesh.local:
        dst = (s + shift) % D
        if dst in mesh.local:
            out[dst] = parts[s].to(mesh.devices[dst])
        else:
            x = parts[s].contiguous()
            ops.append(tdist.P2POp(tdist.isend, x.cpu() if gloo else x,
                                   dst // L, tag=rnd + s))
    like = parts[mesh.local[0]]
    for dst in mesh.local:
        s = (dst - shift) % D
        if s not in mesh.local:
            buf = torch.empty_like(like, device="cpu" if gloo
                                   else like.device)
            recv[dst] = buf
            ops.append(tdist.P2POp(tdist.irecv, buf, s // L, tag=rnd + s))
    reqs = tdist.batch_isend_irecv(ops) if ops else None
    return PermuteRound(mesh, out, events, reqs, recv, ops)


def _host_all_gather(x: np.ndarray) -> np.ndarray:
    """(P, ...) stack of every process's host array (gloo, CPU tensors)."""
    tdist = _dist()
    t = torch.as_tensor(np.ascontiguousarray(x))
    outs = [torch.empty_like(t) for _ in range(tdist.get_world_size())]
    tdist.all_gather(outs, t, group=_HOST_GROUP)
    return torch.stack(outs).numpy()


def fetch_global(mesh: RowMesh, parts: Dict[int, torch.Tensor]
                 ) -> np.ndarray:
    """The (D, ...) host array of per-shard parts: ONE device readback of
    this process's shards (stacked on one device first), then a host
    gather across processes."""
    local = host_numpy(_by_device(mesh, parts))
    if mesh.process_count == 1:
        return local
    return _host_all_gather(local).reshape((mesh.size,) + local.shape[1:])


def assemble(mesh: RowMesh, parts: Dict[int, torch.Tensor]) -> torch.Tensor:
    """The global (D * n, ...) tensor of per-shard (n, ...) parts on the
    first local shard's device; shards of other processes are zero (their
    owners hold them; ``fetch_output`` sums them in)."""
    dev0 = mesh.devices[mesh.local[0]]
    like = parts[mesh.local[0]]
    pieces = [parts[d].to(dev0) if d in parts
              else torch.zeros_like(like, device=dev0)
              for d in range(mesh.size)]
    return torch.cat(pieces)


def fetch_output(x) -> np.ndarray:
    """A global output of ``assemble`` on the host, every process's shards
    summed in (each process holds only its own; the rest are zero)."""
    h = host_numpy(x) if hasattr(x, "detach") else np.asarray(x)
    if process_count() == 1:
        return h
    return _host_all_gather(h).sum(axis=0).astype(h.dtype)


# ---------------------------------------------------------------------------
# Host partition helpers
# ---------------------------------------------------------------------------


def partition_rows(m: int, n_shards: int) -> List[Tuple[int, int]]:
    """Contiguous row ranges, balanced to within one row."""
    base, rem = divmod(m, n_shards)
    out = []
    start = 0
    for d in range(n_shards):
        size = base + (1 if d < rem else 0)
        out.append((start, start + size))
        start += size
    return out


@dataclasses.dataclass
class ShardedCSR:
    """C row-partitioned across devices: per-shard local CSR + row ranges."""

    row_ranges: List[Tuple[int, int]]
    shards: List[DeviceCSR]
    shape: Tuple[int, int]

    @property
    def nnz(self) -> int:
        return sum(s.nnz for s in self.shards)

    def to_host(self) -> HostCSR:
        offs = [np.zeros(1, np.int64)]
        cols = []
        vals = []
        base = 0
        for s in self.shards:
            h = device_get_csr(s)
            offs.append(np.asarray(h.row_offsets[1:], np.int64) + base)
            base += h.nnz
            cols.append(h.col_ids)
            vals.append(h.data)
        return HostCSR(
            rows=self.shape[0],
            cols=self.shape[1],
            row_offsets=np.concatenate(offs),
            col_ids=np.concatenate(cols) if cols else np.zeros(0, np.int64),
            data=np.concatenate(vals) if vals else np.zeros(0),
        )


def _slice_rows(a: HostCSR, r0: int, r1: int) -> HostCSR:
    """Host row-slice with rebased offsets."""
    o0, o1 = int(a.row_offsets[r0]), int(a.row_offsets[r1])
    return HostCSR(
        rows=r1 - r0,
        cols=a.cols,
        row_offsets=np.asarray(a.row_offsets[r0:r1 + 1], np.int64) - o0,
        col_ids=a.col_ids[o0:o1],
        data=a.data[o0:o1],
    )


def distributed_spgemm(
    a: HostCSR,
    b: HostCSR,
    devices: Optional[Sequence] = None,
    cfg: Optional[SpgemmConfig] = None,
    dtype=torch.float32,
) -> ShardedCSR:
    """Row-partitioned SpGEMM with per-device independent pipelines (the
    port's ``spgemm`` on each A slice, B replicated per device). The
    default devices are every CUDA card."""
    from ..ops.spgemm import spgemm

    devices = list(devices) if devices is not None else _cuda_cards()
    cfg = cfg or SpgemmConfig()
    ranges = partition_rows(a.rows, len(devices))
    shards: List[DeviceCSR] = []
    for dev, (r0, r1) in zip(devices, ranges):
        A_d = device_put_csr(_slice_rows(a, r0, r1), dtype=dtype, device=dev)
        B_d = device_put_csr(b, dtype=dtype, device=dev)
        shards.append(spgemm(A_d, B_d, cfg))
    return ShardedCSR(row_ranges=ranges, shards=shards, shape=(a.rows, b.cols))


# ---------------------------------------------------------------------------
# Fixed-cap mesh path: an all_gather of B, then esc_fixed per shard.
# ---------------------------------------------------------------------------


def _pad_to(x: np.ndarray, size: int, fill=0) -> np.ndarray:
    out = np.full((size,), fill, dtype=x.dtype)
    out[: x.shape[0]] = x
    return out


def stack_row_shards(a: HostCSR, n_shards: int, dtype=np.float32):
    """Stack per-shard padded CSR arrays: (D, m_loc+1), (D, nnz_max), ...

    Shards are ceil-sized (m_loc = ceil(m / D)) so that global row k sits at
    padded position k exactly (shard k // m_loc, slot k % m_loc); pad rows
    (global index >= m) are empty. This identity layout is what lets the
    gathered B shards be indexed by A's global column ids directly.
    Nonzeros are padded to the max shard nnz (pad column id 0, value 0 —
    never referenced because pad rows are empty)."""
    np_dtype = _np_dtype(dtype)
    m_loc = max(1, -(-a.rows // n_shards))
    ranges = [
        (min(d * m_loc, a.rows), min((d + 1) * m_loc, a.rows))
        for d in range(n_shards)
    ]
    slices = [_slice_rows(a, r0, r1) for r0, r1 in ranges]
    nnz_max = max((s.nnz for s in slices), default=0)
    nnz_max = max(nnz_max, 1)
    indptr = np.stack([
        _pad_to(np.asarray(s.row_offsets, np.int32), m_loc + 1, fill=int(s.nnz))
        for s in slices
    ])
    indices = np.stack([
        _pad_to(np.asarray(s.col_ids, np.int32), nnz_max) for s in slices
    ])
    data = np.stack([
        _pad_to(np.asarray(s.data, np_dtype), nnz_max) for s in slices
    ])
    return indptr, indices, data, ranges


def _np_dtype(dtype):
    """The numpy type a host stack holds ``dtype`` values in: float32, or
    float64 for float64 and the 16-bit types (numpy has no bfloat16; the
    card rounds them once, ``put_values``)."""
    return np.float32 if torch_dtype(dtype) == torch.float32 else np.float64


def put_values(mesh: RowMesh, x, live, dtype) -> Dict[int, torch.Tensor]:
    """``put`` of a host value stack (``_np_dtype``), in ``dtype`` on the
    devices."""
    return {d: v.to(torch_dtype(dtype)) for d, v in put(mesh, x, live).items()}


def mesh_spgemm_fixed_cap(
    a: HostCSR,
    b: HostCSR,
    mesh: RowMesh,
    cap: Optional[int] = None,
    dtype=torch.float32,
):
    """C = A @ B over ``mesh`` at one global row capacity.

    .. deprecated::
        LEGACY path, kept for its tests: the global fixed row cap makes
        every row pay the widest row's rectangle (the skew explosion).
        Use ``parallel.mesh_stream.mesh_stream_spgemm`` — the stream
        formulation with tight packing, the wide-row ladder, k-split
        and need-set exchange.

    A and B are row-sharded over the mesh; every shard all_gathers the B
    row shards, then runs the fused ESC (``esc_fixed``: K2 sorts, K3
    contract) on its local A rows. Returns (counts (D*m_loc,), cols
    (D*m_loc, cap), vals (D*m_loc, cap)) — a padded row-major CSR precursor
    (``padded_to_host_csr``)."""
    from ..ops.esc import esc_fixed

    if a.cols != b.rows:
        raise ValueError(f"dimension mismatch: A is {a.shape}, B is {b.shape}")
    D = mesh.size
    n_cols = b.cols
    if cap is None:
        # global per-row work bound (analysis on host)
        a_len = np.diff(a.row_offsets)
        b_len_h = np.diff(b.row_offsets)
        ops = np.zeros(a.rows, np.int64)
        np.add.at(ops, np.repeat(np.arange(a.rows), a_len), b_len_h[a.col_ids])
        work = int(max(np.maximum(ops, a_len).max(initial=0), 1))
        cap = 1 << (work - 1).bit_length() if work > 1 else 1

    ai, ax, ad, _ = stack_row_shards(a, D, dtype)
    bi, bx, bd, _ = stack_row_shards(b, D, dtype)
    bnnz_max = bx.shape[1]
    # the nonzeros padded to the widest shard: only the live ones cross
    a_live, b_live = ai[:, -1], bi[:, -1]
    A_i = put(mesh, ai)
    A_x, A_d = put(mesh, ax, a_live), put_values(mesh, ad, a_live, dtype)
    # exchange B row shards (the one collective of this path)
    g_indptr = all_gather(mesh, put(mesh, bi))          # (D, k_loc+1)
    g_indices = all_gather(mesh, put(mesh, bx, b_live))
    g_data = all_gather(mesh, put_values(mesh, bd, b_live, dtype))
    counts, cols, vals = {}, {}, {}
    for d in mesh.local:
        gi = g_indptr[d]
        base = torch.arange(D, dtype=torch.int32,
                            device=gi.device)[:, None] * bnnz_max
        b_start = (gi[:, :-1] + base).reshape(-1)
        b_len = (gi[:, 1:] - gi[:, :-1]).reshape(-1)
        counts[d], cols[d], vals[d] = esc_fixed(
            A_i[d], A_x[d], A_d[d], b_start, b_len,
            g_indices[d].reshape(-1), g_data[d].reshape(-1),
            cap=cap, n_cols=n_cols)
    # flatten the shard dim: (D, m_loc, ...) -> (D*m_loc, ...); the trailing
    # pad rows of each shard have count 0
    return assemble(mesh, counts), assemble(mesh, cols), assemble(mesh, vals)


def _numpy(x):
    """A numpy array from a torch tensor (on any device) or an array."""
    if hasattr(x, "detach"):
        return fetch_output(x)
    return np.asarray(x)


def padded_to_host_csr(counts, cols, vals, m: int, n: int) -> HostCSR:
    """Convert the padded row-major output of ``esc_fixed`` or
    ``mesh_spgemm_fixed_cap`` (identity row layout, pad rows at the tail)
    to a HostCSR."""
    counts = _numpy(counts)[:m]
    cols = _numpy(cols)[:m]
    vals = _numpy(vals)[:m]
    offsets = np.zeros(m + 1, np.int64)
    np.cumsum(counts.astype(np.int64), out=offsets[1:])
    width = cols.shape[1] if cols.ndim == 2 else 0
    mask = np.arange(width)[None, :] < counts[:, None]
    return HostCSR(
        rows=m,
        cols=n,
        row_offsets=offsets,
        col_ids=cols[mask],
        data=vals[mask],
    )
