"""Multi-process SpGEMM (the port of ``speck_tpu/parallel/multihost.py``).

Every process calls ``initialize()`` once, then every process calls
``multihost_spgemm`` with the SAME host matrices (or its own RowShards):
the global mesh spans every process's devices, each process runs the
shards its devices own, and the collectives of ``parallel/dist.py`` go
through ``torch.distributed``: NCCL for device tensors when every process
of a node has a card of its own, gloo on the CPU or when asked, and gloo
always for the host metadata.

With one process this is exactly ``mesh_stream_spgemm`` over the local
mesh.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..formats.csr import HostCSR
from . import dist as _dist


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               backend: Optional[str] = None) -> None:
    """Initialize torch.distributed (idempotent): ``coordinator_address``
    is "host:port" of process 0 (``tcp://`` is added), else the env://
    variables (without either, one process, and nothing is done).

    The backend defaults to gloo without CUDA cards. With cards it is NCCL
    when every process of this node has a card of its own: the node's
    process count is ``LOCAL_WORLD_SIZE`` (as torchrun sets it), and
    without it, or with more processes than cards on the node, the call
    raises rather than move card tensors through the host; pass
    ``backend`` to choose. A process takes the card ``LOCAL_RANK`` (else
    its rank modulo the node's cards). A gloo group for host metadata is
    made beside an NCCL one."""
    import os

    import torch.distributed as tdist

    if (not tdist.is_initialized() and coordinator_address is None
            and "MASTER_ADDR" not in os.environ):
        return      # one process and no job around it: nothing to join
    if not tdist.is_initialized():
        if backend is None:
            backend = _default_backend(os.environ.get("LOCAL_WORLD_SIZE"))
        kw = {}
        if coordinator_address is not None:
            addr = coordinator_address
            kw["init_method"] = (addr if "://" in addr else f"tcp://{addr}")
        if num_processes is not None:
            kw["world_size"] = num_processes
        if process_id is not None:
            kw["rank"] = process_id
        if backend == "nccl":
            rank = (process_id if process_id is not None
                    else int(os.environ.get("RANK", 0)))
            torch.cuda.set_device(_local_card(rank))
        tdist.init_process_group(backend=backend, **kw)
    if _dist._HOST_GROUP is None:
        _dist._HOST_GROUP = (tdist.new_group(backend="gloo")
                             if tdist.get_backend() != "gloo"
                             else tdist.group.WORLD)


def _local_card(rank: int) -> int:
    """This process's card: ``LOCAL_RANK`` (as torchrun sets it), else its
    rank, modulo the node's cards."""
    import os

    return (int(os.environ.get("LOCAL_RANK", rank))
            % torch.cuda.device_count())


def _default_backend(local_world_size: Optional[str]) -> str:
    """gloo without CUDA cards; NCCL when this node's processes
    (``local_world_size``) each have a card of their own; else raises."""
    if not torch.cuda.is_available():
        return "gloo"
    cards = torch.cuda.device_count()
    if local_world_size is None:
        raise ValueError(
            "multihost.initialize: CUDA cards are present but the number "
            "of processes on this node is unknown; set LOCAL_WORLD_SIZE or "
            "pass backend='nccl' (a card per process) or 'gloo'")
    if int(local_world_size) > cards:
        raise ValueError(
            f"multihost.initialize: {local_world_size} processes on this "
            f"node share {cards} CUDA card(s), and NCCL takes one process "
            "per card; pass backend='gloo' to move card tensors through "
            "the host")
    return "nccl"


def global_row_mesh(devices=None, n_local: int = 1) -> "_dist.RowMesh":
    """One-axis mesh over every process's devices: this process's shards
    are ``devices`` (default: under several processes ``n_local`` shards
    on its own CUDA card, which becomes its current card, whatever the
    backend; every CUDA card under one), the same count on every process,
    in process order."""
    P = _dist.process_count()
    if P == 1:
        return _dist.make_row_mesh(devices=devices)
    if devices is None:
        _dist.resolve_device("cuda")
        card = _local_card(_dist.process_index())
        torch.cuda.set_device(card)
        devices = [torch.device("cuda", card)] * n_local
    local = _dist.make_row_mesh(devices=devices)
    L, p = local.size, _dist.process_index()
    return _dist.RowMesh(devices=tuple(local.devices) * P,
                         local=tuple(range(p * L, (p + 1) * L)),
                         process_index=p, process_count=P)


def local_row_range(m: int):
    """The contiguous row range this process owns under an even row
    partition of an m-row matrix across processes."""
    ranges = _dist.partition_rows(m, _dist.process_count())
    return ranges[_dist.process_index()]


def multihost_spgemm(
    a: HostCSR,
    b: HostCSR,
    cfg=None,
    exchange: str = "needset",
    mesh=None,
):
    """C = A @ B across every device of every process in the job.

    Every process passes the same full host matrices (or its own
    RowShards); the stream step runs over the global mesh (``mesh``, else
    ``global_row_mesh()``). With one process this is exactly
    ``mesh_stream_spgemm``. Returns (nnz_row, cols, vals, meta);
    assemble with ``mesh_stream_to_host_csr`` (every process gets the
    whole matrix)."""
    from .mesh_stream import mesh_stream_spgemm

    mesh = mesh or global_row_mesh()
    return mesh_stream_spgemm(a, b, mesh, cfg=cfg, exchange=exchange)


def scaling_efficiency(t1: float, tn: float, n_hosts: int) -> float:
    """T(1) / (T(N) * N) — the multi-host scaling metric."""
    return t1 / (tn * n_hosts) if tn > 0 and n_hosts > 0 else 0.0
