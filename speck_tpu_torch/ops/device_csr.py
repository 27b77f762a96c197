"""Device-resident CSR container (torch tensors, int32 indices).

int32 indices throughout: torch's int64 default would double the bytes of
every index sort and gather. ``device_put_csr`` keeps the source HostCSR
reachable from its DeviceCSR (``attach_host``/``host_of``) so planning can
run the analysis and the routing gates on host numpy with no device sync.
"""

from __future__ import annotations

import dataclasses
import weakref
from typing import Optional, Tuple

import numpy as np
import torch

from ..formats.csr import HostCSR
from ..utils.device import resolve_device

_NP_TO_TORCH = {np.dtype(np.float16): torch.float16,
                np.dtype(np.float32): torch.float32,
                np.dtype(np.float64): torch.float64}


def host_numpy(t: torch.Tensor) -> np.ndarray:
    """A tensor on the host as numpy; bfloat16, which numpy lacks, as the
    float32 holding the same values."""
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def torch_dtype(dtype) -> torch.dtype:
    """A torch dtype from a torch or numpy float dtype."""
    if isinstance(dtype, torch.dtype):
        return dtype
    return _NP_TO_TORCH[np.dtype(dtype)]


@dataclasses.dataclass(frozen=True, eq=False)
class DeviceCSR:
    indptr: torch.Tensor   # (rows+1,) int32
    indices: torch.Tensor  # (nnz,)   int32
    data: torch.Tensor     # (nnz,)   float
    shape: Tuple[int, int]
    nnz: int
    canonical: bool = False  # columns strictly ascending within each row

    @property
    def rows(self) -> int:
        return self.shape[0]

    @property
    def cols(self) -> int:
        return self.shape[1]

    @property
    def dtype(self):
        return self.data.dtype

    @property
    def device(self) -> torch.device:
        return self.indptr.device


_HOST_SIDE: dict = {}


def attach_host(d: DeviceCSR, h: HostCSR) -> None:
    _HOST_SIDE[id(d)] = h
    weakref.finalize(d, _HOST_SIDE.pop, id(d), None)


def host_of(d: DeviceCSR) -> Optional[HostCSR]:
    """The HostCSR ``d`` was uploaded from, if still attached (matrices
    born on the device, such as a previous spgemm's output, have none)."""
    return _HOST_SIDE.get(id(d))


def is_canonical_host(row_offsets, col_ids) -> bool:
    """True if columns are strictly ascending within every row."""
    col_ids = np.asarray(col_ids, np.int64)
    if col_ids.shape[0] < 2:
        return True
    nondesc = col_ids[1:] > col_ids[:-1]
    starts = np.asarray(row_offsets[1:-1], np.int64)
    nondesc[starts[(starts > 0) & (starts < col_ids.shape[0])] - 1] = True
    return bool(nondesc.all())


def device_put_csr(m: HostCSR, dtype=torch.float32, device="cuda",
                   check_canonical: bool = True) -> DeviceCSR:
    """Upload a HostCSR to ``device`` (int32 indices, ``dtype`` values);
    ``device="cpu"`` asks for the CPU."""
    device = resolve_device(device)

    def put(x, dt):
        return torch.as_tensor(np.ascontiguousarray(x, dtype=dt),
                               device=device)

    d = DeviceCSR(
        indptr=put(m.row_offsets, np.int32),
        indices=put(m.col_ids, np.int32),
        data=torch.as_tensor(np.asarray(m.data), device=device).to(
            torch_dtype(dtype)),
        shape=(int(m.rows), int(m.cols)),
        nnz=int(m.nnz),
        canonical=(is_canonical_host(m.row_offsets, m.col_ids)
                   if check_canonical else False),
    )
    attach_host(d, m)
    return d


def device_get_csr(m: DeviceCSR) -> HostCSR:
    """Download a DeviceCSR to a host CSR (one device->host copy each;
    bfloat16 values arrive as float32, ``host_numpy``)."""
    return HostCSR(
        rows=m.shape[0],
        cols=m.shape[1],
        row_offsets=m.indptr.cpu().numpy(),
        col_ids=m.indices[: m.nnz].cpu().numpy(),
        data=host_numpy(m.data[: m.nnz]),
    )
