"""speck_tpu_torch — the PyTorch/CUDA port of speck_tpu's SpGEMM.

Computes C = A @ B for CSR sparse matrices with torch tensors, on an
NVIDIA Hopper GPU (hand-written CUDA kernels for the contracts, the row
sorts and the gather probes, ``csrc/``). The entry points run on the first
CUDA card unless the caller passes ``device="cpu"``, which runs the
kernels' plain torch versions; without a card the default raises. It
mirrors ``speck_tpu``'s public names and plans; it imports torch, numpy
and scipy, never jax.

Ported: every single-device route of ``spgemm`` (the product stream with
its wide-row levels and finish, the direct copy, the dense tiles
``ops/dense.py``, the dense-span accumulator, the diagonal-plane routes
``ops/dia.py``), the device transpose (``transpose``), the fixed-cap
expand-sort-contract ``ops.esc.esc_fixed`` with its entry
(``entry.entry``), the gather probes (``probes/``), and the multi-device
layer ``parallel/``: the row mesh (``make_row_mesh``, one controller over
a list of devices, several shards on one card allowed), the row-sharded
stream mesh ``mesh_stream_spgemm`` (all_gather, need-set and overlapped
need-set exchange, the wide-row ladder, two-phase staging, k-split, and
the mesh's diagonal-plane and dense-window routes),
``mesh_spgemm_fixed_cap``, ``distributed_spgemm``, ``multihost_spgemm``
over torch.distributed and ``entry.dryrun_multichip``, and the native host
library ``native/`` (the .mtx parser and writer and the COO->CSR convert
in C++, built with g++ at first use), with every A/B knob of
``SpgemmConfig`` and float16, bfloat16, float32 and float64 values, alike
or mixed. It raises where ``speck_tpu`` raises (TypeError; ROADMAP.md
Queue 3). ``spgemm_scipy`` is the one-call scipy convenience.
"""

from .formats.csr import HostCOO, HostCSR, coo_to_csr, csr_transpose
from .formats.hicsr import load_hicsr, store_hicsr
from .formats.loader import DataLoader, load_matrix
from .formats.mtx import load_mtx
from .ops.device_csr import DeviceCSR, device_get_csr, device_put_csr
from .ops.spgemm import SpgemmPlan, plan_spgemm, spgemm
from .ops.transpose import transpose
from .utils.compare import compare_csr
from .utils.config import Config, ProductOverflow, SpgemmConfig
from .utils.device import DeviceInfo, device_info
from .utils.oracle import oracle_spgemm
from .utils.timings import Timings

__version__ = "0.1.0"


def spgemm_scipy(a, b, dtype=None, cfg=None, device="cuda"):
    """One call, scipy.sparse in and out: ``a @ b`` through the whole
    pipeline (analysis, routing, count, numeric) on ``device`` (the card
    unless the caller passes ``device="cpu"``; without a card the default
    raises), as a ``scipy.sparse.csr_matrix`` with sorted, deduplicated
    rows. ``dtype`` (a torch or numpy float type) defaults to float32, as
    in ``speck_tpu``; bfloat16 values come back as float32 (numpy has no
    bfloat16)."""
    import torch

    dtype = dtype or torch.float32
    A = device_put_csr(HostCSR.from_scipy(a.tocsr()), dtype, device=device)
    B = device_put_csr(HostCSR.from_scipy(b.tocsr()), dtype, device=device)
    return device_get_csr(spgemm(A, B, cfg)).to_scipy()

__all__ = [
    "HostCSR", "HostCOO", "coo_to_csr", "csr_transpose",
    "load_mtx", "load_hicsr", "store_hicsr", "DataLoader", "load_matrix",
    "DeviceCSR", "device_put_csr", "device_get_csr",
    "spgemm", "SpgemmPlan", "plan_spgemm", "ProductOverflow", "transpose",
    "spgemm_scipy",
    "Config", "SpgemmConfig", "Timings", "compare_csr", "oracle_spgemm",
    "DeviceInfo", "device_info",
]
