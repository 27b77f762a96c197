"""Gather probes on the card: the port of ``scripts/gather_microbench2.py``.

``sublane_gather`` (out[i, l] = tab[idx[i, l], l], the script's Pallas
``run`` at :143) and ``run_copy`` (out[(g*K + k)*L + j] = src[offs[g, k] +
j], its Pallas ``runf`` at :195, and ``expand_microbench.py``'s
``run_pallas`` at :121) launch the CUDA kernels of ``csrc/gather_probes.cu``
on CUDA tensors and run their plain torch versions on CPU tensors.

``main()`` times on the card, with plain torch, the script's XLA-side
measurements (a: 4 B and 8 B random gathers; b: slice gathers; c: the
table-size sweep; d: a 2-D output), then the two kernels beside their plain
versions, one line each with the card's name and power limit:

    python -m speck_tpu_torch.probes.gather_microbench2
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import build

# launches of the CUDA kernels in this process (the plain versions do not
# count)
LAUNCHES = {"sublane_gather": 0, "run_copy": 0}

LANES = 128
# the kernel stages S x 8 lanes x 4 B of the table in one block's shared
# memory (227 KB on Hopper)
MAX_TABLE_ROWS = 232448 // (8 * 4)


def sublane_gather_plain(idx, tab):
    return torch.gather(tab, 0, idx.long())


def sublane_gather(idx, tab):
    """out[i, l] = tab[idx[i, l], l] for idx (rows, 128) int32 and tab
    (S, 128) float32. On the card an index outside [0, S) gives 0. The
    kernel needs 16-byte aligned planes (as the allocator gives them)."""
    if (idx.dim() != 2 or idx.shape[1] != LANES or idx.dtype != torch.int32
            or not idx.is_contiguous()):
        raise ValueError("sublane_gather: idx must be a contiguous "
                         "(rows, 128) int32 tensor")
    if (tab.dim() != 2 or tab.shape[1] != LANES
            or tab.dtype != torch.float32 or not tab.is_contiguous()):
        raise ValueError("sublane_gather: tab must be a contiguous (S, 128) "
                         "float32 tensor")
    S = tab.shape[0]
    if not 1 <= S <= MAX_TABLE_ROWS:
        raise ValueError(f"sublane_gather: the table must have 1 to "
                         f"{MAX_TABLE_ROWS} rows, not {S}")
    if idx.device != tab.device:
        raise ValueError("sublane_gather: tensors on different devices")
    if idx.device.type == "cpu":
        return sublane_gather_plain(idx, tab)
    if idx.device.type != "cuda":
        raise ValueError(f"sublane_gather: unsupported device {idx.device}")
    if idx.data_ptr() % 16 or tab.data_ptr() % 16:
        raise ValueError("sublane_gather: planes must start on a 16-byte "
                         "boundary")
    out = torch.empty(idx.shape, dtype=torch.float32, device=idx.device)
    if idx.shape[0] == 0:
        return out
    err = build.library().speck_sublane_gather(
        idx.data_ptr(), tab.data_ptr(), out.data_ptr(), idx.shape[0], S,
        torch.cuda.current_stream(idx.device).cuda_stream)
    build.check(err, "sublane_gather launch")
    LAUNCHES["sublane_gather"] += 1
    return out


def run_copy_plain(offs, src, L: int):
    j = torch.arange(L, dtype=torch.int64, device=src.device)
    return src[(offs.long()[..., None] + j).reshape(-1)]


def run_copy(offs, src, L: int):
    """out[(g*K + k)*L + j] = src[offs[g, k] + j] for offs (G, K) int32,
    src 1-D float32 and L a multiple of 128; every offset must lie in
    [0, src.numel() - L]."""
    if offs.dim() != 2 or offs.dtype != torch.int32 or \
            not offs.is_contiguous():
        raise ValueError("run_copy: offs must be a contiguous (G, K) int32 "
                         "tensor")
    if src.dim() != 1 or src.dtype != torch.float32 or \
            not src.is_contiguous():
        raise ValueError("run_copy: src must be a contiguous 1-D float32 "
                         "tensor")
    if L < LANES or L % LANES:
        raise ValueError(f"run_copy: L must be a multiple of 128, not {L}")
    if src.numel() < L:
        raise ValueError("run_copy: src is shorter than one run")
    if offs.device != src.device:
        raise ValueError("run_copy: tensors on different devices")
    if src.device.type == "cpu":
        return run_copy_plain(offs, src, L)
    if src.device.type != "cuda":
        raise ValueError(f"run_copy: unsupported device {src.device}")
    if src.data_ptr() % 16:
        raise ValueError("run_copy: src must start on a 16-byte boundary")
    out = torch.empty(offs.numel() * L, dtype=torch.float32,
                      device=src.device)
    if offs.numel() == 0:
        return out
    err = build.library().speck_run_copy(
        offs.data_ptr(), src.data_ptr(), out.data_ptr(), offs.numel(), L,
        torch.cuda.current_stream(src.device).cuda_stream)
    build.check(err, "run_copy launch")
    LAUNCHES["run_copy"] += 1
    return out


def main():
    from ..utils.device import resolve_device
    from .timing import card, cuda_ms, report

    dev = resolve_device(None)
    smi = card()
    N = 1 << 22                  # 4.19M outputs
    NB = 1 << 21                 # 2M-entry table
    rs = np.random.RandomState(0)
    put = lambda x: torch.as_tensor(x, device=dev)  # noqa: E731
    idx = put(rs.randint(0, NB - 256, N).astype(np.int32))
    tab1 = put(rs.standard_normal(NB).astype(np.float32))
    tab2 = put(rs.randint(0, 1 << 30, (NB, 2)).astype(np.int32))

    # a. 4 B against 8 B records
    report("a_4B_random", cuda_ms(lambda: tab1[idx]), N, N * 4, smi)
    report("a_8B_random", cuda_ms(lambda: tab2[idx]), N, N * 8, smi)
    # b. slice gathers: N / L slices of L
    for L in (16, 128, 512):
        sidx = put(rs.randint(0, NB - L - 1, (N // L, 1)).astype(np.int32))
        j = torch.arange(L, dtype=torch.int32, device=dev)
        report(f"b_slice{L}_x{N // L}", cuda_ms(lambda: tab1[sidx + j]), N,
               N * 4, smi)
    # c. table-size sweep
    for tb in (1 << 14, 1 << 18):
        tabs = tab1[:tb]
        idxs = put(rs.randint(0, tb, N).astype(np.int32))
        report(f"c_4B_table{tb * 4 // 1024}KB", cuda_ms(lambda: tabs[idxs]),
               N, N * 4, smi)
    # d. a (512, N / 512) output
    idx2 = idx.reshape(512, -1)
    report("d_4B_out2D_512xW", cuda_ms(lambda: tab1[idx2]), N, N * 4, smi)

    # e. the sublane gather kernel, table (2048, 128) f32 = 1 MB
    S = 2048
    tabv = put(rs.standard_normal((S, LANES)).astype(np.float32))
    gidx = put(rs.randint(0, S, (N // LANES, LANES)).astype(np.int32))
    if not torch.equal(sublane_gather(gidx, tabv),
                       sublane_gather_plain(gidx, tabv)):
        raise RuntimeError("sublane_gather differs from its plain version")
    report("e_sublane_gather_kernel",
           cuda_ms(lambda: sublane_gather(gidx, tabv)), N, N * 8, smi)
    report("e_sublane_gather_plain",
           cuda_ms(lambda: sublane_gather_plain(gidx, tabv)), N, N * 8, smi)

    # f. the run copy kernel: G x K runs of L f32 from dynamic offsets
    G, K, L = 512, 64, 128
    offs = put(rs.randint(0, NB - L, (G, K)).astype(np.int32))
    if not torch.equal(run_copy(offs, tab1, L),
                       run_copy_plain(offs, tab1, L)):
        raise RuntimeError("run_copy differs from its plain version")
    report("f_run_copy128_kernel", cuda_ms(lambda: run_copy(offs, tab1, L)),
           G * K * L, G * K * L * 8, smi)
    report("f_run_copy128_plain",
           cuda_ms(lambda: run_copy_plain(offs, tab1, L)), G * K * L,
           G * K * L * 8, smi)


if __name__ == "__main__":
    main()
