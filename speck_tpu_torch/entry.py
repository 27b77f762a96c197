"""The port's counterpart of the repository's ``__graft_entry__.entry()``:
the fused expand-sort-contract SpGEMM (``ops.esc.esc_fixed``) with seeded
example arguments.

    fn, args = entry()            # tensors on the first CUDA card
    counts, cols, vals = fn(*args)
"""

from __future__ import annotations

import numpy as np
import torch

from .formats.csr import HostCSR
from .utils.device import resolve_device


def _example_matrices(m=64, k=64, n=64, density=0.1, seed=7):
    """The same seeded scipy matrices as ``__graft_entry__``."""
    import scipy.sparse as sp

    rs = np.random.RandomState(seed)
    a = sp.random(m, k, density, format="csr", random_state=rs)
    a.data = rs.standard_normal(a.nnz)
    b = sp.random(k, n, density, format="csr", random_state=rs)
    b.data = rs.standard_normal(b.nnz)
    return HostCSR.from_scipy(a), HostCSR.from_scipy(b)


def fixed_cap(a: HostCSR, b: HostCSR) -> int:
    """The fixed-cap rule of the JAX mesh path: the next power of two of
    the largest per-row max(products, A length), at least 1."""
    a_len = np.diff(np.asarray(a.row_offsets, np.int64))
    b_len = np.diff(np.asarray(b.row_offsets, np.int64))
    ops = np.zeros(a.rows, np.int64)
    np.add.at(ops, np.repeat(np.arange(a.rows), a_len),
              b_len[np.asarray(a.col_ids, np.int64)])
    work = int(max(np.maximum(ops, a_len).max(initial=0), 1))
    return 1 << (work - 1).bit_length() if work > 1 else 1


def esc_args(a: HostCSR, b: HostCSR, device, dtype=np.float32):
    """``esc_fixed``'s seven arguments for A and B on ``device``: A's CSR,
    then B as per-row (start, length) and its columns and values, the
    values in ``dtype`` (float32 or float64)."""
    device = resolve_device(device)

    def put(x, dt):
        return torch.as_tensor(np.ascontiguousarray(x, dtype=dt),
                               device=device)

    bp = np.asarray(b.row_offsets, np.int32)
    return (put(a.row_offsets, np.int32), put(a.col_ids, np.int32),
            put(a.data, dtype), put(bp[:-1], np.int32),
            put(bp[1:] - bp[:-1], np.int32), put(b.col_ids, np.int32),
            put(b.data, dtype))


def entry(device=None):
    """(fn, example_args): ``esc_fixed`` at cap 256 on the example matrices,
    the arguments on ``device`` (the first CUDA card unless ``"cpu"``)."""
    from .ops.esc import esc_fixed

    a, b = _example_matrices()
    cap, n_cols = 256, b.cols

    def fn(a_indptr, a_indices, a_data, b_start, b_len, b_indices, b_data):
        return esc_fixed(a_indptr, a_indices, a_data, b_start, b_len,
                         b_indices, b_data, cap=cap, n_cols=n_cols)

    return fn, esc_args(a, b, device)


def dryrun_inputs(n_devices: int):
    """The dryrun's products, made as ``__graft_entry__`` makes them (the
    same seeds), in its order: {step: (a, b, cfg, exchange)} for "needset"
    and "allgather" (the example matrices on the stream), "dense" (the
    example matrices under allgather with the default config: the mesh
    dense route), "block-diagonal" (n_devices blocks of 8 rows, need-set),
    "overlap" (the example matrices under
    ``exchange="needset_overlap"``) and "k-split" (a dense row 3 above a
    lowered split threshold, need-set)."""
    import scipy.sparse as sp

    from .utils.config import SpgemmConfig

    a, b = _example_matrices(m=48, k=40, n=32, density=0.15)
    # EnableDense=false pins the stream in both exchange modes
    cfg = SpgemmConfig(mesh_exchange_auto=False, enable_dense=False)
    rs = np.random.RandomState(11)
    blk = sp.block_diag(
        [sp.random(8, 8, 0.6, format="csr", random_state=rs)
         for _ in range(n_devices)], format="csr")
    blk.data = rs.standard_normal(blk.nnz)
    ab = HostCSR.from_scipy(blk)
    lil = sp.random(40, 40, 0.1, format="csr", random_state=rs).tolil()
    lil[3, :] = rs.standard_normal(40)
    ak = HostCSR.from_scipy(lil.tocsr())
    cfgk = SpgemmConfig(stream_width=64, product_budget=1 << 12,
                        mesh_split_min_ops=60, mesh_exchange_auto=False)
    return {"needset": (a, b, cfg, "needset"),
            "allgather": (a, b, cfg, "allgather"),
            "dense": (a, b, None, "allgather"),
            "block-diagonal": (ab, ab, None, "needset"),
            "overlap": (a, b, None, "needset_overlap"),
            "k-split": (ak, ak, cfgk, "needset")}


def dryrun_multichip(n_devices: int, devices=None) -> str:
    """The port's counterpart of the repository's
    ``__graft_entry__.dryrun_multichip``: the stream mesh over an
    ``n_devices`` row mesh (``devices`` as ``parallel.make_row_mesh``
    takes them: every CUDA card by default, or one device repeated) on
    the tiny products of ``dryrun_inputs``, each checked against the host
    oracle, and the reference's summary line printed (and returned).

    It runs the need-set and all_gather exchanges on the stream, the mesh
    dense route, the block-diagonal need-set product (zero communication),
    the overlapped need-set exchange and the k-split of a row above a
    lowered threshold."""
    from .parallel import (make_row_mesh, mesh_stream_spgemm,
                           mesh_stream_to_host_csr)
    from .utils.compare import compare_csr
    from .utils.oracle import oracle_spgemm

    mesh = make_row_mesh(n_devices, devices=devices)
    assert mesh.size == n_devices, (
        f"wanted {n_devices} devices, mesh has {mesh.size}")
    meta, nnz = {}, {}
    for step, (a, b, cfg, exchange) in dryrun_inputs(n_devices).items():
        out = mesh_stream_spgemm(a, b, mesh, exchange=exchange, cfg=cfg)
        meta[step] = out[3]
        got = mesh_stream_to_host_csr(*out)
        res = compare_csr(oracle_spgemm(a, b), got, compare_data=True,
                          rel_tol=1e-2)
        assert res.ok, f"mesh_stream {step} mismatch: {res.message}"
        nnz[step] = got.nnz
    for step in ("needset", "allgather"):
        assert meta[step]["route"] == "stream", meta[step]["route"]
    # tile-bounded inputs under allgather run the dense window products
    assert meta["dense"]["route"] == "dense", meta["dense"]["route"]
    # block-diagonal input: each shard's A references only its own B rows,
    # so every non-self round is empty and no bytes move
    st, st_b = meta["needset"]["stats"], meta["block-diagonal"]["stats"]
    assert st_b.needset_bytes < st_b.allgather_bytes, (
        st_b.needset_bytes, st_b.allgather_bytes)
    # k-split single-row sharding: a row above the (lowered) threshold
    # computes as per-B-shard partials merged by all_gather
    ksm = meta["k-split"]["ksplit"]
    assert ksm is not None and ksm["n_split"] >= 1 \
        and 3 in ksm["split_ids"], f"k-split plan did not engage: {ksm}"

    bd_comm = ("ZERO-COMM" if st_b.zero_comm
               else f"reduction {st_b.reduction:.1f}x")
    line = (f"dryrun_multichip({n_devices}): OK, nnz(C)={nnz['allgather']}, "
            f"needset bytes {st.needset_bytes} vs allgather "
            f"{st.allgather_bytes}; block-diag needset "
            f"{st_b.needset_bytes} vs {st_b.allgather_bytes} ({bd_comm}); "
            f"dense route OK; overlap OK; k-split engaged "
            f"(n_split={ksm['n_split']})")
    print(line)
    return line
