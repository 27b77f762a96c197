"""The row mesh across processes: ``multihost_spgemm`` in P worker
processes, held against the scipy oracle and against the one-process mesh
over the same shards.

    python -m speck_tpu_torch.probes.multihost_cards             # NCCL
    python -m speck_tpu_torch.probes.multihost_cards --backend gloo
    python -m speck_tpu_torch.probes.multihost_cards --device cpu \\
        --backend gloo                                           # a rehearsal
    torchrun --nproc-per-node P -m speck_tpu_torch.probes.multihost_cards \\
        --worker [--cases ...] [--out DIR]

The parent starts ``--procs`` workers (2 by default) with torchrun's
variables in their environment (``MASTER_ADDR``, ``MASTER_PORT``,
``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``, and
``OMP_NUM_THREADS=1`` unless it is set, as torchrun does), gives
them the matrices through a temporary directory and collects what they
write there. Each worker calls ``multihost.initialize()`` (with
``backend=`` when ``--backend`` is given; without it the port's own rule
chooses: NCCL when every process has a card of its own, and it raises
when two processes would share one) and runs ``--shards`` shards in all,
``shards / P`` of them on its card (``global_row_mesh``). Two processes
on one card take ``--backend gloo``: card tensors then cross through the
host. Nothing falls back: a worker that raises makes the parent raise with
its rank and the tail of its output, and a worker still running after
``--timeout`` seconds gets every worker killed and the parent raises.

The cases (``CASES``) take every route of the mesh at bench widths:
config 3 (``make_powerlaw(262144, seed=7)``) under the need-set,
all_gather and overlapped exchanges and pre-sharded, config 1
(``make_banded(65536, 16, seed=3)``) on the dense and diagonal-plane
routes, and the bench's giant row through the k-split (on the CPU, a
rehearsal, at ``SMALL_MATRICES``' sizes). Each worker times one cold call
and REPS warm ones (host clock, ending in a
synchronize of its card), counts the synchronizing calls of one more
call, its peak card memory and K1's and K2's launches by shape. The
parent then holds every case: C against the scipy oracle (structure
exact, values within rel_tol 2e-3), the route and the exchange's mode
as the case names them, and the ranges, ``m_loc``, ``out_cap``, route,
mode, exchange bytes, pair counts, ``n_split``, ``nnz_row`` and C's
columns equal to the one-process mesh's over the same shards, its values
within rel_tol 2e-3 (and says whether they are bit-identical). Under
NCCL it prints ``scaling_efficiency(T1, TP, P)`` with T1 one card's
``spgemm`` on config 3. Every line carries the card's name and power
limit.

Under ``torchrun`` a worker makes its own matrices and rank 0 holds each
case against the scipy oracle and the case's route and mode itself.
"""

from __future__ import annotations

import argparse
import dataclasses
import hashlib
import json
import os
import shutil
import signal
import socket
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[2]


@dataclasses.dataclass
class Case:
    """One multihost_spgemm call: its matrix (a key of the matrices
    given), exchange and SpgemmConfig keywords, the route and exchange
    mode it must take, whether A and B come pre-sharded (each process
    holding only its own shards) and, for a k-split case, a row that must
    be among the split ones (-1: any)."""

    name: str
    matrix: str
    exchange: str
    kw: dict
    route: str
    mode: str
    presharded: bool = False
    split_row: Optional[int] = None


CASES = [
    Case("needset", "config3", "needset", {}, "stream", "needset"),
    Case("allgather", "config3", "allgather", {"enable_dense": False},
         "stream", "allgather"),
    Case("overlap", "config3", "needset_overlap", {}, "stream",
         "needset_overlap"),
    Case("presharded", "config3", "needset", {}, "stream", "needset",
         presharded=True),
    Case("dense", "config1", "allgather", {"enable_sdia": False}, "dense",
         "dense_allgather"),
    Case("banded", "config1", "needset", {}, "sdia", "dia_halo"),
    Case("ksplit", "giant_row", "needset", {}, "stream", "needset",
         split_row=0),
]

# the matrices of CASES: the bench's generator calls
MATRICES = {
    "config3": ("make_powerlaw", (262144, 12, 2.2, 7)),
    "config1": ("make_banded", (65536, 16, 3)),
    "giant_row": ("make_giant_row", ()),
}
# on the CPU (a rehearsal) the same shapes cut (the giant row at
# tests/test_torch_giant.py's size, split with the two-process CPU test's
# knobs)
SMALL_MATRICES = {
    "config3": ("make_powerlaw", (8192, 12, 2.2, 7)),
    "config1": ("make_banded", (4096, 16, 3)),
    "giant_row": ("make_giant_row", (4000, 200, 400)),
}
SMALL_KW = {"ksplit": {"stream_width": 64, "product_budget": 1 << 12,
                       "mesh_split_min_ops": 1 << 14,
                       "mesh_exchange_auto": False}}

RTOL = 2e-3
REC_BYTES = 8           # a float32 B record: column and value words
REPS = 2                # warm calls a case, after the cold one


def small_cases() -> List[Case]:
    return [dataclasses.replace(c, kw={**c.kw, **SMALL_KW.get(c.name, {})})
            for c in CASES]


def make_matrix(call):
    from ..utils import generators

    fn, args = call
    return getattr(generators, fn)(*args)


def select(cases: List[Case], names) -> List[Case]:
    if not names:
        return list(cases)
    by = {c.name: c for c in cases}
    unknown = [n for n in names if n not in by]
    if unknown:
        raise ValueError(f"unknown cases {unknown}; known: {list(by)}")
    return [by[n] for n in names]


# ---------------------------------------------------------------------------
# One call and what is kept of it
# ---------------------------------------------------------------------------


def case_call(case: Case, h, mesh):
    """The case's multihost_spgemm call over ``mesh`` (no arguments)."""
    from ..parallel.mesh_stream import RowShards
    from ..parallel.multihost import multihost_spgemm
    from ..utils.config import SpgemmConfig

    inp = h
    if case.presharded:
        full = RowShards.from_global(h, mesh.size)
        inp = RowShards.from_local(h.rows, h.cols, mesh.size,
                                   {d: full.local[d] for d in mesh.local})
    cfg = SpgemmConfig(**case.kw)
    return lambda: multihost_spgemm(inp, inp, cfg, exchange=case.exchange,
                                    mesh=mesh)


def summary(out):
    """(fields, arrays) of one multihost_spgemm output: the meta and
    exchange fields the one-process mesh must match, and nnz_row with C
    (every process gets the whole matrix)."""
    from ..parallel.dist import fetch_output
    from ..parallel.mesh_stream import mesh_stream_to_host_csr

    meta = out[3]
    st, ks = meta["stats"], meta["ksplit"] or {}
    C = mesh_stream_to_host_csr(*out)
    fields = dict(
        ranges=[[int(r0), int(r1)] for r0, r1 in meta["ranges"]],
        m_loc=int(meta["m_loc"]), out_cap=int(meta["out_cap"]),
        route=meta["route"],
        # all_gather reports no stats (as the reference)
        mode=st.mode if st is not None else "allgather",
        needset_bytes=int(st.needset_bytes) if st is not None else -1,
        allgather_bytes=int(st.allgather_bytes) if st is not None else -1,
        pairs_nnz=(np.asarray(st.pairs_nnz).tolist() if st is not None
                   else None),
        n_split=int(ks.get("n_split", 0)),
        split_ids=[int(i) for i in ks.get("split_ids", [])],
        shape=[int(C.rows), int(C.cols)], nnz=int(C.nnz))
    arrays = dict(nnz_row=fetch_output(out[0]),
                  row_offsets=np.asarray(C.row_offsets, np.int64),
                  col_ids=np.asarray(C.col_ids), data=np.asarray(C.data))
    return fields, arrays


def digest(arrays) -> str:
    h = hashlib.sha1()
    for k in ("nnz_row", "row_offsets", "col_ids", "data"):
        a = np.ascontiguousarray(arrays[k])
        h.update(f"{k} {a.dtype} {a.shape}".encode())
        h.update(a.tobytes())
    return h.hexdigest()


def host_csr(arrays, shape):
    from ..formats.csr import HostCSR

    return HostCSR(rows=shape[0], cols=shape[1],
                   row_offsets=arrays["row_offsets"],
                   col_ids=arrays["col_ids"], data=arrays["data"])


def expect(case: Case, f) -> None:
    """The route, mode and k-split the case must take."""
    if f["route"] != case.route or f["mode"] != case.mode:
        raise RuntimeError(
            f"{case.name}: route {f['route']} / mode {f['mode']}, expected "
            f"{case.route} / {case.mode}")
    if case.split_row is None:
        if f["n_split"]:
            raise RuntimeError(f"{case.name}: unexpected k-split of rows "
                               f"{f['split_ids']}")
    elif not f["n_split"] or (case.split_row >= 0
                              and case.split_row not in f["split_ids"]):
        raise RuntimeError(f"{case.name}: the k-split did not engage on row "
                           f"{case.split_row}: {f['split_ids']}")


# ---------------------------------------------------------------------------
# The worker
# ---------------------------------------------------------------------------


def _reset_counts() -> None:
    from ..ops import bitonic, contract

    contract.LAUNCHES = 0
    contract.LAUNCH_SHAPES.clear()
    bitonic.LAUNCHES = 0
    bitonic.LAUNCH_SHAPES.clear()


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def collectives_ms(mesh) -> float:
    """One all_gather and a ppermute round of every shift on tiny shard
    tensors, each result checked; the host clock around them (ms). The
    first call in a process holds the connection setup of the backend."""
    from ..parallel.dist import all_gather, ppermute

    dev = mesh.devices[mesh.local[0]]
    D = mesh.size
    _sync(dev)
    t0 = time.perf_counter()
    parts = {d: torch.full((4,), d, dtype=torch.int32,
                           device=mesh.devices[d]) for d in mesh.local}
    got = all_gather(mesh, parts)
    want = torch.arange(D, dtype=torch.int32)[:, None].expand(D, 4)
    for d in mesh.local:
        if not torch.equal(got[d].cpu(), want):
            raise RuntimeError(f"all_gather gave shard {d} {got[d]}")
    for shift in range(1, D):
        rnd = ppermute(mesh, parts, shift)
        for d in mesh.local:
            if int(rnd[d][0]) != (d - shift) % D:
                raise RuntimeError(f"ppermute by {shift} gave shard {d} "
                                   f"{rnd[d]}")
    _sync(dev)
    return (time.perf_counter() - t0) * 1e3


def run_case(case: Case, h, mesh):
    """Cold call, REPS warm calls and one counted call of the case on
    this process: (numbers, fields, arrays)."""
    from ..ops import bitonic, contract
    from .timing import sync_sites

    dev = mesh.devices[mesh.local[0]]
    on_card = dev.type == "cuda"
    call = case_call(case, h, mesh)
    _reset_counts()
    if on_card:
        _sync(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    out = call()
    _sync(dev)
    cold_ms = (time.perf_counter() - t0) * 1e3
    cold_launches = [contract.LAUNCHES, bitonic.LAUNCHES]
    local_nnz = int(out[0].sum())
    fields, arrays = summary(out)
    del out
    warm = []
    for _ in range(REPS):
        _sync(dev)
        t0 = time.perf_counter()
        out = call()
        _sync(dev)
        warm.append((time.perf_counter() - t0) * 1e3)
        if int(out[0].sum()) != local_nnz:
            raise RuntimeError(f"{case.name}: a warm call's nnz differs")
        del out
    sites = dict(sync_sites(call).most_common()) if on_card else None
    nums = dict(
        cold_ms=cold_ms, warm_ms=warm, warm_median_ms=statistics.median(warm),
        peak_bytes=(torch.cuda.max_memory_allocated(dev) if on_card
                    else None),
        syncs=sum(sites.values()) if on_card else None, sync_sites=sites,
        cold_launches=cold_launches,
        k1=[[list(k), n] for k, n in sorted(contract.LAUNCH_SHAPES.items())],
        k2=[[list(k), n] for k, n in sorted(bitonic.LAUNCH_SHAPES.items())])
    if on_card:
        torch.cuda.empty_cache()
    return nums, fields, arrays


def _save_csr(path: Path, h) -> None:
    np.save(path.with_suffix(".shape.npy"), np.array([h.rows, h.cols]))
    for k in ("row_offsets", "col_ids", "data"):
        np.save(path.with_suffix(f".{k}.npy"), np.asarray(getattr(h, k)))


def _load_csr(path: Path):
    from ..formats.csr import HostCSR

    rows, cols = np.load(path.with_suffix(".shape.npy")).tolist()
    return HostCSR(rows=rows, cols=cols, **{
        k: np.load(path.with_suffix(f".{k}.npy"))
        for k in ("row_offsets", "col_ids", "data")})


def worker(args) -> None:
    """One process of the job (the parent's or torchrun's)."""
    import torch.distributed as tdist

    from ..parallel import dist as _dist
    from ..parallel import multihost

    inputs = Path(args.inputs) if args.inputs else None
    if inputs is not None:
        spec = json.loads((inputs / "spec.json").read_text())
        cases = [Case(**c) for c in spec["cases"]]
        shards, device = spec["shards"], spec["device"]
        out_dir = inputs
    else:
        cases = select(small_cases() if args.device == "cpu" else CASES,
                       args.cases)
        shards, device = args.shards, args.device
        out_dir = Path(args.out) if args.out else None
        if out_dir is not None:
            out_dir.mkdir(parents=True, exist_ok=True)
    if device == "cpu" and args.backend not in (None, "gloo"):
        raise ValueError("--device cpu runs under gloo")
    multihost.initialize(backend="gloo" if device == "cpu"
                         else args.backend)
    P, p = _dist.process_count(), _dist.process_index()
    if P < 2 or shards % P:
        raise ValueError(f"{shards} shards over {P} processes: give 2 or "
                         "more processes and a shard count they divide")
    L = shards // P
    mesh = (multihost.global_row_mesh(devices=["cpu"] * L)
            if device == "cpu" else multihost.global_row_mesh(n_local=L))
    dev = mesh.devices[mesh.local[0]]
    backend = tdist.get_backend()
    card = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else "not a card")
    print(f"multihost worker rank {p} of {P}: backend {backend}, device "
          f"{dev} ({card}), shards {list(mesh.local)} of {mesh.size}, "
          f"{torch.get_num_threads()} CPU threads", flush=True)
    first = [collectives_ms(mesh), collectives_ms(mesh)]
    report = dict(rank=p, procs=P, backend=backend, device=str(dev),
                  card=card, shards=list(mesh.local), collectives_ms=first,
                  threads=torch.get_num_threads(), cases={})
    matrices = {}
    for case in cases:
        if case.matrix not in matrices:
            matrices[case.matrix] = (
                _load_csr(inputs / f"m_{case.matrix}") if inputs is not None
                else make_matrix((SMALL_MATRICES if device == "cpu"
                                  else MATRICES)[case.matrix]))
        h = matrices[case.matrix]
        nums, fields, arrays = run_case(case, h, mesh)
        nums.update(fields=fields, digest=digest(arrays))
        report["cases"][case.name] = nums
        if inputs is None and p == 0:
            _standalone_check(case, h, fields, arrays)
        if out_dir is not None and p == 0:
            np.savez(out_dir / f"case_{case.name}.npz", **arrays)
        print(f"multihost worker rank {p}: {case.name} route "
              f"{fields['route']}, mode {fields['mode']}, nnz(C) "
              f"{fields['nnz']}, cold {nums['cold_ms']:.1f} ms, warm "
              f"median of {REPS} {nums['warm_median_ms']:.1f} ms",
              flush=True)
        del arrays
    if out_dir is not None:
        (out_dir / f"rank{p}.json").write_text(json.dumps(report))
    tdist.barrier(group=_dist._HOST_GROUP)
    tdist.destroy_process_group()
    print(f"multihost worker rank {p}: done", flush=True)


def _standalone_check(case: Case, h, fields, arrays) -> None:
    """Under torchrun: the case against the scipy oracle, and its route."""
    from ..utils.compare import compare_csr
    from ..utils.oracle import oracle_spgemm

    expect(case, fields)
    r = compare_csr(oracle_spgemm(h, h), host_csr(arrays, fields["shape"]),
                    compare_data=True, rel_tol=RTOL)
    if not r.ok:
        raise RuntimeError(f"{case.name} differs from the oracle: "
                           f"{r.message}")


# ---------------------------------------------------------------------------
# The parent
# ---------------------------------------------------------------------------


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _tail(path: Path, n: int = 4000) -> str:
    try:
        data = path.read_bytes()
    except OSError:
        return ""
    return data[-n:].decode(errors="replace")


def _kill(procs) -> None:
    for p in procs:
        if p.poll() is None:
            try:
                os.killpg(p.pid, signal.SIGKILL)
            except ProcessLookupError:
                pass
    for p in procs:
        p.wait()


def launch(out_dir: Path, procs: int, argv: List[str], timeout: float,
           command: Optional[List[str]] = None) -> float:
    """Start ``procs`` workers (``command``, by default this module's
    ``--worker``, with ``argv``) under torchrun's variables, each in a
    session of its own with its output in ``out_dir/rank<r>.log``, and
    wait for every one. A worker that exits non-zero gets the others
    killed and raises with its rank and the tail of its output; past
    ``timeout`` seconds every worker is killed and it raises. Returns the
    seconds the workers took."""
    port = _free_port()
    cmd = command or [sys.executable, "-m",
                      "speck_tpu_torch.probes.multihost_cards", "--worker"]
    path = os.environ.get("PYTHONPATH")
    started = []
    t0 = time.perf_counter()
    try:
        for r in range(procs):
            env = dict(os.environ, MASTER_ADDR="127.0.0.1",
                       MASTER_PORT=str(port), RANK=str(r),
                       WORLD_SIZE=str(procs), LOCAL_RANK=str(r),
                       LOCAL_WORLD_SIZE=str(procs),
                       PYTHONPATH=(f"{ROOT}{os.pathsep}{path}" if path
                                   else str(ROOT)))
            # one node: the backends connect over the loopback interface
            env.setdefault("GLOO_SOCKET_IFNAME", "lo")
            env.setdefault("NCCL_SOCKET_IFNAME", "lo")
            # one CPU thread a process, as torchrun sets it for several
            # processes a node: P processes of the host's thread count
            # each oversubscribe its cores
            env.setdefault("OMP_NUM_THREADS", "1")
            with open(out_dir / f"rank{r}.log", "wb") as log:
                started.append(subprocess.Popen(
                    cmd + argv, stdout=log, stderr=subprocess.STDOUT,
                    env=env, start_new_session=True))
        while True:
            rcs = [p.poll() for p in started]
            for r, rc in enumerate(rcs):
                if rc not in (None, 0):
                    _kill(started)
                    raise RuntimeError(
                        f"multihost worker rank {r} of {procs} failed (exit "
                        f"{rc}); the tail of its output:\n"
                        f"{_tail(out_dir / f'rank{r}.log')}")
            if all(rc == 0 for rc in rcs):
                return time.perf_counter() - t0
            if time.perf_counter() - t0 > timeout:
                alive = [r for r, rc in enumerate(rcs) if rc is None]
                _kill(started)
                raise TimeoutError(
                    f"multihost workers {alive} of {procs} still running "
                    f"after {timeout:.0f} s: every worker killed; the tail "
                    f"of rank {alive[0]}'s output:\n"
                    f"{_tail(out_dir / f'rank{alive[0]}.log')}")
            time.sleep(0.05)
    finally:
        _kill(started)


def one_process(case: Case, h, device: str, shards: int):
    """(fields, arrays) of the case on the one-process mesh over the same
    shards (``make_row_mesh(shards, devices=[device])``)."""
    from ..parallel.dist import make_row_mesh

    out = case_call(case, h, make_row_mesh(shards, devices=[device]))()
    res = summary(out)
    del out
    if device != "cpu":
        torch.cuda.empty_cache()
    return res


def _bits(a):
    a = np.ascontiguousarray(a)
    return a.view(f"u{a.dtype.itemsize}")


def hold(case: Case, got_f, got_a, ref_f, ref_a, oracle) -> dict:
    """The parent's checks of one case (raises on the first that fails):
    the route, mode and k-split it must take, C against the scipy oracle,
    and the one-process mesh's fields, nnz_row and columns equal and its
    values within RTOL. Returns whether the values are bit-identical and,
    if not, their largest relative difference and its row."""
    from ..utils.compare import compare_csr

    expect(case, got_f)
    C = host_csr(got_a, got_f["shape"])
    r = compare_csr(oracle, C, compare_data=True, rel_tol=RTOL)
    if not r.ok:
        raise RuntimeError(f"{case.name} differs from the oracle: "
                           f"{r.message}")
    for k in ("shape", "ranges", "m_loc", "out_cap", "route", "mode",
              "needset_bytes", "allgather_bytes", "pairs_nnz", "n_split",
              "split_ids", "nnz"):
        if got_f[k] != ref_f[k]:
            raise RuntimeError(f"{case.name}: {k} {got_f[k]} across "
                               f"processes, {ref_f[k]} in one process")
    for k in ("nnz_row", "row_offsets", "col_ids"):
        if not np.array_equal(got_a[k], ref_a[k]):
            raise RuntimeError(f"{case.name}: {k} differs from the "
                               "one-process mesh's")
    same = (got_a["data"].dtype == ref_a["data"].dtype
            and np.array_equal(_bits(got_a["data"]), _bits(ref_a["data"])))
    res = dict(bit_identical=same, max_rel=0.0, row=None)
    if not same:
        ref_C = host_csr(ref_a, ref_f["shape"])
        r = compare_csr(ref_C, C, compare_data=True, rel_tol=RTOL)
        if not r.ok:
            raise RuntimeError(f"{case.name}: values differ from the "
                               f"one-process mesh's: {r.message}")
        g, f = (np.asarray(x["data"], np.float64) for x in (got_a, ref_a))
        rel = np.abs(g - f) / np.maximum(np.maximum(np.abs(g), np.abs(f)),
                                         1e-30)
        pos = int(np.argmax(rel))
        res.update(max_rel=float(rel[pos]), row=int(np.searchsorted(
            got_a["row_offsets"], pos, side="right")) - 1)
    return res


def single_card_ms(h) -> float:
    """T1 of the scaling metric: one card's spgemm of h with itself
    (cuda:0, float32), the median of 3 warm calls after a cold one (host
    clock, ending in a synchronize)."""
    from ..ops.device_csr import device_put_csr
    from ..ops.spgemm import spgemm

    A = device_put_csr(h, torch.float32, "cuda:0")
    spgemm(A, A)
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        spgemm(A, A)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    del A
    torch.cuda.empty_cache()
    return statistics.median(times)


def _launch_sum(reports, key):
    out: Dict[tuple, int] = {}
    for rep in reports:
        for nums in rep["cases"].values():
            for k, n in nums[key]:
                out[tuple(k)] = out.get(tuple(k), 0) + n
    return out


def run(cases: List[Case], matrices: dict, procs: int,
        backend: Optional[str], device: str = "cuda", shards: int = 4,
        timeout: float = 600.0, oracles: Optional[dict] = None,
        refs: Optional[dict] = None, t1_ms: Optional[float] = None,
        smi: str = "", log=print) -> dict:
    """The parent: ``procs`` workers run ``cases`` on ``matrices`` ({name:
    HostCSR}) over ``shards`` shards in all, under ``backend`` (None: the
    port's own choice), on their cards (``device="cuda"``) or the CPU;
    then every case is held (``hold``) against its oracle (``oracles``,
    else computed here) and the one-process mesh on ``device`` (``refs``:
    {case name: its ``summary``} where the caller ran that call already,
    else ``one_process``). Under NCCL
    on cards it prints ``scaling_efficiency(T1, TP, P)`` of the config 3
    cases (T1: ``t1_ms``, else ``single_card_ms``). Returns the report:
    the backend the workers took, per case the workers' numbers and the
    checks' result, K1's and K2's launches by shape summed over the
    workers, and the seconds."""
    from ..ops import build
    from ..parallel.multihost import scaling_efficiency
    from ..utils.oracle import oracle_spgemm

    t_start = time.perf_counter()
    tmp = Path(tempfile.mkdtemp(prefix="multihost_cards_"))
    try:
        spec = dict(cases=[dataclasses.asdict(c) for c in cases],
                    shards=shards, device=device)
        (tmp / "spec.json").write_text(json.dumps(spec))
        for name in {c.matrix for c in cases}:
            _save_csr(tmp / f"m_{name}", matrices[name])
        t_inputs = time.perf_counter()
        if device != "cpu":
            build.build()       # once, before the workers load it
        t_build = time.perf_counter()
        argv = ["--inputs", str(tmp)]
        if backend is not None:
            argv += ["--backend", backend]
        worker_s = launch(tmp, procs, argv, timeout)
        reports = [json.loads((tmp / f"rank{r}.json").read_text())
                   for r in range(procs)]
        took = reports[0]["backend"]
        where = "; ".join(f"rank {r['rank']} on {r['device']} ({r['card']}),"
                          f" shards {r['shards']}, {r['threads']} CPU threads"
                          for r in reports)
        log(f"multihost {took} P={procs}: {where}; inputs written in "
            f"{t_inputs - t_start:.1f} s, the kernels' build "
            f"{t_build - t_inputs:.1f} s, the workers {worker_s:.1f} s "
            f"[{smi}]")
        log(f"multihost {took} P={procs}: first collectives (connection "
            "setup) then again, ms: " + "; ".join(
                f"rank {r['rank']} {r['collectives_ms'][0]:.1f} then "
                f"{r['collectives_ms'][1]:.1f}" for r in reports)
            + f" [{smi}]")
        out = dict(backend=took, procs=procs, cases={},
                   ranks=[{k: r[k] for k in ("rank", "device", "card",
                                              "shards", "collectives_ms")}
                          for r in reports],
                   worker_s=worker_s, k1=_launch_sum(reports, "k1"),
                   k2=_launch_sum(reports, "k2"))
        for case in cases:
            h = matrices[case.matrix]
            per = [r["cases"][case.name] for r in reports]
            got_a = dict(np.load(tmp / f"case_{case.name}.npz"))
            if any(n["digest"] != digest(got_a) for n in per):
                raise RuntimeError(f"{case.name}: the processes assembled "
                                   "different outputs")
            got_f = per[0]["fields"]
            ref = (oracles or {}).get(case.matrix)
            if ref is None:
                ref = oracle_spgemm(h, h)
            t0 = time.perf_counter()
            ref_f, ref_a = ((refs or {}).get(case.name) or one_process(
                case, h, "cuda:0" if device != "cpu" else "cpu", shards))
            t1 = time.perf_counter()
            res = hold(case, got_f, got_a, ref_f, ref_a, ref)
            tp = max(n["warm_median_ms"] for n in per)
            res.update(per_rank=per, tp_ms=tp, fields=got_f,
                       one_process_s=t1 - t0,
                       hold_s=time.perf_counter() - t1)
            out["cases"][case.name] = res
            log(_case_line(case, took, procs, got_f, per, res, h, smi))
            del got_a, ref_a
        if took == "nccl" and device != "cpu" and "config3" in matrices:
            t1 = t1_ms if t1_ms is not None else single_card_ms(
                matrices["config3"])
            for case in cases:
                if case.matrix == "config3":
                    tp = out["cases"][case.name]["tp_ms"]
                    eff = scaling_efficiency(t1, tp, procs)
                    out["cases"][case.name]["scaling_efficiency"] = eff
                    log(f"multihost nccl P={procs} {case.name}: "
                        f"scaling_efficiency(T1 {t1:.2f} ms, TP {tp:.2f} "
                        f"ms, P {procs}) = {eff:.4f} (T1: one card's "
                        f"spgemm on config 3) [{smi}]")
        out["seconds"] = time.perf_counter() - t_start
        return out
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _case_line(case, backend, procs, f, per, res, h, smi) -> str:
    if f["pairs_nnz"] is not None and f["mode"] in ("needset",
                                                    "needset_overlap"):
        pn = np.asarray(f["pairs_nnz"], np.int64)
        recv = [int(pn[d].sum() - pn[d, d]) * REC_BYTES
                for d in range(pn.shape[0])]
        moved = (f"needset_bytes {f['needset_bytes']} a shard (padded), "
                 f"records' bytes received by shard {recv}")
    elif f["mode"] == "allgather":
        moved = f"every shard receives all of B, {h.nnz * REC_BYTES} bytes"
    else:
        moved = (f"bytes a shard receives {f['needset_bytes']} "
                 f"(allgather_bytes {f['allgather_bytes']})")
    ranks = "; ".join(
        f"rank {r}: cold {n['cold_ms']:.1f} ms, warm median of "
        f"{len(n['warm_ms'])} {n['warm_median_ms']:.2f} ms (all "
        f"{[round(w, 2) for w in n['warm_ms']]}), peak memory "
        + (f"{n['peak_bytes'] / 2**30:.2f} GiB" if n["peak_bytes"]
           is not None else "not a card")
        + f", synchronizing calls {n['syncs']}, launches in the cold call "
        f"K1 {n['cold_launches'][0]} K2 {n['cold_launches'][1]}"
        for r, n in enumerate(per))
    vals = ("bit-identical" if res["bit_identical"] else
            f"within {RTOL} (largest relative difference "
            f"{res['max_rel']:.3g} in row {res['row']})")
    return (f"multihost {backend} P={procs} {case.name} [{smi}]: "
            f"m={h.rows} nnz(A)={h.nnz} nnz(C)={f['nnz']}; route "
            f"{f['route']}, mode {f['mode']}; {moved}; n_split "
            f"{f['n_split']}; {ranks}; matches the oracle; equal to the "
            f"one-process mesh (meta, exchange, nnz_row, columns), values "
            f"{vals}; the parent's one-process call "
            f"{res['one_process_s']:.1f} s, its checks {res['hold_s']:.1f} s")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--worker", action="store_true",
                    help="run as one process of the job")
    ap.add_argument("--procs", type=int, default=2)
    ap.add_argument("--backend", choices=("nccl", "gloo"), default=None)
    ap.add_argument("--shards", type=int, default=4)
    ap.add_argument("--cases", nargs="*", default=None)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--timeout", type=float, default=600.0)
    ap.add_argument("--inputs", default=None,
                    help="(worker) the parent's directory of inputs")
    ap.add_argument("--out", default=None,
                    help="(worker under torchrun) where to write results")
    args = ap.parse_args(argv)
    if args.worker:
        worker(args)
        return
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("multihost_cards: no CUDA card; pass --device cpu")
    from .timing import card

    smi = card() if args.device == "cuda" else "not a card"
    small = args.device == "cpu"
    cases = select(small_cases() if small else CASES, args.cases)
    calls = SMALL_MATRICES if small else MATRICES
    matrices = {name: make_matrix(calls[name])
                for name in dict.fromkeys(c.matrix for c in cases)}
    rep = run(cases, matrices, args.procs, args.backend, args.device,
              args.shards, args.timeout, smi=smi)
    print(f"multihost {rep['backend']} P={args.procs}: {len(rep['cases'])} "
          f"cases held in {rep['seconds']:.1f} s (workers "
          f"{rep['worker_s']:.1f} s); K1 launches {sum(rep['k1'].values())},"
          f" K2 {sum(rep['k2'].values())} [{smi}]", flush=True)


if __name__ == "__main__":
    main()
