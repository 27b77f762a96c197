"""Two-process execution of the port's ``multihost_spgemm`` (the
counterpart of ``tests/test_multihost_mp.py``).

Two OS processes each call ``multihost.initialize`` with gloo and run two
CPU shards of a 4-shard row mesh; their collectives (the all_gather of B
and of the k-split partials, the need-set ppermute rounds, issued all at
once under the overlapped exchange, the diagonal-plane route's ring halo,
the host metadata) go through torch.distributed. The cases take every
route: the stream under both exchanges and the overlapped one, the dense
route (the default config under allgather, as the reference's own
two-process test) and the diagonal-plane route (a band). The workers
import only the port
and check against the scipy oracle (rel_tol 2e-3); the test process then
holds what they wrote against ``speck_tpu``'s ``mesh_stream_spgemm`` on a
4-device mesh: meta equal, ``nnz_row`` and columns equal, values within
rtol 2e-3, the route and the exchange's mode and bytes equal."""

import os
import socket
import subprocess
import sys

import numpy as np
import scipy.sparse as sp

_WORKER = r"""
import sys
import numpy as np
pid, port, out_path = int(sys.argv[1]), sys.argv[2], sys.argv[3]
from speck_tpu_torch.parallel.multihost import (global_row_mesh,
                                                initialize, multihost_spgemm)
from speck_tpu_torch.parallel.mesh_stream import (RowShards,
                                                  mesh_stream_to_host_csr)
from speck_tpu_torch.parallel.dist import fetch_output, process_count
from speck_tpu_torch.utils.compare import compare_csr
from speck_tpu_torch.utils.config import SpgemmConfig
from speck_tpu_torch.utils.oracle import oracle_spgemm
sys.path.insert(0, sys.argv[4])
from test_torch_multihost_mp import CASES, MATRICES

initialize(f"localhost:{port}", num_processes=2, process_id=pid,
           backend="gloo")
assert process_count() == 2
mesh = global_row_mesh(devices=["cpu", "cpu"])
assert mesh.size == 4 and mesh.local == (2 * pid, 2 * pid + 1), mesh
saved = {}
for name, exchange, kw in CASES:
    a = MATRICES[name]()
    ref = oracle_spgemm(a, a)
    inp = a
    if name == "presharded":
        full = RowShards.from_global(a, 4)
        inp = RowShards.from_local(a.rows, a.cols, 4,
                                   {d: full.local[d] for d in mesh.local})
    out = multihost_spgemm(inp, inp, SpgemmConfig(**kw), exchange=exchange,
                           mesh=mesh)
    got = mesh_stream_to_host_csr(*out)
    r = compare_csr(ref, got, compare_data=True, rel_tol=2e-3)
    assert r.ok, f"p{pid} {name}: {r.message}"
    meta = out[3]
    for i, k in enumerate(("nnz_row", "cols", "vals")):
        saved[f"{name}_{k}"] = fetch_output(out[i])
    saved[f"{name}_ranges"] = np.asarray(meta["ranges"])
    saved[f"{name}_m_loc"] = meta["m_loc"]
    saved[f"{name}_out_cap"] = meta["out_cap"]
    saved[f"{name}_route"] = meta["route"]
    st = meta["stats"]
    saved[f"{name}_mode"] = "" if st is None else st.mode
    saved[f"{name}_needset_bytes"] = -1 if st is None else st.needset_bytes
    saved[f"{name}_pairs_nnz"] = (np.zeros((4, 4), np.int64) if st is None
                                  else st.pairs_nnz)
    saved[f"{name}_n_split"] = (meta["ksplit"] or {}).get("n_split", 0)
    print(f"p{pid} {name} OK", flush=True)
if pid == 0:
    np.savez(out_path, **saved)
import torch.distributed as tdist
tdist.barrier()
tdist.destroy_process_group()
print(f"p{pid} DONE", flush=True)
"""

# (name, exchange, SpgemmConfig keywords); the small power-law input is
# tile-bounded, so allgather takes the dense route under the default
# config and the stream with EnableDense=false
CASES = [
    ("needset", "needset", {}),
    ("allgather", "allgather", {"enable_dense": False}),
    ("dense", "allgather", {}),
    ("overlap", "needset_overlap", {}),
    ("ksplit", "needset", {"stream_width": 64, "product_budget": 1 << 12,
                           "mesh_split_min_ops": 120,
                           "mesh_exchange_auto": False}),
    ("presharded", "needset", {}),
    ("banded", "needset", {}),
]
ROUTES = {"dense": "dense", "banded": "sdia"}
MODES = {"dense": "dense_allgather", "overlap": "needset_overlap",
         "banded": "dia_halo"}


def matrix():
    """The power-law 96x96 input of ``tests/test_multihost_mp.py``."""
    from speck_tpu_torch.formats.csr import HostCSR

    rs = np.random.RandomState(42)
    m = 96
    lens = np.minimum((rs.pareto(1.5, m) + 1) * 3, 24).astype(np.int64)
    rows = np.repeat(np.arange(m), lens)
    cols = rs.randint(0, m, rows.shape[0])
    A = sp.csr_matrix((rs.standard_normal(rows.shape[0]), (rows, cols)),
                      shape=(m, m))
    A.sum_duplicates()
    return HostCSR.from_scipy(A)


def banded():
    """A 96-row band of half-width 3: the diagonal-plane route, whose
    halo crosses the process boundary between shards 1 and 2."""
    from speck_tpu_torch.formats.csr import HostCSR

    rs = np.random.RandomState(43)
    offs = list(range(-3, 4))
    A = sp.diags([rs.standard_normal(96 - abs(o)) for o in offs], offs,
                 shape=(96, 96), format="csr")
    return HostCSR.from_scipy(A)


MATRICES = {name: (banded if name == "banded" else matrix)
            for name, _, _ in CASES}


def _free_port() -> int:
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_two_process_multihost_spgemm(tmp_path):
    from speck_tpu.formats.csr import HostCSR as JHostCSR
    from speck_tpu.parallel import (RowShards, make_row_mesh,
                                    mesh_stream_spgemm)
    from speck_tpu.utils.config import SpgemmConfig

    port = _free_port()
    worker = tmp_path / "worker.py"
    worker.write_text(_WORKER)
    out = tmp_path / "out.npz"
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.dirname(here)
    procs = [
        subprocess.Popen(
            [sys.executable, "-u", str(worker), str(pid), str(port),
             str(out), here],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env)
        for pid in range(2)
    ]
    outs = []
    try:
        for p in procs:
            o, _ = p.communicate(timeout=60)
            outs.append(o.decode())
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for pid, (p, o) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {pid} failed:\n{o}"
        for name, _, _ in CASES:
            assert f"p{pid} {name} OK" in o, o
        assert f"p{pid} DONE" in o, o

    got = np.load(out)
    mesh = make_row_mesh(4)
    for name, exchange, kw in CASES:
        a = MATRICES[name]()
        aj = JHostCSR(rows=a.rows, cols=a.cols, row_offsets=a.row_offsets,
                      col_ids=a.col_ids, data=a.data)
        inp = aj
        if name == "presharded":
            inp = RowShards.from_global(aj, 4)
        nnz_row, cols, vals, meta = mesh_stream_spgemm(
            inp, inp, mesh, SpgemmConfig(**kw), exchange=exchange)
        assert meta["route"] == str(got[f"{name}_route"]) == ROUTES.get(
            name, "stream")
        if name in MODES:
            assert meta["stats"].mode == str(got[f"{name}_mode"]) \
                == MODES[name]
        assert [tuple(r) for r in meta["ranges"]] == \
            [tuple(r) for r in got[f"{name}_ranges"]]
        assert meta["m_loc"] == int(got[f"{name}_m_loc"])
        assert meta["out_cap"] == int(got[f"{name}_out_cap"])
        st = meta["stats"]
        assert (st is None) == (int(got[f"{name}_needset_bytes"]) == -1)
        if st is not None:
            assert st.needset_bytes == int(got[f"{name}_needset_bytes"])
            np.testing.assert_array_equal(st.pairs_nnz,
                                          got[f"{name}_pairs_nnz"])
        n_split = (meta["ksplit"] or {}).get("n_split", 0)
        assert n_split == int(got[f"{name}_n_split"])
        jn = np.asarray(nnz_row).reshape(4, -1)
        tn = got[f"{name}_nnz_row"].reshape(4, -1)
        np.testing.assert_array_equal(tn, jn)
        jc = np.asarray(cols).reshape(4, -1)
        jv = np.asarray(vals).reshape(4, -1)
        tc = got[f"{name}_cols"].reshape(4, -1)
        tv = got[f"{name}_vals"].reshape(4, -1)
        for d in range(4):
            tot = int(jn[d].sum())
            np.testing.assert_array_equal(tc[d, :tot], jc[d, :tot])
            np.testing.assert_allclose(tv[d, :tot], jv[d, :tot], rtol=2e-3,
                                       atol=1e-5)
    assert got["ksplit_n_split"] >= 1
