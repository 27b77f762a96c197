"""The port's multi-process launcher (``speck_tpu_torch.probes.
multihost_cards``) on the CPU: two gloo worker processes run the cases of
``tests/test_torch_multihost_mp.py`` (its 96x96 matrices, every route)
through ``multihost_spgemm``, started with torchrun's variables, and the
parent holds each against the scipy oracle (structure exact, values
within rel_tol 2e-3) and the one-process mesh over the same 4 shards:
meta, route, mode, exchange bytes, ``n_split``, ``nnz_row`` and columns
equal, values within rel_tol 2e-3. A worker that fails or hangs fails the
launch, naming its rank. Then the backend and card choice of
``parallel/multihost.py`` with ``torch.cuda`` stood in for."""

import os
import sys
import time

import pytest
import torch

from speck_tpu_torch.parallel import multihost
from speck_tpu_torch.probes import multihost_cards as mc

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_multihost_mp import CASES, MATRICES, MODES, ROUTES  # noqa: E402


def launch_cases():
    """The two-process CPU test's cases as the launcher's, and their
    matrices."""
    cases = [mc.Case(name, name, exchange, kw, ROUTES.get(name, "stream"),
                     MODES.get(name, exchange),
                     presharded=name == "presharded",
                     split_row=-1 if name == "ksplit" else None)
             for name, exchange, kw in CASES]
    return cases, {name: MATRICES[name]() for name, _, _ in CASES}


def test_launcher_two_gloo_processes_match_one_process_mesh():
    cases, matrices = launch_cases()
    rep = mc.run(cases, matrices, procs=2, backend="gloo", device="cpu",
                 timeout=120, log=lambda line: None)
    assert rep["backend"] == "gloo" and rep["procs"] == 2
    assert [r["shards"] for r in rep["ranks"]] == [[0, 1], [2, 3]]
    assert set(rep["cases"]) == {c.name for c in cases}
    for case in cases:
        res = rep["cases"][case.name]
        assert res["fields"]["route"] == case.route
        assert res["fields"]["mode"] == case.mode
        assert res["bit_identical"], (case.name, res["max_rel"], res["row"])
    got = rep["cases"]
    assert (got["overlap"]["fields"]["needset_bytes"]
            == got["needset"]["fields"]["needset_bytes"])
    assert got["ksplit"]["fields"]["n_split"] >= 1
    # the wrappers run their plain versions on the CPU: no launch counted
    assert rep["k1"] == {} and rep["k2"] == {}


def test_launcher_raises_when_a_worker_raises():
    cases, matrices = launch_cases()
    bad = [mc.Case("bad", "needset", "bogus", {}, "stream", "needset")]
    with pytest.raises(RuntimeError, match=r"worker rank \d of 2 failed"
                       r"(.|\n)*bogus"):
        mc.run(bad, {"needset": matrices["needset"]}, procs=2,
               backend="gloo", device="cpu", timeout=120,
               log=lambda line: None)


_ONE_RANK_FAILS = """
import os, sys, time
if os.environ["RANK"] == "1":
    print("rank 1 gives up", flush=True)
    sys.exit(3)
time.sleep(120)
"""

_HANGS = """
import os, time
open(os.path.join({out!r}, "pid" + os.environ["RANK"]), "w").write(
    str(os.getpid()))
time.sleep(120)
"""


def _gone(pid: int) -> bool:
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return True
    return False


def test_launcher_names_the_failing_rank_and_stops_the_others(tmp_path):
    script = tmp_path / "w.py"
    script.write_text(_ONE_RANK_FAILS)
    t0 = time.perf_counter()
    with pytest.raises(RuntimeError, match=r"rank 1 of 2 failed \(exit 3\)"
                       r"(.|\n)*rank 1 gives up"):
        mc.launch(tmp_path, 2, [], timeout=60,
                  command=[sys.executable, str(script)])
    assert time.perf_counter() - t0 < 30


def test_launcher_kills_every_worker_past_its_timeout(tmp_path):
    script = tmp_path / "w.py"
    script.write_text(_HANGS.format(out=str(tmp_path)))
    t0 = time.perf_counter()
    with pytest.raises(TimeoutError, match=r"still running after 3 s"):
        mc.launch(tmp_path, 2, [], timeout=3,
                  command=[sys.executable, str(script)])
    assert time.perf_counter() - t0 < 30
    pids = [int((tmp_path / f"pid{r}").read_text()) for r in range(2)]
    assert all(_gone(pid) for pid in pids)


@pytest.fixture()
def cards(monkeypatch):
    """torch.cuda with a chosen number of cards."""
    def set_cards(n):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: n > 0)
        monkeypatch.setattr(torch.cuda, "device_count", lambda: n)
    return set_cards


def test_default_backend_is_gloo_without_cards(cards):
    cards(0)
    assert multihost._default_backend(None) == "gloo"
    assert multihost._default_backend("4") == "gloo"


@pytest.mark.parametrize("n_cards,local_world", [(1, "1"), (2, "2"),
                                                 (4, "2"), (4, "4")])
def test_default_backend_is_nccl_with_a_card_a_process(cards, n_cards,
                                                       local_world):
    cards(n_cards)
    assert multihost._default_backend(local_world) == "nccl"


@pytest.mark.parametrize("n_cards,local_world,match", [
    (1, None, "LOCAL_WORLD_SIZE"), (2, None, "LOCAL_WORLD_SIZE"),
    (1, "2", "share 1 CUDA card"), (2, "4", "share 2 CUDA card")])
def test_default_backend_raises_without_a_card_a_process(
        cards, n_cards, local_world, match):
    cards(n_cards)
    with pytest.raises(ValueError, match=match):
        multihost._default_backend(local_world)


@pytest.mark.parametrize("n_cards,local_rank,rank,want", [
    (4, "0", 3, 0), (4, "3", 0, 3), (2, "3", 0, 1), (1, "1", 0, 0),
    (2, None, 5, 1), (4, None, 2, 2)])
def test_local_card_is_local_rank_modulo_the_cards(cards, monkeypatch,
                                                   n_cards, local_rank,
                                                   rank, want):
    cards(n_cards)
    if local_rank is None:
        monkeypatch.delenv("LOCAL_RANK", raising=False)
    else:
        monkeypatch.setenv("LOCAL_RANK", local_rank)
    assert multihost._local_card(rank) == want


def test_initialize_under_nccl_takes_the_card_of_its_rank(cards,
                                                          monkeypatch):
    """Without LOCAL_RANK a process of an env:// job takes the card of
    its RANK (modulo the cards), not card 0 for every rank."""
    import torch.distributed as tdist

    class Stop(Exception):
        pass

    def stop(**kw):
        raise Stop

    cards(4)
    monkeypatch.delenv("LOCAL_RANK", raising=False)
    monkeypatch.setenv("RANK", "3")
    monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
    seen = []
    monkeypatch.setattr(torch.cuda, "set_device", seen.append)
    monkeypatch.setattr(tdist, "is_initialized", lambda: False)
    monkeypatch.setattr(tdist, "init_process_group", stop)
    with pytest.raises(Stop):
        multihost.initialize(backend="nccl")
    assert seen == [3]
