"""The port's benchmark harness (``speck_tpu_torch.bench``) on the CPU, at
small sizes: the cell function's ``#`` line and its oracle check, the
stage split, the headline's keys and its median rule, a failing cell
reported as FAILED with a non-zero exit, the harness importing no jax,
and the port's generators equal to ``bench.py``'s constructions."""

import functools
import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import bench as jax_bench
from speck_tpu_torch import bench
from speck_tpu_torch.utils import generators as gen
from speck_tpu_torch.utils.oracle import oracle_spgemm

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SMALL = {
    "banded": bench.Cell("banded", "banded",
                         functools.partial(gen.make_banded, 256, 2), iters=3),
    "powerlaw": bench.Cell("powerlaw", "powerlaw",
                           functools.partial(gen.make_powerlaw, 512),
                           streams=True),
    "fp64": bench.Cell("fp64", "fp64",
                       functools.partial(gen.make_banded, 256, 2, seed=9),
                       dtype=torch.float64),
    "rect": bench.Cell("rect", "rect",
                       functools.partial(gen.make_banded, 512, 2),
                       functools.partial(gen.make_prolongation, 512, 128),
                       streams=True),
}
LINE = re.compile(
    r"^# (?P<name>\S+) \[cpu, (?P<dtype>float32|float64)\]: "
    r"cold (?P<cold>[\d.]+) ms, iters \[(?P<iters>[\d., ]+)\] ms, "
    r"mean (?P<mean>[\d.]+) ms, median (?P<median>[\d.]+) ms, "
    r"best (?P<best>[\d.]+) ms, nnz\(C\)=(?P<nnz>\d+), "
    r"products=(?P<products>[\d.e+]+), GFLOPS=[\d.]+, "
    r"nnz\(C\)/s=[\d.e+]+, peak n/a, "
    r"launches a call: K1 0, K2 0, oracle OK$")


def _products(a, b):
    b_len = np.diff(np.asarray(b.row_offsets, np.int64))
    return int(b_len[np.asarray(a.col_ids, np.int64)].sum())


@pytest.mark.parametrize("which", list(SMALL))
def test_cell_line_and_oracle(which):
    cell = SMALL[which]
    a = cell.make_a()
    b = None if cell.make_b is None else cell.make_b()
    ref = oracle_spgemm(a, a if b is None else b)
    res = bench.run_cell(cell, a, b, ref, "cpu", stages=True)
    assert res.oracle_ok, res.oracle_msg
    assert len(res.times_ms) == cell.iters
    assert res.nnz == ref.nnz
    assert res.products == _products(a, a if b is None else b)
    assert res.peak_bytes is None
    m = LINE.match(res.line())
    assert m, res.line()
    assert m["name"] == cell.name
    assert m["dtype"] == str(cell.dtype).replace("torch.", "")
    assert len(m["iters"].split(", ")) == cell.iters
    assert int(m["nnz"]) == ref.nnz
    assert float(m["median"]) == pytest.approx(res.median_ms, abs=1e-3)
    # the stage split of a separate run, every stage under a port name
    assert set(res.stages) <= set(bench.Timings().ms)
    assert res.stages["complete"] > 0 and res.stages["spGEMMNumeric"] > 0
    for line in res.stage_lines():
        assert line.startswith(f"#   {cell.name} ")


def test_headline_takes_medians():
    res = bench.CellResult(
        name=bench.HEADLINE, device="cpu", dtype=torch.float32,
        cold_ms=50.0, times_ms=[4.0, 1.0, 2.0, 9.0, 3.0], products=1e6,
        nnz=10, peak_bytes=None, launches={}, oracle_ok=True, oracle_msg="")
    head = bench.headline(res, scipy_ms=6.0)
    assert list(head) == ["metric", "value", "unit", "vs_baseline"]
    assert head["metric"] == "spgemm_banded_65k_AxA_gflops"
    assert head["unit"] == "GFLOPS"
    assert head["value"] == pytest.approx(2e6 / 3.0e6)   # median 3 ms
    assert head["vs_baseline"] == pytest.approx(2.0)     # 6 / 3


def _cells(monkeypatch, *cells):
    monkeypatch.setattr(bench, "CELLS", list(cells))


def _head_cell(iters=2):
    return bench.Cell(bench.HEADLINE, "config1",
                      functools.partial(gen.make_banded, 256, 2), iters=iters)


def _raises():
    raise MemoryError("out of device memory")


def test_main_prints_the_headline_last(monkeypatch, capsys):
    _cells(monkeypatch, _head_cell(), SMALL["powerlaw"])
    assert bench.main(["--iters", "3"], device="cpu") == 0
    out = capsys.readouterr().out.strip().splitlines()
    assert out[0].startswith("cpu, torch ")
    assert [ln.split()[1] for ln in out[1:3]] == [bench.HEADLINE, "powerlaw"]
    assert all(len(LINE.match(ln)["iters"].split(", ")) == 3
               for ln in out[1:3])
    head = json.loads(out[-1])
    assert set(head) == {"metric", "value", "unit", "vs_baseline"}


@pytest.mark.parametrize("how", ["raises", "oracle"])
def test_failed_cell_exits_non_zero(monkeypatch, capsys, how):
    """A cell that raises, or whose C fails the oracle check, prints
    FAILED; the next cell still runs and the headline still comes last,
    and main returns non-zero."""
    bad = bench.Cell("bad", "bad", _raises if how == "raises"
                     else functools.partial(gen.make_powerlaw, 300))
    if how == "oracle":
        def wrong_oracle(a, b):
            c = oracle_spgemm(a, b)
            if a.rows == 300:
                c.data[0] += 1.0
            return c
        monkeypatch.setattr(bench, "oracle_spgemm", wrong_oracle)
    _cells(monkeypatch, _head_cell(), bad, SMALL["fp64"])
    assert bench.main([], device="cpu") == 1
    out = capsys.readouterr().out.strip().splitlines()
    assert any(ln.startswith("# bad FAILED: ") for ln in out)
    assert any(ln.startswith("# fp64 [cpu, float64]") for ln in out)
    assert out[-2] == "# FAILED cells: bad"
    assert json.loads(out[-1])["metric"] == bench.METRIC


def test_failed_headline_cell_prints_no_headline(monkeypatch, capsys):
    _cells(monkeypatch, bench.Cell(bench.HEADLINE, "config1", _raises),
           SMALL["banded"])
    assert bench.main([], device="cpu") == 1
    out = capsys.readouterr().out.strip().splitlines()
    assert out[-1] == "# FAILED cells: config1"
    assert not any(ln.startswith("{") for ln in out)


def test_cells_by_name_or_tag_in_bench_order():
    assert [c.tag for c in bench.select(["fp64", "config1"])] == [
        "config1", "fp64"]
    assert [c.name for c in bench.select([])][0] == bench.HEADLINE
    assert len(bench.select([])) == 8
    with pytest.raises(SystemExit):
        bench.select(["config9"])


def test_main_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match='device="cpu"'):
        bench.main([])


def test_importing_the_harness_imports_no_jax():
    code = ("import sys; import speck_tpu_torch.bench; "
            "bad = sorted(m for m in sys.modules if m == 'jax' "
            "or m.startswith(('jax.', 'speck_tpu.')) or m == 'speck_tpu'); "
            "print(bad); sys.exit(1 if bad else 0)")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


@pytest.mark.parametrize("which", ["banded", "powerlaw", "prolongation"])
def test_generators_are_bench_constructions(which):
    if which == "banded":
        got, want = gen.make_banded(300, 4, 7), jax_bench.make_banded(300, 4, 7)
    elif which == "powerlaw":
        got = gen.make_powerlaw(700, 9, 2.2, 11)
        want = jax_bench.make_powerlaw(700, 9, 2.2, 11)
    else:
        got = gen.make_prolongation(500, 60, 4)
        want = jax_bench.make_prolongation(500, 60, 4)
    assert (got.rows, got.cols) == (want.rows, want.cols)
    for f in ("row_offsets", "col_ids", "data"):
        np.testing.assert_array_equal(np.asarray(getattr(got, f)),
                                      np.asarray(getattr(want, f)))
