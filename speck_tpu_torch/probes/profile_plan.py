"""Where the planning pass's time goes on the card: the port of
``scripts/profile_plan.py``, and the split of ``loadBalanceCounting`` on
the bench's cells past ``host_analysis_max_nnz``:

    python -m speck_tpu_torch.probes.profile_plan [config1|giant_row|stencil27]
        [--reps N]

``config1`` (the default, the script's matrix: ``make_banded(65536, 16,
seed=3)``, A·A, float32) runs ``split``, the script's stages in its order:
the device ``analyze``; ``plan_device_stream`` with the dense-tile gate
on; ``tile_stats`` alone; ``_plan_rows_impl`` alone (the port's rows are
always the tight layout); the pack's fetch after a dispatch; then the
diagonal-plane stages of the plan that config 1 takes (``dia_slots``,
``dia_planes``, ``dia_conv``, ``dia_count_stage``, the gather emit of
the staged planes and ``execute()``), at the plan's spans.

``giant_row`` (``make_giant_row()``) and ``stencil27``
(``make_stencil27(102)``) run ``lbc_split``: each step that
``plan_spgemm`` runs on an input past ``host_analysis_max_nnz``, in its
order, timed alone: the row ends that the host gates share
(``analysis.HostEnds``: each row's first and last column, O(rows)); the
lite host gate (``host_band_extremes``, then, where the band allows a
diagonal route, ``host_gate_lite``, ``_dia_spans`` and ``_sdia_gate``;
where one of them read the product total, that total as a row of its
own); on a diagonal route, the DIA plan it encloses; else the device
``analyze`` (booked as ``countProducts``), the host plausibility gates
(``_host_dense_plausible``, ``_host_dia_rows_plausible``),
``plan_device_stream``, the pack's readback,
the host layout (``host_layout``: ``plan_layout``, ``plan_levels``,
``_plan_accum``) and ``build_srec`` with its ``searchsorted``. Last,
``plan_spgemm``'s own stages by ``Timings`` with ``measure_all``; the
sum of the parts stands beside its ``loadBalanceCounting``.

Each row is the host clock around the stage (median and min of ``--reps``
after one warm call, ending in a synchronize), with the card's name and
power limit. Run each probe in a fresh process: the host stages differ
2-3x between a fresh process and an old one (freed arrays that glibc gave
back are faulted in again).
"""

from __future__ import annotations

import argparse
import statistics
import time

import torch

from ..ops.analysis import HostEnds, analyze, product_total
from ..ops.dense import dense_gather_emit, tile_stats
from ..ops.device_csr import device_put_csr, host_of
from ..ops.dia import dia_conv, dia_count_stage, dia_planes, dia_slots
from ..ops.spgemm import (_plan_dia, _plan_sdia, dia_route_possible,
                          host_gates, host_layout, lite_gate, plan_spgemm,
                          plan_stream, read_pack, record_bits,
                          stream_records)
from ..ops.stream import _plan_rows_impl
from ..utils.config import SpgemmConfig
from ..utils.timings import Timings
from .split import print_rows, start, timed

CELLS = {"config1": ("make_banded", (65536, 16, 3)),
         "giant_row": ("make_giant_row", ()),
         "stencil27": ("make_stencil27", (102, 19))}

LABELS = ("analyze", "plan_device_stream (device)", "tile_stats alone",
          "_plan_rows_impl(tight) alone", "pack fetch", "dia_slots",
          "dia_planes", "dia_conv", "dia_count_stage",
          "dia dense_gather_emit", "dia execute()")

LBC_LABEL = "plan_spgemm loadBalanceCounting (Timings)"
ROW_ENDS_LABEL = "row ends (HostEnds)"
TOTAL_LABEL = "product total (bincount)"


def planning_calls(A, cfg, stats):
    """The planning stages that this script and ``micro2`` time, as
    zero-argument calls on A·A with the analysis ``stats``."""
    m = A.shape[0]
    sm = stats.row_ops > 0
    dm = torch.zeros(m, dtype=torch.bool, device=A.device)
    return {
        "analyze": lambda: analyze(A, A),
        "plan_device_stream": lambda: plan_stream(
            A, A, cfg, stats, use_dense=True, use_dia_rows=False),
        "plan_device_stream use_dense=False": lambda: plan_stream(
            A, A, cfg, stats, use_dense=False, use_dia_rows=False),
        "tile_stats": lambda: tile_stats(
            A.indptr, A.indices, A.indptr, A.indices, stats.row_ops,
            stats.a_len, tile_rows=cfg.dense_tile_rows, m=m),
        "_plan_rows_impl": lambda: _plan_rows_impl(
            stats.row_ops, sm, dm, min_q=cfg.stream_min_q, m=m,
            w0=cfg.stream_width, w_cap=cfg.stream_width_cap),
    }


def fetch_row(label, dispatch, fetch, reps):
    """The script's fetch timing: each repetition dispatches untimed, then
    the host clock runs around the fetch alone, which waits for the
    dispatched device work."""
    fetch(dispatch())
    times = []
    for _ in range(reps):
        out = dispatch()
        t0 = time.perf_counter()
        got = fetch(out)
        times.append((time.perf_counter() - t0) * 1e3)
    return label, statistics.median(times), min(times), got


def split(A, cfg=None, reps: int = 5):
    """The script's stages on A·A (an input of the contiguous DIA route,
    as bench config 1), in its order and under its labels (``LABELS``)."""
    cfg = cfg or SpgemmConfig()
    m, k = A.shape
    stats = analyze(A, A)
    calls = planning_calls(A, cfg, stats)
    rows = [timed(LABELS[0], calls["analyze"], reps),
            timed(LABELS[1], calls["plan_device_stream"], reps),
            timed(LABELS[2], calls["tile_stats"], reps),
            timed(LABELS[3], calls["_plan_rows_impl"], reps),
            fetch_row(LABELS[4], calls["plan_device_stream"],
                      lambda out: out[6].cpu().numpy(), reps)]
    plan = plan_spgemm(A, A, cfg)
    d = plan.dia
    if d is None or d.off_a is not None or d.staged is None:
        raise ValueError("profile_plan.split needs an input that the "
                         "contiguous DIA route takes with staged planes "
                         "(bench config 1)")
    sa, sb, sc = d.span_a, d.span_b, d.span_c
    rows.append(timed(LABELS[5], lambda: dia_slots(
        A.indptr, A.indices, dmin=d.dmin_a, span=sa, rows=m), reps))
    slot_a = rows[-1][3]
    rows.append(timed(LABELS[6], lambda: dia_planes(slot_a, A.data, span=sa,
                                                    rows=m), reps))
    av, ah = rows[-1][3]
    rows.append(timed(LABELS[7], lambda: dia_conv(
        av, ah, av, ah, sa=sa, sb=sb, m=m, k=k, dmin_a=d.dmin_a,
        with_hit=True), reps))
    cv, cc = rows[-1][3]
    rows.append(timed(LABELS[8], lambda: dia_count_stage(
        cv, cc, sc=sc, m=m, n_cols=m, base_c=d.dmin_a + d.dmin_b), reps))
    cols_s, vals_s = d.staged
    rows.append(timed(LABELS[9], lambda: dense_gather_emit(
        cols_s, vals_s, plan.row_offsets, tile_rows=1, cw=sc, m=m,
        nnz=plan.nnz), reps))
    rows.append(timed(LABELS[10], plan.execute, reps))
    return rows


def plan_stage_ms(A, cfg, reps: int):
    """plan_spgemm's own stages (``Timings`` with ``measure_all``): after
    one warm call, each stage's median and min over ``reps`` calls, and
    the medians of every stage as a dict."""
    per = []
    for i in range(reps + 1):
        t = Timings()
        t.measure_all = True
        plan_spgemm(A, A, cfg, t)
        if i:
            per.append(dict(t.items()))
    med = {s: statistics.median(p[s] for p in per) for s in per[0]}
    lbc = [p["loadBalanceCounting"] for p in per]
    return statistics.median(lbc), min(lbc), med


def lbc_split(A, cfg=None, reps: int = 5):
    """Each step that plan_spgemm runs on A·A for an input past
    ``host_analysis_max_nnz`` (with its host copy attached), in its order,
    each timed alone, then ``LBC_LABEL``: plan_spgemm's own
    ``loadBalanceCounting`` (its outputs: the medians of every stage).
    The gates are plan_spgemm's own (``lite_gate``, ``host_gates``), each
    step timed as they run it, on row ends built once (``ROW_ENDS_LABEL``,
    the first row); the steps they skip are not rows."""
    cfg = cfg or SpgemmConfig()
    ah = host_of(A)
    if not cfg.host_analysis or ah is None \
            or A.nnz <= cfg.host_analysis_max_nnz:
        raise ValueError("lbc_split needs an input past "
                         "host_analysis_max_nnz with its host copy")
    dia_possible = dia_route_possible(cfg, A, A)
    rows = []

    def step(prefix):
        def run(name, fn):
            rows.append(timed(prefix + name, fn, reps))
            return rows[-1][3]
        return run

    def built():
        ends = HostEnds()
        ends(ah)
        return ends

    rows.append(timed(ROW_ENDS_LABEL, built, reps))
    ends = rows[-1][3]
    route = None
    if dia_possible:
        lite, route, gate = lite_gate(cfg, A, A, ah, ah, ends,
                                      step("lite gate: "))
        if lite is not None and lite.total is not None:
            # a gate read the product total: computed inside its first
            # rep only (HostGateLite caches it), so it is a row of its own
            rows.append(timed(TOTAL_LABEL, lambda: product_total(ah, ah),
                              reps))
        if route == "dia":
            rows.append(timed(
                "_plan_dia (spGEMMCounting, allocC)",
                lambda: _plan_dia(A, A, cfg, None, lite, lite.a_dmin,
                                  lite.b_dmin, *gate, False), reps))
        elif route == "sdia":
            rows.append(timed(
                "_plan_sdia (spGEMMCounting, allocC)",
                lambda: _plan_sdia(A, A, cfg, None, lite, *gate,
                                   track=False), reps))
    if route is None:
        rows.append(timed("analyze (countProducts)", lambda: analyze(A, A),
                          reps))
        stats = rows[-1][3]
        use_dense, use_dia_rows = host_gates(cfg, A, A, ah, ah, dia_possible,
                                             ends, step("host gate: "))
        rows.append(timed("plan_device_stream", lambda: plan_stream(
            A, A, cfg, stats, use_dense=use_dense,
            use_dia_rows=use_dia_rows), reps))
        out = rows[-1][3]
        rows.append(timed("pack readback", lambda: out[6].cpu().numpy(),
                          reps))
        pk = read_pack(rows[-1][3])
        rows.append(timed(
            "host_layout (plan_layout, plan_levels, _plan_accum)",
            lambda: host_layout(pk, cfg, out[4]), reps))
        layout = rows[-1][3][0]
        if layout.total_q > 0:
            a32 = record_bits(A)
            rows.append(timed("build_srec, searchsorted", lambda: (
                stream_records(A, A, a32, out[0], out[1], out[2], layout,
                               pk.n_live)), reps))
    med, mn, stages = plan_stage_ms(A, cfg, reps)
    rows.append((LBC_LABEL, med, mn, stages))
    return rows


def sum_line(rows, where: str) -> str:
    """The parts' sum beside plan_spgemm's own stages (``lbc_split``)."""
    parts = [r for r in rows if r[0] != LBC_LABEL]
    total = sum(r[1] for r in parts)
    no_an = sum(r[1] for r in parts if not r[0].startswith("analyze"))
    st = rows[-1][3]
    return (f"# sum of the parts' medians {total:.3f} ms ({no_an:.3f} ms "
            f"without analyze); plan_spgemm's medians: loadBalanceCounting "
            f"{st['loadBalanceCounting']:.3f} ms, countProducts "
            f"{st['countProducts']:.3f} ms, spGEMMCounting "
            f"{st['spGEMMCounting']:.3f} ms, allocC {st['allocC']:.3f} ms "
            f"[{where}]")


def main(argv=None, device=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("cell", nargs="?", default="config1",
                    choices=sorted(CELLS))
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args(argv)
    dev, where = start(device)
    from ..utils import generators

    fn_name, gen_args = CELLS[args.cell]
    h = getattr(generators, fn_name)(*gen_args)
    A = device_put_csr(h, torch.float32, device=dev)
    print(f"# profile_plan {args.cell}: m={h.rows} nnz={h.nnz}, A*A "
          f"float32, fresh process [{where}]", flush=True)
    if args.cell == "config1":
        print_rows(split(A, reps=args.reps), where)
        return
    rows = lbc_split(A, reps=args.reps)
    print_rows(rows, where)
    print(sum_line(rows, where), flush=True)


if __name__ == "__main__":
    main()
