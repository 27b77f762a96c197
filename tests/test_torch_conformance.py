"""The conformance sweep's cases (``speck_tpu_torch.probes.conformance``)
against speck_tpu on the CPU.

Seeds of the sweep's own generator, at a few fixed sizes (``DIMS``, so
that the reference's compiles are shared), go through ``speck_tpu`` (JAX
on the CPU, as its own tests run it; float64 under ``jax_enable_x64``,
restored after) and through the port with ``device="cpu"``: the same
entry point, value types and knobs. Held equal: the plan fields
(``conformance.plan_fields``; the mesh's meta), C's ``row_offsets`` and
``col_ids``, and a raise (the same exception type). Values: within
1e-6 + 1e-5 sum|a||b| of JAX's in float32 (rtol 1e-5 of the sum of
magnitudes, a sum taken in another order) and 1e-12 sum|a||b| in float64;
the port's C within the sweep's oracle check (rel_tol 2e-3 or 1e-9 of the
scipy oracle of the rounded inputs, 16-bit C within
``compare_csr_bound``).

Standing decisions (ROADMAP.md Queue 3): 6, a value-type pair the
reference refuses, which the port refuses with a TypeError; 10, C's type
on the reference's two-phase, new-value and accumulator paths (A's type;
the port's is the fused path's), where the structure is held equal and
the values to the oracle; 12, the accumulator with a B that has no
nonzeros, where the reference raises a TypeError and the port returns the
empty C, held to the reference's result without the accumulator; 15,
``esc_fixed`` with an operand that has no nonzeros, where the reference
raises a TypeError and the port returns the empty C, held to the
oracle.

The generator itself is checked apart: ``case(seed)`` is a function of the
seed, and the first 300 seeds of the card's range draw every shape class,
knob, value type, entry point and exchange."""

import contextlib
import importlib
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import speck_tpu as st
import speck_tpu.parallel as jp
from speck_tpu.formats.csr import HostCSR as JHostCSR
from speck_tpu.ops import esc as jesc
from speck_tpu.ops.transpose import transpose as jtranspose
from speck_tpu.utils.config import SpgemmConfig as JConfig
from speck_tpu_torch.formats.csr import HostCSR
from speck_tpu_torch.parallel import mesh_stream_to_host_csr
from speck_tpu_torch.probes import conformance as cf

# the sizes the seeds below draw from, and the seeds: every entry point
# (the mesh under each exchange, its dense and diagonal-plane routes and
# the fixed cap), the contiguous and sparse DIA routes, the per-row split,
# the dense tiles, the fused and two-phase stream, direct rows, plan reuse
# with new values, refused value types, empty operands, all four value
# types; chosen among the first 160 seeds for the reference's compile
# time (most seeds compile a new stream plan: 2-6 s each)
DIMS = (24, 80)
SEEDS = [3, 5, 12, 15, 19, 28, 66, 67, 68, 69, 84, 90, 91, 93, 97, 98, 103,
         109, 117, 141, 143, 149]
# the reference's orchestrator module (``speck_tpu.ops.spgemm`` the name is
# its function)
jspgemm = importlib.import_module("speck_tpu.ops.spgemm")
JTYPES = {"float32": jnp.float32, "float64": jnp.float64,
          "float16": jnp.float16, "bfloat16": jnp.bfloat16}


@pytest.fixture(autouse=True)
def one_thread():
    """Thousands of small torch ops: on one thread, since more threads only
    spin-wait at each op when the other test workers keep the cores
    busy."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@contextlib.contextmanager
def _x64(on: bool):
    old = jax.config.read("jax_enable_x64")
    jax.config.update("jax_enable_x64", on)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", old)


def _jhost(h):
    return JHostCSR(rows=h.rows, cols=h.cols, row_offsets=h.row_offsets,
                    col_ids=h.col_ids, data=h.data)


def _host(Cj) -> HostCSR:
    return HostCSR.from_parts(Cj.rows, Cj.cols, Cj.row_offsets, Cj.col_ids,
                              np.asarray(Cj.data, np.float64))


def _name(x) -> str:
    return str(x.dtype)


def _put(c):
    A = st.device_put_csr(_jhost(c.a), JTYPES[c.types[0]])
    B = A if c.b is c.a else st.device_put_csr(_jhost(c.b),
                                               JTYPES[c.types[1]])
    return A, B


def _jax_case(c, knobs):
    """The reference's Outcome of a case (plans recorded as the port's
    are), the raise as its exception type."""
    out = cf.Outcome()
    try:
        if c.entry == "spgemm":
            A, B = _put(c)
            plans = []
            with cf.recording(plans, jspgemm):
                C = st.spgemm(A, B, JConfig(**knobs))
            out.fields = [None if p is None else cf.plan_fields(p)
                          for p in plans]
            out.outs.append(cf.Output("C", _host(st.device_get_csr(C)),
                                      _name(C.data), c.a, c.b))
        elif c.entry == "plan_execute":
            A, B = _put(c)
            plan = st.plan_spgemm(A, B, JConfig(**knobs))
            C1 = plan.execute()
            A2 = st.device_put_csr(_jhost(c.a2), JTYPES[c.types[0]])
            same = c.b is c.a
            C2 = plan.execute(A2, A2 if same else B)
            out.fields = [cf.plan_fields(plan)]
            out.outs += [
                cf.Output("execute()", _host(st.device_get_csr(C1)),
                          _name(C1.data), c.a, c.b),
                cf.Output("execute(A2, B)", _host(st.device_get_csr(C2)),
                          _name(C2.data), c.a2, c.a2 if same else c.b)]
        elif c.entry == "transpose":
            A = st.device_put_csr(_jhost(c.a), JTYPES[c.types[0]])
            T = jtranspose(A)
            out.outs.append(cf.Output("A^T", _host(st.device_get_csr(T)),
                                      _name(T.data)))
        elif c.entry == "esc_fixed":
            cap = cf.fixed_cap(c.a, c.b)
            args = [jnp.asarray(np.asarray(x.double().numpy()
                                           if x.is_floating_point()
                                           else x.numpy()))
                    for x in cf.esc_args(c.a, c.b, "cpu", np.float64)]
            args[2] = args[2].astype(JTYPES[c.types[0]])
            args[6] = args[6].astype(JTYPES[c.types[0]])
            counts, cols, vals = jax.jit(partial(
                jesc.esc_fixed, cap=cap, n_cols=c.b.cols))(*args)
            out.fields = [{"cap": cap, "type": c.types[0]}]
            out.outs.append(cf.Output("C", cf.padded_to_host_csr(
                np.asarray(counts), np.asarray(cols),
                np.asarray(vals, np.float64), c.a.rows, c.b.cols),
                _name(vals), c.a, c.b))
        else:
            mesh = jp.make_row_mesh(c.shards)
            if c.exchange == "fixed_cap":
                counts, cols, vals = jp.mesh_spgemm_fixed_cap(
                    _jhost(c.a), _jhost(c.b), mesh,
                    dtype=JTYPES[c.types[0]])
                out.fields = [{"cap": int(cols.shape[1])}]
                ctype = _name(vals)
                h = cf.padded_to_host_csr(
                    np.asarray(counts), np.asarray(cols),
                    np.asarray(vals, np.float64), c.a.rows, c.b.cols)
            else:
                o = jp.mesh_stream_spgemm(
                    _jhost(c.a), _jhost(c.b), mesh, JConfig(**knobs),
                    exchange=c.exchange, dtype=JTYPES[c.types[0]])
                out.fields = [cf.mesh_fields(o[3])]
                ctype = _name(o[2])
                h = mesh_stream_to_host_csr(
                    np.asarray(o[0]), np.asarray(o[1]),
                    np.asarray(o[2], np.float64), o[3])
            out.outs.append(cf.Output("C", h, ctype, c.a, c.b))
    except (TypeError, ValueError) as e:  # the reference's raise
        out.raised = type(e).__name__
    return out


def reference(c, knobs=None):
    with _x64("float64" in c.types):
        return _jax_case(c, c.knobs if knobs is None else knobs)


def _accum_without_b(c):
    return (c.entry in ("spgemm", "plan_execute") and c.b.nnz == 0
            and c.knobs.get("enable_accum", False))


def _esc_without_nonzeros(c):
    return c.entry == "esc_fixed" and 0 in (c.a.nnz, c.b.nnz)


@pytest.mark.parametrize("seed", SEEDS)
def test_case_matches_the_reference(seed):
    c = cf.case(seed, DIMS)
    got = cf.run_case(c, "cpu")
    ref = reference(c)
    if ref.raised is not None and got.raised is None and _accum_without_b(c):
        # standing decision 12: the reference's accumulator raises on a B
        # without nonzeros; its result without the accumulator is the one
        ref = reference(c, dict(c.knobs, enable_accum=False))
    if ref.raised is not None and got.raised is None \
            and _esc_without_nonzeros(c):
        # standing decision 15: the reference's esc_fixed raises on an
        # operand without nonzeros; the port's C is empty, as the oracle's
        assert ref.raised == "TypeError" and got.outs[0].c.nnz == 0
        assert cf.oracle_diff(c, got.outs[0]) is None
        return
    if ref.raised is not None or got.raised is not None:
        assert got.raised is not None and ref.raised is not None, (
            c.describe(), got.raised, ref.raised)
        # the port refuses value types with a TypeError where the
        # reference raises whatever JAX raises (standing decision 6)
        assert got.raised.split(":")[0] in (ref.raised, "TypeError"), (
            c.describe(), got.raised, ref.raised)
        return
    assert got.fields == ref.fields, (c.describe(), cf.field_diff(
        got.fields, ref.fields))
    assert len(got.outs) == len(ref.outs)
    for x, y in zip(got.outs, ref.outs):
        if x.ctype == y.ctype:
            diff = cf.order_bound_diff(c, x, y.c)
        else:
            # standing decision 10: the reference emits its two-phase,
            # new-value and accumulator paths in A's type, the port in the
            # fused path's (its values are held to the oracle below)
            diff = cf.same_structure(x.c, y.c)
        assert diff is None, (c.describe(), x.label, diff)
        msg = cf.oracle_diff(c, x)
        assert msg is None, (c.describe(), x.label, msg)


def test_generator_is_a_function_of_the_seed():
    """case(seed) twice gives the same case; the first 300 seeds of the
    card's range draw every shape class, knob, value type, entry point and
    exchange (routes are counted on the card, chip_smoke.py phase 8d)."""
    for s in (0, 7, 123, -1, -len(cf.FIXED)):
        x, y = cf.case(s), cf.case(s)
        assert x.describe() == y.describe()
        for u, v in ((x.a, y.a), (x.b, y.b)):
            for f in ("row_offsets", "col_ids", "data"):
                np.testing.assert_array_equal(getattr(u, f), getattr(v, f))
    seen = {k: set() for k in ("shape", "entry", "type", "knob", "exchange")}
    for s in range(300):
        c = cf.case(s)
        seen["shape"].add(c.shape)
        seen["entry"].add(c.entry)
        seen["type"].update(c.types)
        seen["knob"].update(c.knobs)
        seen["exchange"].add(c.exchange)
    assert seen["shape"] == set(cf.SHAPES)
    assert seen["entry"] == set(cf.ENTRIES)
    assert seen["type"] == set(cf.TYPES)
    assert seen["knob"] >= set(cf.KNOBS)
    assert seen["exchange"] >= set(cf.EXCHANGES) | {"fixed_cap"}


def test_device_analysis_is_exact_past_2_24():
    """ROADMAP.md Queue 3 item 14: the device analysis (host_analysis off,
    or past host_analysis_max_nnz) took each row's products as differences
    of a float32 cumulative sum, and the gate its totals as float32 sums:
    past 2^24 products they rounded, on the CPU and the card each in its
    own order, so a route decided at its threshold could differ between
    them. On this band 960 rows' counts were off on the CPU (the first
    read 1088 products for 1089). Every count and total is exact now."""
    band = dict(cf.ANALYSIS_CASES)["band 16384, 33 diagonals"]()
    assert cf.run_analysis_case(band, "cpu") is None
