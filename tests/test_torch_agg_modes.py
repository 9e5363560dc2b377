"""HashAggregateExec's two-phase modes: `partial` over each half of a table,
CoalesceExec, `final`, in ballista_tpu_torch on the CPU. Per aggregate kind
and layout (masked: a dictionary key; sorted: an int key; no key) the
result equals the port's `single` aggregate over the whole table and the
same partial -> final plan of ballista_tpu on JAX-CPU.

Tolerances: validity, integers, decimals, dates and dictionary codes are
exact; f64 sums, moments and corr are held at rtol 1e-9 (the two phases add
the same values in another order)."""

import decimal

import numpy as np
import pyarrow as pa
import pytest
import torch

from ballista_tpu import batch as JB
from ballista_tpu import exprs as JE
from ballista_tpu.exec import aggregate as JA
from ballista_tpu.exec import plan as JP
from ballista_tpu_torch import exprs as TE
from ballista_tpu_torch.batch import to_numpy as port_to_numpy
from ballista_tpu_torch.client import SessionContext
from ballista_tpu_torch.exec import aggregate as TA
from ballista_tpu_torch.exec import plan as TP
from test_torch_joins import _port_columns

torch.set_num_threads(2)

RTOL = 1e-9
N = 900


def _table():
    rng = np.random.default_rng(11)
    fv = rng.normal(10, 4, N)
    iv = rng.integers(-50, 50, N)
    nulls = rng.random(N) < 0.15
    return pa.table({
        # every value in each half, so both halves ingest one dictionary
        "s": pa.array(np.tile(["x", "y", "z"], N // 3)),
        "k": pa.array(rng.integers(0, 40, N), pa.int64()),
        "w": pa.array(np.tile(["kiwi", "apple", "fig", "lime", "pear"],
                              N // 5)),
        "i": pa.array(np.where(nulls, None, iv), pa.int64()),
        "f": pa.array(np.where(nulls, None, fv), pa.float64()),
        "f2": pa.array(fv * 0.5 + rng.normal(0, 1, N), pa.float64()),
        "d": pa.array([decimal.Decimal(int(v)).scaleb(-2)
                       for v in rng.integers(0, 10 ** 5, N)],
                      pa.decimal128(15, 2)),
        # constant within each k: what `carry` is for
        "c": pa.array(rng.integers(0, 40, N) * 0 + 7, pa.int64()),
    })


# name -> (kind, argument, second argument)
AGGS = {
    "sum_i": ("sum", "i", None), "sum_d": ("sum", "d", None),
    "sum_f": ("sum", "f", None),
    "count_i": ("count", "i", None), "count_star": ("count_star", None, None),
    "avg_i": ("avg", "i", None), "avg_d": ("avg", "d", None),
    "avg_f": ("avg", "f", None),
    "min_i": ("min", "i", None), "max_f": ("max", "f", None),
    "min_w": ("min", "w", None), "max_w": ("max", "w", None),
    "carry_c": ("carry", "c", None),
    "var_samp_f": ("var_samp", "f", None), "var_pop_d": ("var_pop", "d", None),
    "stddev_samp_i": ("stddev_samp", "i", None),
    "stddev_pop_f": ("stddev_pop", "f", None),
    "corr_f": ("corr", "f", "f2"),
}
LAYOUTS = {"masked": ["s"], "sorted": ["k"], "no_key": []}


def _specs(A, E):
    return [A.AggExpr(kind, E.Col(arg) if arg else None, alias=name,
                      arg2=E.Col(arg2) if arg2 else None)
            for name, (kind, arg, arg2) in AGGS.items()]


def _two_phase(P, A, E, leaves, keys, aggs=None):
    aggs = aggs or _specs(A, E)
    parts = [P.HashAggregateExec(leaf, [E.Col(k) for k in keys], aggs,
                                 mode="partial") for leaf in leaves]
    both = P.CoalesceExec(parts)
    final = P.HashAggregateExec(both, [E.Col(k) for k in keys], aggs,
                                mode="final", group_names=keys)
    return P.SortExec(final, [(E.Col(k), True, None) for k in keys]), parts


@pytest.fixture(scope="module")
def results():
    """layout -> (port two-phase, port single, JAX two-phase), each as
    {column: (values, validity)}, and the port's plans."""
    table = _table()
    halves = {"a": table.slice(0, N // 2), "b": table.slice(N // 2)}
    tctx = SessionContext(device="cpu")
    for name, t in {**halves, "t": table}.items():
        tctx.register_host(name, *_port_columns(t))
    tinputs = {n: tctx.tables[n].column_batch(table.column_names)
               for n in ("a", "b", "t")}
    jinputs, jschemas = {}, {}
    for name, t in halves.items():
        jinputs[name], jschemas[name] = JB.from_arrow(t)
    out = {}
    for layout, keys in LAYOUTS.items():
        tleaves = [TP.InputLeaf(n, tctx.tables[n].schema,
                                tctx.tables[n].capacity) for n in ("a", "b")]
        tplan, tparts = _two_phase(TP, TA, TE, tleaves, keys)
        tbatch, overflow = TP.run_plan(tplan, tinputs)
        assert overflow is None or not bool(overflow)
        whole = TP.InputLeaf("t", tctx.tables["t"].schema,
                             tctx.tables["t"].capacity)
        single = TP.SortExec(
            TP.HashAggregateExec(whole, [TE.Col(k) for k in keys],
                                 _specs(TA, TE), mode="single"),
            [(TE.Col(k), True, None) for k in keys])
        sbatch, _ = TP.run_plan(single, tinputs)
        jleaves = [JP.InputLeaf(n, jschemas[n], jinputs[n].capacity)
                   for n in ("a", "b")]
        jplan, _ = _two_phase(JP, JA, JE, jleaves, keys)
        fn, _ = JP.compile_stage(jplan)
        jbatch = fn(jinputs)
        out[layout] = (port_to_numpy(tbatch, tplan.schema),
                       port_to_numpy(sbatch, single.schema),
                       JB.to_numpy(jbatch, jplan.schema),
                       tplan, tparts, jplan)
    return out


def _check(got, want, name):
    gv, gvalid = got[name]
    wv, wvalid = want[name]
    np.testing.assert_array_equal(gvalid, wvalid, err_msg=name)
    if gv.dtype.kind == "f":
        np.testing.assert_allclose(gv[gvalid], wv[wvalid], rtol=RTOL, atol=0,
                                   err_msg=name)
    else:
        np.testing.assert_array_equal(gv[gvalid], wv[wvalid], err_msg=name)
    return gvalid


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("name", sorted(AGGS))
def test_partial_final_equals_single_and_jax(results, layout, name):
    two, single, jax_two = results[layout][:3]
    n_groups = {"masked": 3, "sorted": 40, "no_key": 1}[layout]
    for k in LAYOUTS[layout]:
        assert _check(two, single, k).sum() == n_groups
        _check(two, jax_two, k)
    assert _check(two, single, name).shape == (n_groups,)
    assert _check(two, jax_two, name).any()


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_schemas_match_jax(results, layout):
    """Partial state fields, final output fields, and the dictionary a
    string min/max carries under `name#s0` between the phases."""
    tplan, tparts, jplan = results[layout][3:]
    jfinal = jplan.children[0]
    jpart = jfinal.children[0].children[0]
    for tnode, jnode in ((tplan.children[0], jfinal), (tparts[0], jpart)):
        assert [(f.name, repr(f.dtype), f.nullable)
                for f in tnode.schema.fields] == \
            [(f.name, repr(f.dtype), f.nullable) for f in jnode.schema.fields]
        assert sorted(tnode.schema.dictionaries) == \
            sorted(jnode.schema.dictionaries)
    part = tparts[0].schema
    assert list(part.dictionary("min_w#s0")) == ["apple", "fig", "kiwi",
                                                 "lime", "pear"]
    assert part.int_bound("min_i#s0") is not None
    final = tplan.children[0].schema
    assert list(final.dictionary("max_w")) == list(part.dictionary("max_w#s0"))
    assert final.int_bound("min_i") == part.int_bound("min_i#s0")
    names = [f.name for f in part.fields]
    assert "corr_f#s5" in names and "var_samp_f#s2" in names


def test_masked_final_rides_one_fused_call(results, monkeypatch):
    """In the masked layout the final mode's merges of int64 sums and
    counts are rows of ONE masked_slot_sums_rows call, as single mode's
    are: count(*) first, then each int64 state column once (plus a count
    row where the merged sum can be NULL)."""
    tplan = results["masked"][3]
    final = tplan.children[0]
    assert final.mode == "final" and final._masked and final.T == 4
    calls = []
    real = TP.masked_slot_sums_rows

    def spy(row_slot, rows, T):
        calls.append((row_slot, list(rows), T))
        return real(row_slot, rows, T)

    monkeypatch.setattr(TP, "masked_slot_sums_rows", spy)
    table = _table()
    tctx = SessionContext(device="cpu")
    for name, t in (("a", table.slice(0, N // 2)), ("b", table.slice(N // 2))):
        tctx.register_host(name, *_port_columns(t))
    inputs = {n: tctx.tables[n].column_batch(table.column_names)
              for n in ("a", "b")}
    TP.run_plan(tplan, inputs)
    # two partial aggregates and the final one: one call each from
    # _aggregate; min/max/float kinds make their own through MaskedLayout
    fused = [c for c in calls if c[1][0] == (None, None) and len(c[1]) > 2]
    assert len(fused) == 3
    row_slot, rows, T = fused[-1]
    assert T == 4 and row_slot.shape[0] == 256      # two 128-row partials
    # sum_i, sum_d, avg_i, avg_d: a sum row and a validity count row each;
    # count_i, count_star and the two avg counts: a sum row alone
    assert len(rows) == 1 + 4 * 2 + 4
    assert all(data is None or data.dtype == torch.int64 for data, _ in rows)


@pytest.mark.parametrize("kind", ["median", "percentile"])
def test_non_decomposable_final_raises(kind):
    """A percentile's state cannot be merged: the final mode raises, as the
    reference's does."""
    table = _table()
    tctx = SessionContext(device="cpu")
    tctx.register_host("a", *_port_columns(table))
    tinputs = {"a": tctx.tables["a"].column_batch(table.column_names)}
    jbatch, jschema = JB.from_arrow(table)
    for P, A, E, leaf, inputs in (
            (TP, TA, TE, TP.InputLeaf("a", tctx.tables["a"].schema,
                                      tctx.tables["a"].capacity), tinputs),
            (JP, JA, JE, JP.InputLeaf("a", jschema, jbatch.capacity),
             {"a": jbatch})):
        aggs = [A.AggExpr(kind, E.Col("f"), alias="m", frac=0.5)]
        plan, _ = _two_phase(P, A, E, [leaf], ["s"], aggs)
        with pytest.raises(NotImplementedError, match="cannot be merged"):
            if P is TP:
                TP.run_plan(plan, inputs)
            else:
                JP.compile_stage(plan)[0](inputs)


def test_unknown_mode_raises():
    tctx = SessionContext(device="cpu")
    tctx.register_host("a", *_port_columns(_table()))
    leaf = TP.InputLeaf("a", tctx.tables["a"].schema, tctx.tables["a"].capacity)
    with pytest.raises(ValueError, match="unknown mode"):
        TP.HashAggregateExec(leaf, [], [], mode="merge")
