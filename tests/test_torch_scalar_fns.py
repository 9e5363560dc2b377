"""The scalar functions and literals this slice ported, against
ballista_tpu.exprs.bind_expr on the same seeded batches with NULLs: float
literals and their coercions, date_trunc over 1900-2100, floor, ceil,
round (negative halves included) and sqrt, the dictionary string
functions (with results that fold several values into one), length and
its aliases, concat and registered UDFs.

Ints, decimals, dates, strings and validity compare exactly. Float
outputs compare NaN-aware at rtol 1e-6 for FLOAT32 and 1e-12 for
FLOAT64."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ballista_tpu import batch as JB
from ballista_tpu import exprs as JE
from ballista_tpu import schema as JS
from ballista_tpu_torch import batch as TB
from ballista_tpu_torch import exprs as TE
from ballista_tpu_torch import schema as TS
from ballista_tpu_torch.client import SessionContext

torch.set_num_threads(2)

N = 2000
RTOL = {"float32": 1e-6, "float64": 1e-12}
# upper/lower/trim fold several of these into one value
WORDS = np.array(sorted(["", " ", "  pad ", "ABC", "Abc", "abc", "abc ",
                         " abc", "forest green", "Forest", "MAIL", "mail",
                         "x.y", "héllo", "ß", "a-b-a", "abba"]), dtype=object)
CODES = np.array(sorted(["A", "B", "C"]), dtype=object)
D_LO = (np.datetime64("1900-01-01") - np.datetime64("1970-01-01")).astype(int)
D_HI = (np.datetime64("2100-12-31") - np.datetime64("1970-01-01")).astype(int)


def _schemas():
    def make(S):
        fields = (S.Field("s", S.STRING), S.Field("c", S.STRING),
                  S.Field("k", S.INT64), S.Field("i", S.INT32),
                  S.Field("d", S.DATE32), S.Field("m", S.decimal(15, 2)),
                  S.Field("f", S.FLOAT64), S.Field("g", S.FLOAT32))
        return S.Schema(fields, {"s": WORDS, "c": CODES},
                        {"d": (int(D_LO), int(D_HI)), "k": (-50, 50)})
    return make(JS), make(TS)


def _batches(seed):
    rng = np.random.default_rng(seed)
    days = rng.integers(D_LO, D_HI + 1, N).astype(np.int32)
    edges = [np.datetime64(f"{y}-{md}") for y in (1900, 1904, 1969, 1970,
                                                  2000, 2024, 2100)
             for md in ("01-01", "02-28", "03-01", "12-31")]
    edges += [np.datetime64(f"{y}-02-29") for y in (1904, 2000, 2024)]
    days[:len(edges)] = [(e - np.datetime64("1970-01-01")).astype(int)
                         for e in edges]
    # decimals and floats with exact halves, negative ones included
    halves = np.array([-250, -150, -50, 50, 150, 250, -1, 0, 1])
    m = rng.integers(-10 ** 6, 10 ** 6, N)
    m[:len(halves)] = halves
    f = rng.normal(0, 100, N)
    f[:8] = [-2.5, -1.5, -0.5, 0.5, 1.5, 2.5, -0.0, 16.0]
    cols = [rng.integers(0, len(WORDS), N).astype(np.int32),
            rng.integers(0, len(CODES), N).astype(np.int32),
            rng.integers(-50, 51, N), rng.integers(-9, 10, N).astype(np.int32),
            days, m, f, rng.normal(0, 10, N).astype(np.float32)]
    valid = [rng.random(N) > 0.15 for _ in cols]
    for v in valid[4:]:
        v[:len(edges)] = True
    jschema, tschema = _schemas()
    cap = JB.round_capacity(N)
    jb = JB.Batch(tuple(JB.make_column(c, v, f.dtype, cap)
                        for c, v, f in zip(cols, valid, jschema.fields)),
                  jnp.int32(N))
    tb = TB.Batch(tuple(TB.make_column(c, v, f.dtype, cap, "cpu")
                        for c, v, f in zip(cols, valid, tschema.fields)),
                  torch.tensor(N, dtype=torch.int32))
    return jschema, tschema, jb, tb


def _expr(E, S, name):
    C, L, B, F = E.Col, E.Lit, E.BinOp, E.ScalarFn
    return {
        "float_lit": L(2.5),
        "float32_lit": L(0.25, S.FLOAT32),
        "int_plus_float": B("+", C("k"), L(0.5)),
        "decimal_times_float": B("*", C("m"), L(1.5)),   # FLOAT32
        "float32_plus_float64": B("+", C("g"), L(1.25)),  # FLOAT64 wins
        "float_compare": B(">", C("f"), L(-12.75)),
        "decimal_lt_float": B("<", C("m"), L(100.5)),
        "trunc_year": F("date_trunc", (L("year"), C("d"))),
        "trunc_month": F("date_trunc", (L("MONTH"), C("d"))),
        "floor_decimal": F("floor", (C("m"),)),
        "ceil_decimal": F("ceil", (C("m"),)),
        "ceiling_float": F("ceiling", (C("f"),)),
        "round_decimal": F("round", (C("m"),)),
        "round_float": F("round", (C("f"),)),
        "round_float32": F("round", (C("g"),)),
        "round_int": F("round", (C("k"),)),
        "floor_int32": F("floor", (C("i"),)),
        "sqrt_float": F("sqrt", (C("f"),)),
        "sqrt_int": F("sqrt", (C("k"),)),
        "sqrt_decimal": F("sqrt", (C("m"),)),
        "upper": F("upper", (C("s"),)),
        "lower": F("lower", (C("s"),)),
        "trim": F("trim", (C("s"),)),
        "ltrim": F("ltrim", (C("s"),)),
        "rtrim": F("rtrim", (C("s"),)),
        "reverse": F("reverse", (C("s"),)),
        "replace": F("replace", (C("s"), L("b"), L("XY"))),
        "replace_to_empty": F("replace", (C("s"), L("a"), L(""))),
        "length": F("length", (C("s"),)),
        "char_length": F("char_length", (C("s"),)),
        "character_length": F("character_length", (C("s"),)),
        "octet_length": F("octet_length", (C("s"),)),
        "concat_lit": F("concat", (L("<"), C("s"), L(">"))),
        "concat_two": F("concat", (C("c"), L("-"), C("s"))),
        "upper_eq": B("=", F("upper", (C("s"),)), L("ABC")),
        "length_gt": B(">", F("length", (C("s"),)), L(3)),
    }[name]


NAMES = sorted([
    "float_lit", "float32_lit", "int_plus_float", "decimal_times_float",
    "float32_plus_float64", "float_compare", "decimal_lt_float",
    "trunc_year", "trunc_month", "floor_decimal", "ceil_decimal",
    "ceiling_float", "round_decimal", "round_float", "round_float32",
    "round_int", "floor_int32", "sqrt_float", "sqrt_int", "sqrt_decimal",
    "upper", "lower", "trim", "ltrim", "rtrim", "reverse", "replace",
    "replace_to_empty", "length", "char_length", "character_length",
    "octet_length", "concat_lit", "concat_two", "upper_eq", "length_gt"])


def _decoded(data, dictionary):
    return data if dictionary is None else np.asarray(dictionary)[data]


def _assert_same_values(td, jd, dtype_kind):
    if dtype_kind in ("float32", "float64"):
        np.testing.assert_allclose(td, jd, rtol=RTOL[dtype_kind],
                                   equal_nan=True)
    else:
        np.testing.assert_array_equal(td, jd)


def _check(jbound, tbound, jb, tb):
    assert repr(tbound.dtype) == repr(jbound.dtype)
    assert tbound.nullable == jbound.nullable
    assert tbound.int_bound == jbound.int_bound
    assert tbound.code_bound == jbound.code_bound
    assert tbound.ndv_bound == jbound.ndv_bound
    if jbound.dictionary is None:
        assert tbound.dictionary is None
    else:
        assert list(tbound.dictionary) == list(jbound.dictionary)
    jc, tc = jbound.fn(jb), tbound.fn(tb)
    jv = np.broadcast_to(np.asarray(jc.validity), (jb.capacity,))[:N]
    tv = tc.validity.expand(tb.capacity)[:N].numpy()
    np.testing.assert_array_equal(tv, jv)
    jd = np.broadcast_to(np.asarray(jc.data), (jb.capacity,))[:N][jv]
    td = tc.data.expand(tb.capacity)[:N].numpy()[jv]
    assert td.dtype == jd.dtype
    _assert_same_values(_decoded(td, tbound.dictionary),
                        _decoded(jd, jbound.dictionary),
                        tbound.dtype.kind.value)


@pytest.mark.parametrize("name", NAMES)
def test_scalar_fn_matches_jax(name):
    jschema, tschema, jb, tb = _batches(seed=len(name))
    _check(JE.bind_expr(_expr(JE, JS, name), jschema),
           TE.bind_expr(_expr(TE, TS, name), tschema), jb, tb)


def test_string_functions_fold_values():
    """upper, lower and trim map several dictionary entries to one: the
    new dictionary holds each result once, and equal results share a
    code."""
    _, tschema, _, tb = _batches(seed=7)
    for fn, want in (("upper", "ABC"), ("lower", "abc"), ("trim", "abc")):
        b = TE.bind_expr(TE.ScalarFn(fn, (TE.Col("s"),)), tschema)
        assert len(set(b.dictionary)) == len(b.dictionary) < len(WORDS)
        codes = b.fn(tb).data[:N].numpy()
        src = WORDS[tb.columns[0].data[:N].numpy()]
        folded = {"upper": str.upper, "lower": str.lower,
                  "trim": str.strip}[fn]
        hit = np.array([folded(s) == want for s in src])
        assert hit.sum() > 0
        assert set(b.dictionary[codes[hit]]) == {want}


def test_date_trunc_matches_calendar():
    _, tschema, _, tb = _batches(seed=3)
    days = tb.columns[4].data[:N].numpy()
    dates = (np.datetime64("1970-01-01") + days.astype("timedelta64[D]"))
    for unit, np_unit in (("year", "Y"), ("month", "M")):
        b = TE.bind_expr(TE.ScalarFn("date_trunc", (TE.Lit(unit),
                                                    TE.Col("d"))), tschema)
        want = (dates.astype(f"datetime64[{np_unit}]").astype("datetime64[D]")
                - np.datetime64("1970-01-01")).astype(int)
        np.testing.assert_array_equal(b.fn(tb).data[:N].numpy(), want)


def test_date_trunc_unit_must_be_year_or_month():
    jschema, tschema = _schemas()
    for E, schema in ((JE, jschema), (TE, tschema)):
        with pytest.raises(NotImplementedError, match="date_trunc unit"):
            E.bind_expr(E.ScalarFn("date_trunc", (E.Lit("week"),
                                                  E.Col("d"))), schema)


@pytest.mark.parametrize("propagate", [True, False])
def test_udf_matches_jax(propagate):
    """A UDF registered in both packages: the same arithmetic on torch
    tensors and on jax arrays, NULLs propagated or not."""
    name = f"scaled_sum_{int(propagate)}"
    JE.register_udf(name, lambda k, f: k * 3 + f, JS.FLOAT64, propagate)
    TE.register_udf(name, lambda k, f: k * 3 + f, TS.FLOAT64, propagate)
    jschema, tschema, jb, tb = _batches(seed=11)
    _check(JE.bind_expr(JE.ScalarFn(name, (JE.Col("k"), JE.Col("f"))),
                        jschema),
           TE.bind_expr(TE.ScalarFn(name.upper(), (TE.Col("k"),
                                                   TE.Col("f"))), tschema),
           jb, tb)


def test_udf_from_sql():
    """SessionContext.register_udf makes the function callable from SQL."""
    from ballista_tpu_torch.datagen import register_tpch
    ctx = SessionContext(device="cpu")
    register_tpch(ctx, 0.01, tables=["nation"])
    ctx.register_udf("plus_ten", lambda x: x + 10, TS.INT64)
    got = ctx.sql("select n_nationkey, plus_ten(n_nationkey) as p "
                  "from nation order by n_nationkey").to_numpy()
    np.testing.assert_array_equal(got["p"][0], got["n_nationkey"][0] + 10)
