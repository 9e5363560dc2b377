"""The binder nodes beyond Q1's against ballista_tpu.exprs.bind_expr on the
same seeded batches: NOT, negation, IS [NOT] NULL and their three-valued
logic, BETWEEN, IN over strings, ints and dates, LIKE and NOT LIKE,
numeric and string CASE, extract(year|month|day) over 1900-2100, substring,
coalesce, abs and date +/- interval folding. Exact comparisons of dtype,
nullability, bounds, dictionaries, values and validity; and the LIKE
lookup table against pyarrow's match_like."""

import numpy as np
import pyarrow as pa
import pyarrow.compute as pc
import pytest
import torch

import jax.numpy as jnp

from ballista_tpu import batch as JB
from ballista_tpu import exprs as JE
from ballista_tpu import schema as JS
from ballista_tpu_torch import batch as TB
from ballista_tpu_torch import exprs as TE
from ballista_tpu_torch import schema as TS
from ballista_tpu_torch.datagen import generate_tpch

torch.set_num_threads(2)

N = 3000
WORDS = np.array(sorted(["", "a", "abc", "abd", "b_c", "b%c", "banana",
                         "special packages nag requests", "special requests",
                         "x.y", "x+y", "line\nbreak", "MAIL", "SHIP",
                         "13-555-100-2000", "31-555-100-2001", "9"]),
                 dtype=object)
MODES = np.array(["AIR", "MAIL", "SHIP", "TRUCK"], dtype=object)
D_LO = (np.datetime64("1900-01-01") - np.datetime64("1970-01-01")).astype(int)
D_HI = (np.datetime64("2100-12-31") - np.datetime64("1970-01-01")).astype(int)


def _schemas():
    def make(S):
        fields = (S.Field("s", S.STRING), S.Field("mode", S.STRING),
                  S.Field("k", S.INT64), S.Field("i", S.INT32),
                  S.Field("d", S.DATE32), S.Field("m", S.decimal(15, 2)),
                  S.Field("f", S.FLOAT64), S.Field("flag", S.BOOL))
        return S.Schema(fields, {"s": WORDS, "mode": MODES},
                        {"d": (int(D_LO), int(D_HI)), "k": (-50, 50)})
    return make(JS), make(TS)


def _batches(seed):
    rng = np.random.default_rng(seed)
    days = rng.integers(D_LO, D_HI + 1, N).astype(np.int32)
    # every Feb 28/29/Mar 1 and year boundary of a few leap-rule years
    edges = [np.datetime64(f"{y}-{md}") for y in (1900, 1904, 1999, 2000,
                                                  2024, 2100)
             for md in ("01-01", "02-28", "03-01", "12-31")]
    edges += [np.datetime64(f"{y}-02-29") for y in (1904, 2000, 2024)]
    days[:len(edges)] = [(e - np.datetime64("1970-01-01")).astype(int)
                         for e in edges]
    cols = [rng.integers(0, len(WORDS), N).astype(np.int32),
            rng.integers(0, len(MODES), N).astype(np.int32),
            rng.integers(-50, 51, N), rng.integers(-9, 10, N).astype(np.int32),
            days, rng.integers(-10 ** 6, 10 ** 6, N),
            rng.normal(0, 100, N), rng.random(N) > 0.5]
    valid = [rng.random(N) > 0.15 for _ in cols]
    valid[4][:len(edges)] = True
    jschema, tschema = _schemas()
    cap = JB.round_capacity(N)
    jb = JB.Batch(tuple(JB.make_column(c, v, f.dtype, cap)
                        for c, v, f in zip(cols, valid, jschema.fields)),
                  jnp.int32(N))
    tb = TB.Batch(tuple(TB.make_column(c, v, f.dtype, cap, "cpu")
                        for c, v, f in zip(cols, valid, tschema.fields)),
                  torch.tensor(N, dtype=torch.int32))
    return jschema, tschema, jb, tb


def _expr(E, name):
    """One expression, built from either package's classes."""
    C, L, B = E.Col, E.Lit, E.BinOp
    date = lambda s: L(s, E.DATE32)  # noqa: E731
    pos = B(">", C("k"), L(0))
    return {
        "not": E.Not(pos),
        "not_not": E.Not(E.Not(B("<", C("m"), L(0)))),
        "not_and_null": E.Not(B("and", pos, B("=", C("s"), L("abc")))),
        "neg_int": E.Neg(C("k")),
        "neg_decimal": E.Neg(C("m")),
        "is_null": E.IsNull(C("k")),
        "is_not_null": E.IsNull(C("s"), negated=True),
        "is_null_of_expr": E.IsNull(B("+", C("k"), C("i"))),
        "not_is_null": E.Not(E.IsNull(C("d"))),
        "between": E.Between(C("k"), L(-10), L(20)),
        "not_between": E.Between(C("k"), L(-10), L(20), negated=True),
        "between_dates": E.Between(C("d"), date("1995-01-01"),
                                   date("1996-12-31")),
        "between_strings": E.Between(C("s"), L("abc"), L("special")),
        "in_strings": E.InList(C("s"), (L("abc"), L("b%c"), L("missing"),
                                        L("9"))),
        "not_in_strings": E.InList(C("mode"), (L("MAIL"), L("SHIP")),
                                   negated=True),
        "in_ints": E.InList(C("k"), (L(1), L(-3), L(7), L(99))),
        "not_in_ints32": E.InList(C("i"), (L(0), L(5)), negated=True),
        "in_dates": E.InList(C("d"), (date("2000-02-29"), date("1900-01-01"),
                                      date("2024-12-31"))),
        "like_inner": E.Like(C("s"), "%special%requests%"),
        "like_prefix": E.Like(C("s"), "ab%"),
        "like_suffix": E.Like(C("s"), "%c"),
        "like_underscore": E.Like(C("s"), "b_c"),
        "not_like": E.Like(C("s"), "%a%", negated=True),
        "case_int": E.Case(((B("or", B("=", C("mode"), L("MAIL")),
                                B("=", C("mode"), L("SHIP"))), L(1)),),
                           L(0)),
        "case_mixed": E.Case(((pos, C("m")), (B("<", C("k"), L(-40)), C("k"))),
                             None),
        "case_float": E.Case(((E.IsNull(C("k")), C("f")),), C("i")),
        "case_string": E.Case(((pos, C("mode")), (B(">", C("i"), L(3)),
                                                  L("zzz"))), C("s")),
        "year": E.ScalarFn("extract_year", (C("d"),)),
        "month": E.ScalarFn("extract_month", (C("d"),)),
        "day": E.ScalarFn("extract_day", (C("d"),)),
        "substring": E.ScalarFn("substring", (C("s"), L(1), L(2))),
        "substring_mid": E.ScalarFn("substring", (C("s"), L(3), L(4))),
        "coalesce": E.ScalarFn("coalesce", (C("k"), C("i"), L(-1))),
        "coalesce_decimal": E.ScalarFn("coalesce", (C("m"), C("k"))),
        "abs_int": E.ScalarFn("abs", (C("i"),)),
        "abs_decimal": E.ScalarFn("abs", (C("m"),)),
        "plus_months": B("<", C("d"), B("+", date("1996-01-01"),
                                        E.IntervalLit(months=3))),
        "minus_days": B(">=", C("d"), B("-", date("1998-12-01"),
                                        E.IntervalLit(days=90))),
        "month_end": B("=", C("d"), B("+", date("2000-01-31"),
                                      E.IntervalLit(months=1))),
        "minus_years": B(">", C("d"), B("-", date("2024-02-29"),
                                        E.IntervalLit(months=12))),
    }[name]


NAMES = sorted([
    "not", "not_not", "not_and_null", "neg_int", "neg_decimal", "is_null",
    "is_not_null", "is_null_of_expr", "not_is_null", "between", "not_between",
    "between_dates", "between_strings", "in_strings", "not_in_strings",
    "in_ints", "not_in_ints32", "in_dates", "like_inner", "like_prefix",
    "like_suffix", "like_underscore", "not_like", "case_int", "case_mixed",
    "case_float", "case_string", "year", "month", "day", "substring",
    "substring_mid", "coalesce", "coalesce_decimal", "abs_int",
    "abs_decimal", "plus_months", "minus_days", "month_end", "minus_years"])


def _decoded(data, dictionary):
    return data if dictionary is None else np.asarray(dictionary)[data]


@pytest.mark.parametrize("name", NAMES)
def test_bound_node_matches_jax(name):
    jschema, tschema, jb, tb = _batches(seed=len(name))
    jbound = JE.bind_expr(_expr(JE, name), jschema)
    tbound = TE.bind_expr(_expr(TE, name), tschema)
    assert repr(tbound.dtype) == repr(jbound.dtype)
    assert tbound.nullable == jbound.nullable
    assert tbound.int_bound == jbound.int_bound
    assert tbound.code_bound == jbound.code_bound
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
    np.testing.assert_array_equal(_decoded(td, tbound.dictionary),
                                  _decoded(jd, jbound.dictionary))
    assert td.dtype == jd.dtype or tbound.dtype.kind is TS.TypeKind.STRING


def test_three_valued_not_and_is_null():
    """NOT keeps NULL; IS [NOT] NULL is never NULL."""
    _, tschema, _, tb = _batches(seed=1)
    n = TE.bind_expr(TE.Not(TE.BinOp(">", TE.Col("k"), TE.Lit(0))), tschema)
    k_valid = tb.columns[2].validity[:N]
    assert torch.equal(n.fn(tb).validity[:N], k_valid)
    isn = TE.bind_expr(TE.IsNull(TE.Col("k")), tschema).fn(tb)
    assert bool(isn.validity[:N].all())
    assert torch.equal(isn.data[:N], ~k_valid)


def test_extract_matches_calendar():
    """extract(year|month|day) against Python's calendar over 1900-2100."""
    _, tschema, _, tb = _batches(seed=3)
    days = tb.columns[4].data[:N].numpy()
    dates = (np.datetime64("1970-01-01") + days.astype("timedelta64[D]")
             ).astype(object)
    for part in ("year", "month", "day"):
        b = TE.bind_expr(TE.ScalarFn(f"extract_{part}", (TE.Col("d"),)),
                         tschema)
        got = b.fn(tb).data[:N].numpy()
        assert got.tolist() == [getattr(x, part) for x in dates], part


def test_unported_scalar_fn_names_itself():
    _, tschema = _schemas()
    with pytest.raises(NotImplementedError, match="soundex"):
        TE.bind_expr(TE.ScalarFn("soundex", (TE.Col("s"),)), tschema)
    with pytest.raises(NotImplementedError, match="non-literal"):
        TE.bind_expr(TE.BinOp("+", TE.Col("d"), TE.IntervalLit(months=1)),
                     tschema)


PATTERNS = ["%special%requests%", "special%", "%requests", "%", "", "_",
            "__", "%a%", "a%c", "_b%", "%_", "b_c", "b%c", "x.y", "x+y",
            "%.%", "%+%", "(%)", "line%", "%break", "%\n%", "13%", "[%]",
            "%1__-%", "%Customer%Complaints%", "%furious%"]


def _dictionaries():
    tables = generate_tpch(0.01, tables=["supplier", "customer", "orders"])
    out = {"test": WORDS, "modes": MODES, "empty": np.array([], dtype=object)}
    for t, c in (("orders", "o_comment"), ("supplier", "s_comment"),
                 ("customer", "c_phone"), ("customer", "c_comment")):
        out[c] = tables[t][1][c].dictionary
    return out


@pytest.mark.parametrize("dic_name", ["test", "modes", "empty", "o_comment",
                                      "s_comment", "c_phone", "c_comment"])
def test_like_lut_matches_pyarrow(dic_name):
    dic = _dictionaries()[dic_name]
    for pattern in PATTERNS:
        got = TE.like_lut(dic, pattern)
        want = (np.asarray(pc.match_like(pa.array(dic.astype(str),
                                                  type=pa.string()), pattern))
                .astype(bool) if len(dic) else np.zeros(0, bool))
        np.testing.assert_array_equal(got, want, err_msg=repr(pattern))
