"""ballista_tpu_torch.exprs against ballista_tpu.exprs: Q1's decimal
expressions, comparisons, Kleene logic, half-away-from-zero rounding and
both branches of the scaled long division. Exact comparisons."""

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

torch.set_num_threads(2)

N = 3000


def _schemas():
    """Q1's lineitem columns (plus a nullable int) in both packages."""
    def make(S):
        money = S.decimal(15, 2)
        fields = (S.Field("l_quantity", money), S.Field("l_extendedprice", money),
                  S.Field("l_discount", money), S.Field("l_tax", money),
                  S.Field("l_returnflag", S.STRING),
                  S.Field("l_shipdate", S.DATE32), S.Field("k", S.INT64))
        return S.Schema(fields, {"l_returnflag": np.array(["A", "N", "R"],
                                                          dtype=object)})
    return make(JS), make(TS)


def _columns(seed):
    rng = np.random.default_rng(seed)
    cols = [rng.integers(100, 5001, N), rng.integers(90000, 10_500_000, N),
            rng.integers(0, 11, N), rng.integers(0, 9, N),
            rng.integers(0, 3, N).astype(np.int32),
            rng.integers(8000, 10600, N).astype(np.int32),
            rng.integers(-10 ** 6, 10 ** 6, N)]
    valid = [rng.random(N) > 0.1 for _ in cols]
    return cols, valid


def _batches(cols, valid, jschema, tschema):
    cap = JB.round_capacity(N)
    jb = JB.Batch(tuple(JB.make_column(c, v, f.dtype, cap)
                        for c, v, f in zip(cols, valid, jschema.fields)),
                  jnp.int32(N))
    tb = TB.Batch(tuple(TB.make_column(c, v, f.dtype, cap, "cpu")
                        for c, v, f in zip(cols, valid, tschema.fields)),
                  torch.tensor(N, dtype=torch.int32))
    return jb, tb


def _expr(E, text):
    """One expression spec, built from either package's classes."""
    C, L, B = E.Col, E.Lit, E.BinOp
    dec = lambda v: L(v, E.decimal(15, 2))  # noqa: E731
    return {
        "disc_price": B("*", C("l_extendedprice"), B("-", L(1), C("l_discount"))),
        "charge": B("*", B("*", C("l_extendedprice"),
                           B("-", L(1), C("l_discount"))),
                    B("+", L(1), C("l_tax"))),
        "shipdate_le": B("<=", C("l_shipdate"), L("1998-09-02", E.DATE32)),
        "and_or": B("or", B("and", B("<", C("l_quantity"), dec("24.00")),
                            B(">=", C("l_discount"), dec("0.05"))),
                    B(">", C("k"), L(0))),
        "div": B("/", C("l_extendedprice"), C("l_quantity")),
        "mod": B("%", C("k"), L(7)),
        "int_div": B("/", C("k"), L(-3)),
        "flag_eq": B("=", C("l_returnflag"), L("N")),
        "flag_lt": B("<", C("l_returnflag"), L("R")),
        "cast": E.Cast(C("l_quantity"), E.decimal(15, 4)),
        "alias": E.Alias(C("l_tax"), "t"),
    }[text]


@pytest.mark.parametrize("text", ["disc_price", "charge", "shipdate_le",
                                  "and_or", "div", "mod", "int_div", "flag_eq",
                                  "flag_lt", "cast", "alias"])
def test_bound_expression_matches(text):
    jschema, tschema = _schemas()
    jb, tb = _batches(*_columns(seed=len(text)), jschema, tschema)
    jbound = JE.bind_expr(_expr(JE, text), jschema)
    tbound = TE.bind_expr(_expr(TE, text), tschema)
    assert repr(tbound.dtype) == repr(jbound.dtype)
    assert tbound.nullable == jbound.nullable
    jc, tc = jbound.fn(jb), tbound.fn(tb)
    jv = np.asarray(jc.validity)[:N]
    np.testing.assert_array_equal(tc.validity[:N].numpy(), jv)
    np.testing.assert_array_equal(tc.data[:N].numpy()[jv],
                                  np.asarray(jc.data)[:N][jv])


def test_unported_node_raises():
    _, tschema = _schemas()
    with pytest.raises(NotImplementedError, match="levenshtein"):
        TE.bind_expr(TE.ScalarFn("levenshtein", (TE.Col("l_returnflag"),
                                                 TE.Lit("AIR"))),
                     tschema)


def test_div_round_half_negative_operands():
    rng = np.random.default_rng(5)
    num = rng.integers(-10 ** 12, 10 ** 12, 4000)
    den = rng.integers(-999, 1000, 4000)
    den[den == 0] = 7
    # exact halves in both signs
    num[:4], den[:4] = [5, -5, 15, -15], [10, 10, -10, -10]
    want = np.asarray(JE._div_round_half(jnp.asarray(num), jnp.asarray(den)))
    got = TE._div_round_half(torch.from_numpy(num), torch.from_numpy(den))
    np.testing.assert_array_equal(got.numpy(), want)
    assert got[:4].tolist() == [1, -1, -2, 2]


@pytest.mark.parametrize("branch,m", [("exact", 4), ("exact", 0),
                                      ("exact", 6), ("approx", 4),
                                      ("approx", 12)])
def test_div_scaled_branches(branch, m):
    rng = np.random.default_rng(m)
    n = 2000
    if branch == "exact":
        a = rng.integers(-9 * 10 ** 17, 9 * 10 ** 17, n)
        b = rng.integers(-10 ** 9, 10 ** 9, n)
    else:   # denominators above 9e17 take the rounding fallback
        a = rng.integers(-2 ** 62, 2 ** 62, n)
        b = rng.integers(9 * 10 ** 17 + 1, 2 ** 62, n) * rng.choice([-1, 1], n)
    b[b == 0] = 1
    want = np.asarray(JE._div_scaled(jnp.asarray(a), jnp.asarray(b), m))
    got = TE._div_scaled(torch.from_numpy(a), torch.from_numpy(b), m)
    np.testing.assert_array_equal(got.numpy(), want)
