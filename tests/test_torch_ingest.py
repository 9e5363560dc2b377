"""Host ingest without the JAX package: ballista_tpu_torch.batch's
`ingest_column` / `ingest_arrow_column` against ballista_tpu.batch's
`ingest_column_host` on the same columns, `register_numpy` against
`register_arrow`, and the pandas / arrow egress against the reference's.
Every comparison is exact: values where valid (and zeros where not),
validity, dictionaries and bounds."""

import datetime
import decimal

import numpy as np
import pandas as pd
import pyarrow as pa
import pytest
import torch

from ballista_tpu import batch as JB
from ballista_tpu.client import SessionContext as JaxContext
from ballista_tpu_torch import batch as TB
from ballista_tpu_torch.client import SessionContext
from ballista_tpu_torch.schema import Field, decimal as decimal_type

torch.set_num_threads(2)

_RNG = np.random.default_rng(7)
N = 257


def _nulls(values, frac=0.2, seed=3):
    mask = np.random.default_rng(seed).random(len(values)) < frac
    return [None if m else v for v, m in zip(values, mask)]


_INTS = _RNG.integers(-1000, 1000, N)
_WORDS = [f"w{v:03d}" for v in _RNG.integers(0, 40, N)]
_DATES = [datetime.date(1995, 1, 1) + datetime.timedelta(days=int(d))
          for d in _RNG.integers(0, 3000, N)]
_DECS = [decimal.Decimal(int(v)).scaleb(-2)
         for v in _RNG.integers(-10 ** 6, 10 ** 6, N)]

# name -> arrow array
COLUMNS = {
    "int32": pa.array(_INTS.astype(np.int32)),
    "int32_null": pa.array(_nulls(_INTS.tolist()), pa.int32()),
    "int16": pa.array(_INTS.astype(np.int16)),
    "int64": pa.array(_INTS * 10 ** 10),
    "int64_null": pa.array(_nulls((_INTS * 10 ** 10).tolist()), pa.int64()),
    "float32": pa.array(_RNG.normal(size=N).astype(np.float32)),
    "float32_null": pa.array(_nulls(_RNG.normal(size=N).tolist()),
                             pa.float32()),
    "float64": pa.array(_RNG.normal(size=N)),
    "float64_nan": pa.array(np.where(_INTS > 0, np.nan, 1.5)),
    "float64_null": pa.array(_nulls(_RNG.normal(size=N).tolist()),
                             pa.float64()),
    "bool": pa.array(_INTS > 0),
    "bool_null": pa.array(_nulls((_INTS > 0).tolist()), pa.bool_()),
    "date32": pa.array(_DATES, pa.date32()),
    "date32_null": pa.array(_nulls(_DATES), pa.date32()),
    "decimal": pa.array(_DECS, pa.decimal128(12, 2)),
    "decimal_null": pa.array(_nulls(_DECS), pa.decimal128(12, 2)),
    "string": pa.array(_WORDS),
    "string_null": pa.array(_nulls(_WORDS)),
    "string_unicode": pa.array(_nulls(["é", "a", "日本", "abcdefghijk", ""]
                                      * 50, seed=5)),
    "string_long": pa.array([w * 5 for w in _WORDS]),
    "large_string": pa.array(_nulls(_WORDS, seed=9), pa.large_string()),
    "string_all_null": pa.array([None] * N, pa.string()),
    "chunked_int": pa.chunked_array([pa.array([1, 2, None], pa.int64()),
                                     pa.array([7, -5], pa.int64())]),
    "chunked_string": pa.chunked_array([pa.array(["b", None, "a"]),
                                        pa.array(["c", "a"])]),
    "chunked_none": pa.chunked_array([], pa.string()),
    "sliced_decimal": pa.array(_DECS, pa.decimal128(12, 2)).slice(10, 50),
    "sliced_string": pa.array(_nulls(_WORDS)).slice(5, 100),
    "empty_int": pa.array([], pa.int64()),
    "empty_string": pa.array([], pa.string()),
    "empty_date": pa.array([], pa.date32()),
}


def _reference(arr, dictionaries=None):
    field = JB.schema_from_arrow(pa.schema([pa.field("c", arr.type)])).fields[0]
    values, validity, dictionary, is_raw, bounds = JB.ingest_column_host(
        arr, field, len(arr), dictionaries)
    assert not is_raw
    return field, values, validity, dictionary, bounds


def _assert_host_equal(got: TB.HostColumn, values, validity, dictionary,
                       bounds, dtype):
    np.testing.assert_array_equal(got.validity, validity)
    assert got.values.dtype == np.dtype(dtype.np_dtype)
    np.testing.assert_array_equal(got.values[got.validity],
                                  np.asarray(values)[validity])
    # NULL rows are zeroed (decimals: whatever the reference's buffer held
    # is not read)
    assert not got.values[~got.validity].any()
    if dictionary is None:
        assert got.dictionary is None
    else:
        assert got.dictionary.dtype == object
        assert all(type(s) is str for s in got.dictionary)
        np.testing.assert_array_equal(got.dictionary, dictionary)
    assert got.bounds == bounds


@pytest.mark.parametrize("name", sorted(COLUMNS))
def test_arrow_column_matches_reference(name):
    arr = COLUMNS[name]
    field, values, validity, dictionary, bounds = _reference(arr)
    tfield = TB.schema_from_arrow(pa.schema([pa.field("c", arr.type)])).fields[0]
    assert repr(tfield.dtype) == repr(field.dtype)
    assert tfield.nullable == field.nullable
    got = TB.ingest_arrow_column(arr, tfield.dtype)
    _assert_host_equal(got, values, validity, dictionary, bounds, tfield.dtype)


def _as_numpy(arr):
    """The column as what a user without pyarrow would hold: a numpy
    array where there are no NULLs, else a list with None."""
    if isinstance(arr, pa.ChunkedArray):
        arr = arr.combine_chunks() if arr.num_chunks \
            else pa.array([], arr.type)
    if pa.types.is_decimal(arr.type):
        return arr.to_pylist()
    if arr.null_count or pa.types.is_string(arr.type) \
            or pa.types.is_large_string(arr.type):
        return arr.to_pylist()
    if pa.types.is_date32(arr.type):
        return np.asarray(arr.cast(pa.int32())).astype("datetime64[D]")
    return np.asarray(arr)


@pytest.mark.parametrize("name", sorted(COLUMNS))
def test_numpy_column_matches_reference(name):
    arr = COLUMNS[name]
    field, values, validity, dictionary, bounds = _reference(arr)
    tfield = TB.schema_from_arrow(pa.schema([pa.field("c", arr.type)])).fields[0]
    got = TB.ingest_column(_as_numpy(arr), tfield.dtype)
    _assert_host_equal(got, values, validity, dictionary, bounds, tfield.dtype)


@pytest.mark.parametrize("name", ["int32", "int64", "float32", "float64",
                                  "float64_nan", "bool", "date32", "string",
                                  "string_null", "int64_null", "bool_null",
                                  "float64_null", "date32_null"])
def test_dtype_is_inferred(name):
    """Without a declared dtype the numpy array or list ingests as the
    type arrow gives the same data."""
    arr = COLUMNS[name]
    field, values, validity, dictionary, bounds = _reference(arr)
    data = _as_numpy(arr)
    dtype = TB.column_dtype(data)
    assert repr(dtype) == repr(field.dtype)
    _assert_host_equal(TB.ingest_column(data), values, validity, dictionary,
                       bounds, dtype)


def test_validity_argument_and_fixed_width_strings():
    words = np.array(_WORDS)                       # 'U' array
    valid = np.array([v is not None for v in _nulls(_WORDS)])
    _, values, validity, dictionary, bounds = _reference(
        COLUMNS["string_null"])
    got = TB.ingest_column(words, validity=valid)
    _assert_host_equal(got, values, validity, dictionary, bounds,
                       TB.column_dtype(words))
    as_bytes = TB.ingest_column(words.astype("S"), validity=valid)
    np.testing.assert_array_equal(as_bytes.values, got.values)
    np.testing.assert_array_equal(as_bytes.dictionary, got.dictionary)
    ints = TB.ingest_column(_INTS, validity=valid)
    assert ints.bounds == (int(_INTS[valid].min()), int(_INTS[valid].max()))
    assert not ints.values[~valid].any()


def test_scaled_integer_decimals():
    scaled = np.array([int(d.scaleb(2)) for d in _DECS], dtype=np.int64)
    _, values, validity, _, bounds = _reference(COLUMNS["decimal"])
    got = TB.ingest_column(scaled, decimal_type(12, 2))
    _assert_host_equal(got, values, validity, None, bounds,
                       decimal_type(12, 2))
    with pytest.raises(TypeError, match="scaled integers"):
        TB.ingest_column(np.array([1.5]), decimal_type(12, 2))
    with pytest.raises(TypeError, match="needs"):
        TB.ingest_column([decimal.Decimal("1.5")])


def test_given_global_dictionary():
    """Shards of one table encode against one dictionary, so codes agree;
    a value the dictionary lacks keeps code 0, as in the reference's
    fallback."""
    global_dict = np.array(sorted(set(_WORDS)), dtype=object)
    arr = COLUMNS["string_null"].slice(0, 60)
    _, values, validity, dictionary, _ = _reference(arr, {"c": global_dict})
    got = TB.ingest_arrow_column(arr, TB.STRING, dictionary=global_dict)
    np.testing.assert_array_equal(got.validity, validity)
    np.testing.assert_array_equal(got.values, values)
    assert got.dictionary is not None and len(got.dictionary) == len(dictionary)
    np.testing.assert_array_equal(got.dictionary, dictionary)
    other = TB.ingest_column(["w001", "nope", None], dictionary=global_dict)
    assert other.values[1] == 0 and not other.validity[2]
    assert global_dict[other.values[0]] == "w001"


def test_sampled_distinct_path_matches_sort(monkeypatch):
    """A long column of few distinct values takes its dictionary from a
    sample; the codes are those of the full sort."""
    words = np.array(_WORDS * 40)
    want = TB.ingest_column(words)
    monkeypatch.setattr(TB, "_SAMPLE_ROWS", 64)
    got = TB.ingest_column(words)
    np.testing.assert_array_equal(got.values, want.values)
    np.testing.assert_array_equal(got.dictionary, want.dictionary)
    # a value the sample misses sends the column back to the full sort
    rare = words.copy()
    rare[1] = "zzz"
    got = TB.ingest_column(rare)
    assert got.dictionary[-1] == "zzz" and got.dictionary[got.values[1]] == "zzz"
    np.testing.assert_array_equal(got.dictionary[got.values], rare)


@pytest.mark.parametrize("width", [1, 7, 8, 9, 16, 17, 33])
def test_word_sort_matches_np_unique(monkeypatch, width):
    """`_sorted_distinct` (ASCII text sorted as big-endian uint64 words)
    gives np.unique's values and inverse at every width: strings shorter
    than the widest, the empty string, and a long column of few values
    on the sample path; non-ASCII text keeps np.unique."""
    rng = np.random.default_rng(width)
    alphabet = np.array(list("ab~ Z0"))
    strs = np.array(["".join(rng.choice(alphabet, rng.integers(0, width + 1)))
                     for _ in range(3000)])
    few = np.tile(strs[:11], 367)[:64 * 63]   # a sample step of 63 sees all
    for arr in (strs, few, np.char.add(strs, "é")):
        want_u, want_inv = np.unique(arr, return_inverse=True)
        got_u, got_inv = TB._sorted_distinct(arr)
        np.testing.assert_array_equal(got_u, want_u)
        np.testing.assert_array_equal(got_inv, want_inv.reshape(-1))
    monkeypatch.setattr(TB, "_SAMPLE_ROWS", 64)

    def no_sort(*args):
        raise AssertionError("the sample path sorts no column")

    monkeypatch.setattr(TB, "_sort_words", no_sort)
    got_u, got_inv = TB._sorted_distinct(few)
    want_u, want_inv = np.unique(few, return_inverse=True)
    np.testing.assert_array_equal(got_u, want_u)
    np.testing.assert_array_equal(got_inv, want_inv.reshape(-1))


def test_unsigned_integers_widen_or_raise():
    assert repr(TB.column_dtype(np.array([1], dtype=np.uint16))) == "int32"
    got = TB.ingest_column(np.array([1, 2 ** 32 - 1], dtype=np.uint32))
    assert got.values.dtype == np.int64 and got.bounds == (1, 2 ** 32 - 1)
    with pytest.raises(ValueError, match="do not fit int64"):
        TB.ingest_column(np.array([2 ** 63], dtype=np.uint64))


@pytest.mark.parametrize("n", [16, 17])
def test_high_cardinality_strings_go_raw(monkeypatch, n):
    """Past BALLISTA_RAW_DICT_MAX estimated distinct values a column is
    RAW, as the reference's ingest makes it: codes are row indices and
    the dictionary is the column in row order ("" for NULL)."""
    monkeypatch.setenv("BALLISTA_RAW_DICT_MAX", "16")
    vals = [None if i == 3 else f"s{i % 40}" for i in range(n)]
    arr = pa.array(vals, type=pa.string())
    field = JB.schema_from_arrow(pa.schema([pa.field("c", arr.type)])
                                 ).fields[0]
    values, validity, dictionary, is_raw, _ = JB.ingest_column_host(
        arr, field, n)
    for got in (TB.ingest_column(vals),
                TB.ingest_arrow_column(arr, TB.STRING)):
        assert got.raw == is_raw == (n > 16)
        np.testing.assert_array_equal(got.validity, validity)
        np.testing.assert_array_equal(got.values[got.validity],
                                      values[validity])
        assert got.dictionary.tolist() == dictionary.tolist()


def _table():
    names = [n for n in sorted(COLUMNS)
             if len(COLUMNS[n]) == N and "chunked" not in n]
    return pa.table({n: COLUMNS[n] for n in names})


def _assert_tables_equal(a, b):
    assert [(f.name, repr(f.dtype), f.nullable) for f in a.fields] == \
        [(f.name, repr(f.dtype), f.nullable) for f in b.fields]
    for f in a.fields:
        x, y = a.host[f.name], b.host[f.name]
        _assert_host_equal(x, y.values, y.validity, y.dictionary, y.bounds,
                           f.dtype)


def test_register_numpy_equals_register_arrow():
    table = _table()
    ctx = SessionContext(device="cpu")
    ctx.register_arrow("a", table, primary_key=("int64",))
    fields = TB.schema_from_arrow(table.schema).fields
    ctx.register_numpy("n", {n: _as_numpy(table[n]) for n in table.column_names},
                       fields=fields, primary_key=("int64",))
    _assert_tables_equal(ctx.tables["n"], ctx.tables["a"])
    # inferred types, where numpy can say them (no decimals, no int16)
    plain = [n for n in table.column_names
             if "decimal" not in n and n not in (
                 "int16", "string_all_null", "float32_null", "int32_null")]
    ctx.register_arrow("a2", table.select(plain))
    ctx.register_numpy("n2", {n: _as_numpy(table[n]) for n in plain})
    _assert_tables_equal(ctx.tables["n2"], ctx.tables["a2"])
    # (values, validity) pairs; ready HostColumns go through register_host
    ctx.register_numpy("n3", {"i": (_INTS, _INTS > 0),
                              "j": (list(_INTS), list(_INTS > 0))})
    for name in "ij":
        h = ctx.tables["n3"].host[name]
        np.testing.assert_array_equal(h.validity, _INTS > 0)
        assert h.bounds == (int(_INTS[_INTS > 0].min()), int(_INTS.max()))
    ctx.register_host("n4", [Field("h", TB.STRING)],
                      {"h": TB.ingest_column(_WORDS)})
    assert ctx.tables["n4"].num_rows == len(_WORDS)
    # any other tuple is a column's values, as a list is
    ctx.register_numpy("n6", {"a": (1, 2), "s": ("a", "b"), "b": (True, False)})
    ctx.register_numpy("l6", {"a": [1, 2], "s": ["a", "b"], "b": [True, False]})
    for name in "asb":
        x, y = ctx.tables["n6"].host[name], ctx.tables["l6"].host[name]
        _assert_host_equal(x, y.values, y.validity, y.dictionary, y.bounds,
                           ctx.tables["l6"].schema.field(name).dtype)
        assert len(x.values) == 2 and x.validity.all()
    with pytest.raises(ValueError, match="differ in length"):
        ctx.register_numpy("n5", {"a": [1, 2], "b": [1]})


def test_empty_table():
    empty = pa.table({"k": pa.array([], pa.string()),
                      "v": pa.array([], pa.int64())})
    jctx, tctx = JaxContext(capacity_mode="exact"), SessionContext(device="cpu")
    jctx.register_arrow("e", empty)
    tctx.register_arrow("e", empty)
    tctx.register_numpy("e2", {"k": np.array([], dtype="U1"),
                               "v": np.array([], dtype=np.int64)})
    _assert_tables_equal(tctx.tables["e2"], tctx.tables["e"])
    for sql in ("select k, sum(v) as s from e group by k",
                "select count(*) as n, sum(v) as s from e"):
        jb, js = jctx.sql(sql).collect()
        want = JB.to_numpy(jb, js)
        for table in ("e", "e2"):
            got = tctx.sql(sql.replace(" e", f" {table}")).to_numpy()
            for name in want:
                np.testing.assert_array_equal(got[name][1], want[name][1])
                np.testing.assert_array_equal(got[name][0], want[name][0])


@pytest.fixture(scope="module")
def egress():
    table = _table()
    jctx, tctx = JaxContext(capacity_mode="exact"), SessionContext(device="cpu")
    jctx.register_arrow("t", table)
    tctx.register_arrow("t", table)
    return table, jctx.table("t"), tctx.table("t")


def test_to_pandas_round_trip_equals_reference(egress):
    _, jdf, tdf = egress
    want, got = jdf.to_pandas(), tdf.to_pandas()
    assert list(got.columns) == list(want.columns)
    assert [str(t) for t in got.dtypes] == [str(t) for t in want.dtypes]
    pd.testing.assert_frame_equal(got, want, check_exact=True)


def test_to_arrow_round_trip_equals_reference(egress):
    table, jdf, tdf = egress
    want, got = jdf.to_arrow(), tdf.to_arrow()
    assert got.schema.equals(want.schema)
    for name in want.column_names:
        if name == "float64_nan":       # arrow holds NaN unequal to NaN
            np.testing.assert_array_equal(np.asarray(got[name]),
                                          np.asarray(want[name]))
        else:
            assert got[name].equals(want[name]), name
    assert TB.schema_to_arrow(tdf.schema()).equals(
        JB.schema_to_arrow(jdf.schema()))
    # and back in: the registered result equals the first registration
    ctx = SessionContext(device="cpu")
    ctx.register_arrow("t", table)
    ctx.register_arrow("back", got)
    for f in ctx.tables["t"].fields:
        x, y = ctx.tables["back"].host[f.name], ctx.tables["t"].host[f.name]
        np.testing.assert_array_equal(x.validity, y.validity)
        np.testing.assert_array_equal(x.values, y.values)


def test_register_pandas_matches_reference():
    pdf = pd.DataFrame({"k": ["b", None, "a", "b"], "v": [1.5, 2.5, None, 4.0],
                        "i": [4, 3, 2, 1]})
    jctx, tctx = JaxContext(capacity_mode="exact"), SessionContext(device="cpu")
    jctx.register_pandas("p", pdf)
    tctx.register_pandas("p", pdf)
    pd.testing.assert_frame_equal(tctx.table("p").to_pandas(),
                                  jctx.table("p").to_pandas())
