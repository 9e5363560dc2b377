"""dbgen `.tbl` ingest and egress and the exact answer diff of the port
(`ballista_tpu_torch/datagen/tbl.py`, `python -m ballista_tpu_torch.datagen
--format tbl`) against the JAX package's (`ballista_tpu/datagen/tbl.py`,
which reads through pyarrow and renders through pandas), at SF 0.01:

- the port CLI's files are byte for byte the JAX CLI's, for all eight
  tables;
- the port's numpy `read_tbl` equals the pyarrow reader column by column
  (decimals as scaled integers, dates as days, strings by value,
  validity), on the generated files and on random rows (hypothesis):
  empty numeric and string fields, negative and short decimals, a last
  line with no newline, empty lines;
- `register_tpch_tbl` and the six queries of tests/test_reference_diff.py
  match the JAX `write_answers` files through both packages'
  `diff_expected`, and both give the same message on a crafted row
  count, column count and cell;
- the departure kept on purpose: an exact decimal on a printed midpoint
  is a mismatch for the reference and a logged match for the port.
"""

import datetime
import decimal
import os
import subprocess
import sys

import numpy as np
import pyarrow as pa
import pytest
import torch
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from ballista_tpu.client import SessionContext as JaxContext
from ballista_tpu.datagen import tbl as JT
from ballista_tpu_torch.batch import to_numpy
from ballista_tpu_torch.benchmarks import TPCH_QUERIES
from ballista_tpu_torch.client import SessionContext
from ballista_tpu_torch.datagen import TPCH_TABLES, generate_tpch
from ballista_tpu_torch.datagen import tbl as T
from ballista_tpu_torch.schema import Field, TypeKind, decimal as dec_type

torch.set_num_threads(2)

SF = 0.01
QUERIES = (1, 3, 6, 12, 14, 19)
REPO = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
EPOCH = datetime.date(1970, 1, 1)


def _cli(package, out):
    subprocess.run([sys.executable, "-m", f"{package}.datagen", "--sf",
                    str(SF), "--format", "tbl", "--out", out], check=True,
                   cwd=REPO, capture_output=True,
                   env={**os.environ, "JAX_PLATFORMS": "cpu",
                        "OMP_NUM_THREADS": "2"})
    return out


@pytest.fixture(scope="module")
def jax_tbl(tmp_path_factory):
    return _cli("ballista_tpu", str(tmp_path_factory.mktemp("jax_tbl")))


@pytest.fixture(scope="module")
def port_tbl(tmp_path_factory):
    return _cli("ballista_tpu_torch", str(tmp_path_factory.mktemp("port_tbl")))


@pytest.fixture(scope="module")
def answers(tmp_path_factory):
    """The JAX package's answer files for QUERIES (its pandas oracle)."""
    from ballista_tpu.benchmarks.oracle import to_pd
    from ballista_tpu.datagen import generate_tpch as jax_generate
    out = str(tmp_path_factory.mktemp("answers"))
    JT.write_answers(to_pd(jax_generate(SF)), out, QUERIES)
    return out


@pytest.mark.parametrize("name", list(TPCH_TABLES))
def test_cli_files_are_the_jax_cli_files(jax_tbl, port_tbl, name):
    with open(os.path.join(jax_tbl, f"{name}.tbl"), "rb") as f:
        want = f.read()
    with open(os.path.join(port_tbl, f"{name}.tbl"), "rb") as f:
        assert f.read() == want


@pytest.mark.parametrize("fmt", ["parquet", "csv"])
def test_cli_arrow_formats_are_the_jax_cli_tables(tmp_path, fmt):
    """--format parquet / csv: the port's host columns through
    `columns_to_arrow` give the JAX CLI's tables (csv byte for byte)."""
    import pyarrow.parquet as pq

    from ballista_tpu.datagen.__main__ import main as jax_main
    from ballista_tpu_torch.datagen.__main__ import main as port_main
    tables = ["nation", "region", "supplier", "customer", "orders"]
    for main, sub in ((jax_main, "jax"), (port_main, "port")):
        main(["--sf", str(SF), "--format", fmt, "--tables",
              ",".join(tables), "--out", str(tmp_path / sub)])
    for name in tables:
        want, got = (str(tmp_path / sub / f"{name}.{fmt}")
                     for sub in ("jax", "port"))
        if fmt == "csv":
            with open(want, "rb") as f, open(got, "rb") as g:
                assert g.read() == f.read(), name
        else:
            assert pq.read_table(got).equals(pq.read_table(want)), name


@pytest.mark.parametrize("flag", [["--chunks", "2"], ["--workers", "2"]])
def test_cli_chunked_flags_raise(tmp_path, flag):
    from ballista_tpu_torch.datagen.__main__ import main as port_main
    with pytest.raises(NotImplementedError, match="generate_tpch_parquet"):
        port_main(["--sf", str(SF), "--out", str(tmp_path), *flag])


def _arrow_values(column, dtype):
    """A pyarrow column as (Python values in the port's units, validity):
    decimals scaled to integers, dates as days."""
    out, valid = [], []
    for v in column.to_pylist():
        valid.append(v is not None)
        if v is None:
            out.append(None)
        elif dtype.kind is TypeKind.DECIMAL:
            out.append(int(v.scaleb(dtype.scale)))
        elif dtype.kind is TypeKind.DATE32:
            out.append((v - EPOCH).days)
        else:
            out.append(v)
    return out, valid


def _port_values(col, dtype):
    valid = col.validity.tolist()
    if dtype.kind is TypeKind.STRING:
        vals = col.dictionary[col.values].tolist()
    else:
        vals = col.values.tolist()
    return [v if ok else None for v, ok in zip(vals, valid)], valid


def assert_same_read(path, name):
    fields, cols = T.read_tbl(path, name)
    ref = JT.read_tbl(path, name)
    assert [f.name for f in fields] == ref.column_names
    for f in fields:
        assert _port_values(cols[f.name], f.dtype) == \
            _arrow_values(ref.column(f.name), f.dtype), f.name
    return fields, cols


@pytest.mark.parametrize("name", list(TPCH_TABLES))
def test_read_tbl_matches_pyarrow_reader(jax_tbl, name):
    fields, cols = assert_same_read(os.path.join(jax_tbl, f"{name}.tbl"), name)
    gen_fields, gen = generate_tpch(SF, tables=[name])[name]
    assert fields == gen_fields
    for f in fields:
        a, b = cols[f.name], gen[f.name]
        assert np.array_equal(a.validity, b.validity)
        if f.dtype.kind is TypeKind.STRING:
            assert list(a.dictionary) == list(b.dictionary)
        assert np.array_equal(a.values, b.values) and \
            a.values.dtype == b.values.dtype and a.bounds == b.bounds


_TEXT = st.text(alphabet="abcXYZ 019#-.é", max_size=8)


def _field_text(dtype):
    """Text of one field of `dtype`: empty, or a value pyarrow parses."""
    if dtype.kind is TypeKind.STRING:
        return _TEXT
    if dtype.kind is TypeKind.DATE32:
        value = st.dates(datetime.date(1900, 1, 1),
                         datetime.date(2100, 12, 31)).map(
            lambda d: d.isoformat())
    elif dtype.kind is TypeKind.DECIMAL:
        value = st.tuples(st.booleans(), st.integers(0, 10 ** 9),
                          st.sampled_from(["", ".", ".5", ".05", ".50",
                                           ".7", ".99"])).map(
            lambda t: ("-" if t[0] else "") + str(t[1])
            + ("" if t[2] == "." else t[2]))
    elif dtype.kind is TypeKind.INT32:
        value = st.integers(-2 ** 31, 2 ** 31 - 1).map(str)
    else:
        value = st.integers(-2 ** 62, 2 ** 62).map(str)
    return st.one_of(st.just(""), value)


@pytest.mark.parametrize("name", ["lineitem", "orders", "part"])
@settings(max_examples=25, deadline=None,
          suppress_health_check=[HealthCheck.function_scoped_fixture])
@given(data=st.data())
def test_random_rows_read_like_pyarrow(tmp_path, name, data):
    fields = T.tpch_schema(name)
    rows = data.draw(st.lists(st.tuples(*[_field_text(f.dtype)
                                          for f in fields]),
                              min_size=1, max_size=12))
    lines = ["|".join(r) + "|" for r in rows]
    blank = data.draw(st.integers(0, len(lines)))
    lines.insert(blank, "")               # an empty line is skipped
    text = "\n".join(lines)
    if data.draw(st.booleans()):
        text += "\n"                      # else the last line has none
    path = str(tmp_path / f"{name}.tbl")
    with open(path, "w", encoding="utf-8") as f:
        f.write(text)
    assert_same_read(path, name)


def test_malformed_lines_raise(tmp_path):
    path = str(tmp_path / "region.tbl")
    with open(path, "w") as f:
        f.write("0|AFRICA|x|\n1|AMERICA|y\n")
    with pytest.raises(ValueError, match="row 2 has 2 fields"):
        T.read_tbl(path, "region")
    with open(path, "w") as f:
        f.write("0x|AFRICA|x|\n")
    with pytest.raises(ValueError, match="not a number"):
        T.read_tbl(path, "region")


def _one_field(tmp_path, text, field):
    path = str(tmp_path / "t.tbl")
    with open(path, "w") as f:
        f.write(f"{text}|\n")
    buf, starts, ends = T._field_spans(np.fromfile(path, dtype=np.uint8), 1,
                                       path)
    buf = np.concatenate((buf, np.zeros(16, dtype=np.uint8)))
    return T._parse_column(buf, starts[:, 0], ends[:, 0], field, "v")


@pytest.mark.parametrize("text, scaled", [
    ("5.5", 550), ("-0.05", -5), ("7", 700), ("-12.3", -1230), ("0.500", 50),
    ("+3.25", 325)])
def test_short_and_signed_decimals(tmp_path, text, scaled):
    col = _one_field(tmp_path, text, Field("v", dec_type(15, 2)))
    assert col.values.tolist() == [scaled] and col.bounds == (scaled, scaled)


@pytest.fixture(scope="module")
def contexts(jax_tbl, port_tbl):
    jctx = JaxContext()
    JT.register_tpch_tbl(jctx, jax_tbl)
    tctx = SessionContext(device="cpu")
    assert T.register_tpch_tbl(tctx, port_tbl) == list(TPCH_TABLES)
    return jctx, tctx


def test_register_tpch_tbl_keys_and_raw_verdict(contexts):
    _, tctx = contexts
    for name, tp in tctx.tables.items():
        assert tp.primary_key == TPCH_TABLES[name][1]
        assert not tp.schema.unsorted     # no column is RAW at SF 0.01


def test_register_tpch_tbl_raw_like_register_tpch(port_tbl, monkeypatch):
    from ballista_tpu_torch.datagen import register_tpch
    monkeypatch.setenv("BALLISTA_RAW_DICT_MAX", "100")
    a, b = SessionContext(device="cpu"), SessionContext(device="cpu")
    T.register_tpch_tbl(a, port_tbl)
    register_tpch(b, SF)
    assert {n: tp.schema.unsorted for n, tp in a.tables.items()} == \
        {n: tp.schema.unsorted for n, tp in b.tables.items()}
    assert "o_comment" in a.tables["orders"].schema.unsorted


@pytest.mark.parametrize("q", QUERIES)
def test_queries_match_answer_files(contexts, answers, q):
    jctx, tctx = contexts
    got = tctx.sql(TPCH_QUERIES[q]).collect()
    assert T.diff_expected(got, answers, q) is None
    assert JT.diff_expected(jctx.sql(TPCH_QUERIES[q]).to_pandas(), answers,
                            q) is None


def _crafted(tctx, jctx, q):
    """The port's result as (to_numpy dict, schema) and the JAX package's
    as a pandas frame."""
    batch, schema = tctx.sql(TPCH_QUERIES[q]).collect()
    return to_numpy(batch, schema), schema, \
        jctx.sql(TPCH_QUERIES[q]).to_pandas()


@pytest.mark.parametrize("case", ["rows", "columns", "decimal", "string",
                                  "count"])
def test_mismatch_messages_equal(contexts, answers, case):
    jctx, tctx = contexts
    cols, schema, frame = _crafted(tctx, jctx, 1)
    names = [f.name for f in schema.fields]
    if case == "rows":
        cols = {k: (v[:-1], ok[:-1]) for k, (v, ok) in cols.items()}
        frame = frame.iloc[:-1]
    elif case == "columns":
        schema = schema.select(names[:-1])
        frame = frame[names[:-1]]
    else:
        name, row = {"decimal": ("sum_qty", 2), "string": ("l_returnflag", 0),
                     "count": ("count_order", 1)}[case]
        v, ok = cols[name]
        v = v.copy()
        if case == "string":
            v[row] = "B"
            frame.loc[row, name] = "B"
        elif case == "decimal":
            v[row] += 100
            frame.loc[row, name] += 1.0
        else:
            v[row] += 1
            frame.loc[row, name] += 1
        cols = dict(cols, **{name: (v, ok)})
    want = JT.diff_expected(frame, answers, 1)
    assert want is not None
    assert T.diff_expected((cols, schema), answers, 1) == want


def test_midpoint_is_a_logged_match_for_the_port(tmp_path):
    """0.1250 at two places is a midpoint: the answer may print 0.12 or
    0.13. The reference renders through float64 (0.12) and reports 0.13 as
    a mismatch; the port accepts either neighbour and says so, and still
    rejects any other value."""
    jctx = JaxContext()
    jctx.register_arrow("t", pa.table({"x": pa.array(
        [decimal.Decimal("0.1250"), decimal.Decimal("2.0000")],
        type=pa.decimal128(15, 4))}))
    tctx = SessionContext(device="cpu")
    tctx.register_numpy("t", {"x": np.array([1250, 20000])},
                        fields=[Field("x", dec_type(15, 4))])
    sql = "select x from t order by x"
    frame = jctx.sql(sql).to_pandas()
    got = tctx.sql(sql).collect()
    os.makedirs(tmp_path / "answers")
    for printed, port_ok in (("0.13", True), ("0.12", True), ("0.14", False)):
        with open(tmp_path / "answers" / "q9.out", "w") as f:
            f.write(f"x\n{printed}\n2.00\n")
        notes = []
        mine = T.diff_expected(got, str(tmp_path), 9, notes)
        ref = JT.diff_expected(frame, str(tmp_path), 9)
        assert (mine is None) == port_ok
        if printed == "0.13":
            assert ref is not None and "got '0.12' expected '0.13'" in ref
            assert notes == ["q9.out row 0 x: the exact value 0.1250 is a "
                             "midpoint; the answer prints 0.13"]
        elif printed == "0.12":
            assert ref is None and notes == []
        else:
            assert mine == ref



@pytest.mark.parametrize("text", ["2024-02-29", "1900-03-01", "1969-12-31",
                                  "2000-02-29", "1970-01-01", "2100-12-31"])
def test_dates_parse_to_days(tmp_path, text):
    from ballista_tpu_torch.schema import DATE32
    col = _one_field(tmp_path, text, Field("d", DATE32))
    want = int(np.datetime64(text, "D").astype(np.int64))
    assert col.values.tolist() == [want] and col.values.dtype == np.int32


@pytest.mark.parametrize("text", ["2023-02-29", "1900-02-29", "2024-13-01",
                                  "2024-04-31", "2024-4-30", "20240430"])
def test_bad_dates_raise(tmp_path, text):
    from ballista_tpu_torch.schema import DATE32
    with pytest.raises(ValueError, match="YYYY-MM-DD"):
        _one_field(tmp_path, text, Field("d", DATE32))
