"""The port's TPC-H generator against the JAX package's: every column of
the eight tables at SF 0.01 must equal what `ingest_column_host` makes of
`generate_table(...)` — values, validity, dictionary and bounds."""

import numpy as np
import pytest
import torch

from ballista_tpu.batch import ingest_column_host, schema_from_arrow
from ballista_tpu.datagen.tpch import generate_table
from ballista_tpu_torch.datagen import TPCH_TABLES, from_ingested, generate_tpch

torch.set_num_threads(2)

SF = 0.01
Q1_COLUMNS = ("l_quantity", "l_extendedprice", "l_discount", "l_tax",
              "l_returnflag", "l_linestatus", "l_shipdate")


@pytest.fixture(scope="module")
def port_tables():
    return generate_tpch(SF)


@pytest.fixture(scope="module")
def ref_tables():
    return {name: generate_table(name, SF) for name in TPCH_TABLES}


def _cases():
    for name, (_, _, fields) in TPCH_TABLES.items():
        for f in fields:
            yield name, f.name


@pytest.mark.parametrize("table,column", list(_cases()))
def test_column_matches_reference_ingest(port_tables, ref_tables, table,
                                         column):
    arrow = ref_tables[table]
    ref_field = schema_from_arrow(arrow.schema).field(column)
    values, validity, dictionary, is_raw, bounds = ingest_column_host(
        arrow[column], ref_field, arrow.num_rows)
    assert not is_raw
    want = from_ingested(values, validity, dictionary, bounds)
    fields, cols = port_tables[table]
    field = next(f for f in fields if f.name == column)
    assert field.nullable == ref_field.nullable
    assert repr(field.dtype) == repr(ref_field.dtype)
    got = cols[column]
    assert got.values.dtype == want.values.dtype
    np.testing.assert_array_equal(got.values, want.values)
    np.testing.assert_array_equal(got.validity, want.validity)
    assert got.bounds == want.bounds
    if want.dictionary is None:
        assert got.dictionary is None
    else:
        assert list(got.dictionary) == list(want.dictionary)


def test_q1_columns_are_covered():
    names = {f.name for f in TPCH_TABLES["lineitem"][2]}
    assert set(Q1_COLUMNS) <= names


def test_from_ingested_types():
    col = from_ingested(np.arange(3, dtype=np.int32), [True, False, True],
                        ["a", "b"], (np.int64(0), np.int64(2)))
    assert col.validity.dtype == bool and col.dictionary.dtype == object
    assert col.bounds == (0, 2) and type(col.bounds[0]) is int


@pytest.mark.parametrize("dictionary", [["b", "a"], ["a", "a", "b"]])
def test_from_ingested_refuses_unsorted_dictionaries(dictionary):
    """A raw (unsorted or repeating) dictionary would break the port's
    code-order string compares: it is refused, not ingested."""
    with pytest.raises(ValueError, match="unsorted"):
        from_ingested(np.arange(len(dictionary), dtype=np.int32),
                      np.ones(len(dictionary), bool), dictionary, None)


def test_lineitem_parts_and_suppliers_are_partsupp_keys(port_tables):
    """Every (l_partkey, l_suppkey) of lineitem is a partsupp key, and
    partsupp's key is unique (four suppliers per part)."""
    ps = port_tables["partsupp"][1]
    li = port_tables["lineitem"][1]
    n_supp = len(port_tables["supplier"][1]["s_suppkey"].values) + 1
    ps_keys = ps["ps_partkey"].values * n_supp + ps["ps_suppkey"].values
    assert len(np.unique(ps_keys)) == len(ps_keys) == 4 * len(
        port_tables["part"][1]["p_partkey"].values)
    l_keys = li["l_partkey"].values * n_supp + li["l_suppkey"].values
    assert np.isin(l_keys, ps_keys).all()
