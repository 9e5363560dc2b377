"""The port's native dictionary encoder (`ballista_tpu_torch/native.py`,
`csrc/ballista_native.cpp`) against the plain path
(`batch._sorted_distinct`, numpy object ingest) and against the JAX
package's encoder (`ballista_tpu.native`) on the same arrow arrays: codes
and dictionaries equal for empty strings, non-ASCII text, one value, all
distinct, NULLs filled, and unknown values against a dictionary. Built
with g++ at first use, as on the card machine."""

import numpy as np
import pyarrow as pa
import pytest
import torch

from ballista_tpu import native as jax_native
from ballista_tpu_torch import batch as B
from ballista_tpu_torch import native
from ballista_tpu_torch.schema import STRING

torch.set_num_threads(2)

_RNG = np.random.default_rng(7)
CASES = {
    "empty_strings": ["", "a", "", "b", "", "a"],
    "non_ascii": ["é", "e", "ü", "z", "日本", "日", "é", "ascii", "Ω"],
    "one_value": ["same"] * 50,
    "all_distinct": [f"v{i:05d}" for i in _RNG.permutation(3000)],
    "prefix_ties": ["abcdefgh", "abcdefghi", "abcdefg", "abcdefgh\x01",
                    "abcdefgi", "abcdefgh"],
    "comments": [" ".join(_RNG.choice(["furious", "sly", "deposits",
                                       "ideas", "x"], 6))
                 for _ in range(2000)],
    "empty_column": [],
}


def _plain(values):
    """(codes, dictionary) of the plain path on a 'U' array."""
    strs = np.array(values, dtype=str) if values else np.zeros(0, "U1")
    uniq, inv = B._sorted_distinct(strs)
    return inv.astype(np.int32), uniq


@pytest.mark.parametrize("case", sorted(CASES))
def test_dict_encode_equals_plain_and_jax(case):
    values = CASES[case]
    arr = pa.array(values, type=pa.string())
    data, offsets = native.arrow_buffers(arr)
    codes, dictionary = native.dict_encode(data, offsets)
    want_codes, want_dict = _plain(values)
    np.testing.assert_array_equal(codes, want_codes)
    assert dictionary.tolist() == want_dict.tolist()
    ref = jax_native.dict_encode_arrow(arr)
    if ref is not None and len(values):
        np.testing.assert_array_equal(codes, ref[0])
        assert dictionary.tolist() == list(ref[1])


@pytest.mark.parametrize("case", ["non_ascii", "all_distinct", "comments"])
def test_large_string_offsets(case):
    """A large_string array (64-bit offsets, what a column past 2 GiB is)
    encodes as the string array does; the JAX package's int32 path has no
    answer for it."""
    values = CASES[case]
    codes, dictionary = native.dict_encode(
        *native.arrow_buffers(pa.array(values, type=pa.large_string())))
    want_codes, want_dict = _plain(values)
    np.testing.assert_array_equal(codes, want_codes)
    assert dictionary.tolist() == want_dict.tolist()
    assert jax_native.dict_encode_arrow(
        pa.array(values, type=pa.large_string())) is None


def test_sliced_array_reads_its_own_offset():
    arr = pa.array(CASES["non_ascii"] * 3).slice(4, 11)
    codes, dictionary = native.dict_encode(*native.arrow_buffers(arr))
    want_codes, want_dict = _plain(arr.to_pylist())
    np.testing.assert_array_equal(codes, want_codes)
    assert dictionary.tolist() == want_dict.tolist()


@pytest.mark.parametrize("case", ["non_ascii", "comments", "empty_strings"])
def test_encode_against_dictionary_with_unknown_values(case):
    values = CASES[case]
    known = sorted(set(values))[::2]
    arr = pa.array(values)
    codes = native.dict_encode_against(*native.arrow_buffers(arr),
                                       np.array(known, dtype=object))
    want = np.array([known.index(v) if v in known else -1 for v in values],
                    dtype=np.int32)
    np.testing.assert_array_equal(codes, want)
    ref = jax_native.dict_encode_against_arrow(arr, np.array(known, object))
    if ref is not None:
        np.testing.assert_array_equal(codes, ref)


def test_spans_equal_offsets():
    """Field spans (a `.tbl` column's starts and ends, with separators
    between fields) give the codes contiguous offsets give."""
    values = CASES["comments"][:300]
    text = "|".join(values).encode()
    data = np.frombuffer(text, dtype=np.uint8)
    lens = np.array([len(v.encode()) for v in values])
    starts = np.concatenate(([0], np.cumsum(lens + 1)[:-1]))
    codes, dictionary = native.dict_encode(data, starts, starts + lens)
    want_codes, want_dict = _plain(values)
    np.testing.assert_array_equal(codes, want_codes)
    assert dictionary.tolist() == want_dict.tolist()


@pytest.mark.parametrize("case", ["empty_strings", "non_ascii", "comments",
                                  "one_value"])
@pytest.mark.parametrize("given", [False, True])
def test_arrow_ingest_with_nulls_equals_plain(case, given):
    """`ingest_arrow_column` (native) against `ingest_column` on the same
    values as a numpy object array (plain): NULLs filled, with and
    without a given dictionary."""
    values = list(CASES[case])
    mask = _RNG.random(len(values)) < 0.3
    with_nulls = [None if m else v for v, m in zip(values, mask)]
    dictionary = (np.array(sorted(set(values))[1:], dtype=object)
                  if given else None)
    got = B.ingest_arrow_column(pa.array(with_nulls, pa.string()), STRING,
                                dictionary)
    want = B.ingest_column(np.array(with_nulls, dtype=object), STRING,
                           dictionary=dictionary)
    np.testing.assert_array_equal(got.values, want.values)
    np.testing.assert_array_equal(got.validity, want.validity)
    assert got.dictionary.tolist() == want.dictionary.tolist()
    assert got.raw == want.raw


def test_raw_verdict_equals_plain(monkeypatch):
    monkeypatch.setenv("BALLISTA_RAW_DICT_MAX", "100")
    values = CASES["all_distinct"]
    got = B.ingest_arrow_column(pa.array(values), STRING)
    want = B.ingest_column(np.array(values, dtype=object), STRING)
    assert got.raw and want.raw
    assert got.dictionary.tolist() == want.dictionary.tolist()
    np.testing.assert_array_equal(got.values, want.values)


def test_failed_build_raises_with_the_compiler_error(monkeypatch, tmp_path):
    """No quiet fallback: a compiler that fails makes the encoder raise."""
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(native, "_loaded", None)
    monkeypatch.setenv("CXX", "false")
    with pytest.raises(RuntimeError, match="C\\+\\+ build failed"):
        native.dict_encode(*native.arrow_buffers(pa.array(["a"])))


@pytest.mark.parametrize("starts,ends", [([0, 2], [2, 9]), ([-1], [1]),
                                         ([3], [2]), ([0, 1], [1])])
def test_spans_outside_the_buffer_raise(starts, ends):
    """The encoder reads through the spans unchecked, so the wrapper
    refuses any that leave the buffer, run backwards or do not pair up."""
    data = np.frombuffer(b"abcdef", dtype=np.uint8)
    with pytest.raises(ValueError):
        native.dict_encode(data, np.array(starts), np.array(ends))
