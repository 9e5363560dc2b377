"""The mapping of the program's string dictionaries onto the reference's
(`answer.string_lut`, `answer.DictMaps`) against the Python loop it
replaced, kept here as the oracle; `compare` reads the same with and
without a kept mapping and with no validity array; on the card, one
compare of a 10^8-row answer over a 10^8-entry dictionary in time."""

import time

import numpy as np
import pytest
import torch

from gpubench.answer import (MAX_WORDS, Answer, DictMaps, RCol, compare,
                             string_lut)


def loop_lut(port_dict: np.ndarray, ref_dict: np.ndarray) -> np.ndarray:
    """The reference code of each program dictionary entry (a string the
    reference does not know gets a code below -1, unique to it)."""
    index = {s: i for i, s in enumerate(ref_dict.tolist())}
    return np.array([index.get(s, -2 - i) for i, s in
                     enumerate(np.asarray(port_dict).astype(str).tolist())],
                    dtype=np.int64)


def strs(*items) -> np.ndarray:
    out = np.empty(len(items), dtype=object)
    out[:] = list(items)
    return out


LONG = "x" * (8 * MAX_WORDS) + "tail"        # past the packed words
CASES = {
    "ascii": (strs("b", "a", "c", "zz"), strs("a", "b", "c", "zz")),
    "empty_and_one_byte": (strs("", "a", "", "b"), strs("", "a", "b")),
    "non_ascii": (strs("é", "e", "日本", "ß", "émile", "zebra"),
                  strs("e", "zebra", "ß", "é", "émile", "日本")),
    "word_edges": (strs("abcdefg", "abcdefgh", "abcdefghi", "abcdefgh" * 2,
                        "abcdefgh" * 2 + "x"),
                   strs("abcdefgh", "abcdefghi", "abcdefgh" * 2 + "x")),
    "longer_than_words": (strs(LONG, LONG + "y", "short", LONG[:-1]),
                          strs(LONG, "short", LONG[:-1] + "z")),
    "repeated_in_row_order": (strs("id3", "id1", "id3", "id2", "id1", "id9"),
                              strs("id1", "id2", "id3")),
    "unknown": (strs("q", "r", "a", "s"), strs("a", "b")),
    "empty_reference": (strs("a", "b"), strs()),
    "empty_program": (strs(), strs("a", "b")),
    "prefix_of_another": (strs("ab", "abé", "a", "abc"),
                          strs("a", "ab", "abc")),
    "empty_against_long": (strs("", LONG, "a"), strs(LONG, "a")),
    "one_byte_apart": (strs("abcdefgX", "abcdefgh", "Xbcdefghijklmnop",
                            "abcdefghijklmnoX"),
                       strs("abcdefgh", "abcdefghijklmnop")),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_mapping_equals_the_loop(case):
    port, ref = CASES[case]
    want = loop_lut(port, ref)
    assert string_lut(port, ref).numpy().tolist() == want.tolist()
    got = DictMaps().lut(port, ref, "cpu")
    assert got.numpy().tolist() == want.tolist()


@pytest.mark.parametrize("seed", range(6))
def test_mapping_equals_the_loop_on_random_strings(seed):
    r = np.random.default_rng(seed)
    alphabet = list("abé日z0 ")

    def draw(n):
        lens = r.choice([0, 1, 3, 7, 8, 9, 15, 16, 17, 40, 8 * MAX_WORDS + 3],
                        n)
        return ["".join(r.choice(alphabet, k)) for k in lens]
    pool = draw(300)
    ref = strs(*sorted(set(r.choice(pool, 200).tolist())))
    port = strs(*r.choice(pool + draw(50), 500).tolist())
    want = loop_lut(port, ref)
    assert string_lut(port, ref).numpy().tolist() == want.tolist()


def test_a_nul_and_a_non_str_entry_are_matched_as_they_are():
    port = strs("a\x00", "a", 7, "b\x00c")
    ref = strs("a", "b\x00c", "7")
    assert string_lut(port, ref).numpy().tolist() == [-2, 0, 2, 1]


def _answer(n, seed):
    """(program's columns, reference answer): a string column over a
    dictionary in row order with repeats, an int and a float column."""
    r = np.random.default_rng(seed)
    names = strs(*[f"id{k}" for k in r.integers(0, 50, 400)])
    ref_dict = strs(*sorted(set(names.tolist())))
    rows = r.integers(0, len(names), n)
    ref_codes = np.searchsorted(ref_dict.astype(str), names[rows].astype(str))
    k = r.integers(0, 9, n)
    v = r.random(n)
    ref = Answer(["s", "k", "v"], [
        RCol("string", torch.as_tensor(ref_codes), ref_dict),
        RCol("int", torch.as_tensor(k)), RCol("float", torch.as_tensor(v))])
    ones = np.ones(n, dtype=bool)
    port = [{"name": "s", "kind": "string", "values": rows.astype(np.int32),
             "dictionary": names, "valid": ones},
            {"name": "k", "kind": "int", "values": k, "valid": ones},
            {"name": "v", "kind": "float", "values": v.copy(), "valid": ones}]
    return port, ref


@pytest.mark.parametrize("n", [5, 3000])   # few entries used, and most
@pytest.mark.parametrize("planted", [False, True])
def test_compare_reads_the_same_with_a_kept_mapping_and_no_validity(
        n, planted):
    port, ref = _answer(n, n)
    if planted:
        port[0]["values"] = port[0]["values"].copy()
        port[0]["values"][0] = (port[0]["values"][0] + 1) % 400
        port[2]["values"][-1] += 1e-3
    want = compare(port, ref)
    assert (want.wrong_cells > 0) == planted
    maps = DictMaps()
    assert compare(port, ref, maps=maps) == want
    assert compare(port, ref, maps=maps) == want       # the kept mapping
    none = [dict(e, valid=None) for e in port]
    assert compare(none, ref) == want
    assert compare(none, ref, maps=maps) == want


N_CARD = 10**8


def _card_answer(n, device):
    """The strings "id1".."id<n>" in row order as the program's dictionary
    (a RAW column's), the reference's the same sorted, and an answer of
    one row for each with an int column beside it."""
    names = np.empty(n, dtype=object)
    names[:] = list(map("id{}".format, range(1, n + 1)))
    k = torch.arange(1, n + 1, device=device)
    # the digits' order: left-aligned value, then the count of digits
    digits = torch.ones_like(k)
    p = 10
    while p <= n:
        digits += k >= p
        p *= 10
    width = len(str(n))
    aligned = k * torch.pow(10, width - digits)
    order = torch.sort(aligned * 16 + digits).indices
    rank = torch.empty_like(order)
    rank[order] = torch.arange(n, device=device)
    ref = Answer(["s", "k"], [RCol("string", rank, names[order.cpu().numpy()]),
                              RCol("int", k)])
    port = [{"name": "s", "kind": "string",
             "values": np.arange(n, dtype=np.int32), "dictionary": names,
             "valid": None},
            {"name": "k", "kind": "int", "values": k.cpu().numpy(),
             "valid": None}]
    return port, ref


@pytest.mark.cuda
def test_a_1e8_row_answer_over_1e8_strings_is_judged_in_time(card):
    port, ref = _card_answer(N_CARD, card)
    maps = DictMaps()
    t0 = time.time()
    v = compare(port, ref, card, maps)
    torch.cuda.synchronize()
    first = time.time() - t0
    # a second answer over the same dictionary, its rows in another order
    back = [dict(e, values=e["values"][::-1].copy()) for e in port]
    t0 = time.time()
    w = compare(back, ref, card, maps)
    torch.cuda.synchronize()
    second = time.time() - t0
    print(f"compare of {N_CARD} rows: first {first:.3f} s, second "
          f"{second:.3f} s")
    assert v.wrong_cells == 0 and w.wrong_cells == 0, (v, w)
    assert first <= 60 and second <= 10, (first, second)
