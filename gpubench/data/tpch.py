"""TPC-H's eight tables from a seed, as plain numpy (`gpubench.tables`).

A frozen copy of the draws of `ballista_tpu_torch/datagen/tpch.py` (the
same columns, value ranges and formulas), arranged so that a run builds
SF10 in seconds and writes no file:

- every table except region and nation is cut into `CHUNKS` row ranges,
  each drawn from its own stream `(seed, table, chunk)`, as the
  program's chunked datagen does; a lineitem chunk belongs to the orders
  chunk it expands. The chunks run on a pool of threads (numpy's bulk
  draws and arithmetic release the GIL), and the count of threads does
  not change the rows;
- comments are text as dbgen makes it (TPC-H v3 section 4.2.2.10): a
  text pool of sentences from dbgen's grammar and word lists
  (`text_pool`), and each comment a substring of it at a random offset,
  of a random length from 0.4 to 1.6 times the column's mean. Addresses
  are dbgen's v-strings: 10 to 40 random characters of its 64-letter
  alphabet. Both are nearly distinct per row, and are handed to the
  program as bytes and spans, as an arrow string column holds them;
- a few supplier comments hold dbgen's 'Customer ... Complaints' or
  'Customer ... Recommends' (Q16), at its rate;
- the other string columns come out as codes into sorted dictionaries:
  names and phone numbers through integer keys whose order is the
  strings' order, so no per-row string is made or sorted.

`register` hands the arrays to the system under test the way
`register_tpch` would ingest them, each column at first use: a string
column RAW where its estimated distinct count passes
BALLISTA_RAW_DICT_MAX (at SF10 o_comment, l_comment and ps_comment),
else a sorted dictionary.
"""

from __future__ import annotations

import datetime
import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from ..tables import Col, Tables, encode, rng, string_col, text_bytes, text_col

CHUNKS = 16
MONEY = "decimal(15,2)"

EPOCH = datetime.date(1970, 1, 1)


def _days(y, m, d):
    return (datetime.date(y, m, d) - EPOCH).days


STARTDATE = _days(1992, 1, 1)
CURRENTDATE = _days(1995, 6, 17)
ENDDATE = _days(1998, 12, 31)

REGIONS = ["AFRICA", "AMERICA", "ASIA", "EUROPE", "MIDDLE EAST"]
NATIONS = [
    ("ALGERIA", 0), ("ARGENTINA", 1), ("BRAZIL", 1), ("CANADA", 1),
    ("EGYPT", 4), ("ETHIOPIA", 0), ("FRANCE", 3), ("GERMANY", 3),
    ("INDIA", 2), ("INDONESIA", 2), ("IRAN", 4), ("IRAQ", 4),
    ("JAPAN", 2), ("JORDAN", 4), ("KENYA", 0), ("MOROCCO", 0),
    ("MOZAMBIQUE", 0), ("PERU", 1), ("CHINA", 2), ("ROMANIA", 3),
    ("SAUDI ARABIA", 4), ("VIETNAM", 2), ("RUSSIA", 3),
    ("UNITED KINGDOM", 3), ("UNITED STATES", 1),
]
SEGMENTS = ["AUTOMOBILE", "BUILDING", "FURNITURE", "MACHINERY", "HOUSEHOLD"]
PRIORITIES = ["1-URGENT", "2-HIGH", "3-MEDIUM", "4-NOT SPECIFIED", "5-LOW"]
SHIPMODES = ["REG AIR", "AIR", "RAIL", "SHIP", "TRUCK", "MAIL", "FOB"]
INSTRUCTIONS = ["DELIVER IN PERSON", "COLLECT COD", "NONE", "TAKE BACK RETURN"]
TYPE_S1 = ["STANDARD", "SMALL", "MEDIUM", "LARGE", "ECONOMY", "PROMO"]
TYPE_S2 = ["ANODIZED", "BURNISHED", "PLATED", "POLISHED", "BRUSHED"]
TYPE_S3 = ["TIN", "NICKEL", "BRASS", "STEEL", "COPPER"]
CONTAIN_S1 = ["SM", "LG", "MED", "JUMBO", "WRAP"]
CONTAIN_S2 = ["CASE", "BOX", "BAG", "JAR", "PKG", "PACK", "CAN", "DRUM"]
# sorted, lower-case letters only: a name's five colour ranks, read as
# digits, order the names as their strings sort
COLORS = ["almond", "antique", "aquamarine", "azure", "beige", "bisque",
          "black", "blanched", "blue", "blush", "brown", "burlywood",
          "burnished", "chartreuse", "chiffon", "chocolate", "coral",
          "cornflower", "cornsilk", "cream", "cyan", "dark", "deep",
          "dim", "dodger", "drab", "firebrick", "floral", "forest",
          "frosted", "gainsboro", "ghost", "goldenrod", "green", "grey",
          "honeydew", "hot", "hotpink", "indian", "ivory", "khaki",
          "lace", "lavender", "lawn", "lemon", "light", "lime", "linen",
          "magenta", "maroon", "medium", "metallic", "midnight", "mint",
          "misty", "moccasin", "navajo", "navy", "olive", "orange",
          "orchid", "pale", "papaya", "peach", "peru", "pink", "plum",
          "powder", "puff", "purple", "red", "rose", "rosy", "royal",
          "saddle", "salmon", "sandy", "seashell", "sienna", "sky",
          "slate", "smoke", "snow", "spring", "steel", "tan", "thistle",
          "tomato", "turquoise", "violet", "wheat", "white", "yellow"]
# dbgen's grammar (dists.dss): a sentence, its noun and verb phrases, and
# the words of each part of speech, each with its weight
GRAMMAR = [("N V T", 3), ("N V P T", 3), ("N V N T", 3), ("N P V N T", 1),
           ("N P V P T", 1)]
NOUN_PHRASES = [("N", 10), ("J N", 20), ("J, J N", 10), ("D J N", 50)]
VERB_PHRASES = [("V", 30), ("X V", 1), ("V D", 40), ("X V D", 1)]
NOUNS = [("foxes", 1), ("ideas", 1), ("theodolites", 1), ("pinto beans", 1),
         ("instructions", 1), ("dependencies", 10), ("excuses", 10),
         ("platelets", 10), ("asymptotes", 10), ("courts", 5),
         ("dolphins", 5), ("multipliers", 1), ("sauternes", 1),
         ("warthogs", 1), ("frets", 1), ("dinos", 1), ("attainments", 1),
         ("somas", 1), ("Tiresias", 1), ("patterns", 1), ("forges", 1),
         ("braids", 1), ("hockey players", 1), ("frays", 1),
         ("warhorses", 1), ("dugouts", 1), ("notornis", 1), ("epitaphs", 1),
         ("pearls", 1), ("tithes", 1), ("waters", 1), ("orbits", 1),
         ("gifts", 1), ("sheaves", 1), ("depths", 1), ("sentiments", 1),
         ("decoys", 1), ("realms", 1), ("pains", 1), ("grouches", 1),
         ("escapades", 1), ("packages", 40), ("requests", 40),
         ("accounts", 40), ("deposits", 40)]
VERBS = [("sleep", 20), ("wake", 20), ("are", 20), ("cajole", 20),
         ("haggle", 20), ("nag", 10), ("use", 10), ("boost", 10),
         ("affix", 5), ("detect", 5), ("integrate", 5), ("maintain", 1),
         ("nod", 1), ("was", 1), ("lose", 1), ("sublate", 1), ("solve", 1),
         ("thrash", 1), ("promise", 1), ("engage", 1), ("hinder", 1),
         ("print", 1), ("x-ray", 1), ("breach", 1), ("eat", 1), ("grow", 1),
         ("impress", 1), ("mold", 1), ("poach", 1), ("serve", 1),
         ("run", 1), ("dazzle", 1), ("snooze", 1), ("doze", 1),
         ("unwind", 1), ("kindle", 1), ("play", 1), ("hang", 1),
         ("believe", 1), ("doubt", 1)]
ADJECTIVES = [("furious", 1), ("sly", 1), ("careful", 1), ("blithe", 1),
              ("quick", 1), ("fluffy", 1), ("slow", 1), ("quiet", 1),
              ("ruthless", 1), ("thin", 1), ("close", 1), ("dogged", 1),
              ("daring", 1), ("brave", 1), ("stealthy", 1),
              ("permanent", 1), ("enticing", 1), ("idle", 1), ("busy", 1),
              ("regular", 50), ("final", 40), ("ironic", 40), ("even", 30),
              ("bold", 20), ("silent", 10), ("special", 20),
              ("pending", 20), ("unusual", 20), ("express", 20)]
ADVERBS = [("sometimes", 1), ("always", 1), ("never", 1),
           ("furiously", 50), ("slyly", 50), ("carefully", 50),
           ("blithely", 40), ("quickly", 30), ("fluffily", 20),
           ("slowly", 1), ("quietly", 1), ("ruthlessly", 1), ("thinly", 1),
           ("closely", 1), ("doggedly", 1), ("daringly", 1), ("bravely", 1),
           ("stealthily", 1), ("permanently", 1), ("enticingly", 1),
           ("idly", 1), ("busily", 1), ("regularly", 1), ("finally", 1),
           ("ironically", 1), ("evenly", 1), ("boldly", 1), ("silently", 1)]
PREPOSITIONS = [("about", 50), ("above", 50), ("according to", 50),
                ("across", 50), ("after", 50), ("against", 40),
                ("along", 40), ("alongside of", 30), ("among", 30),
                ("around", 20), ("at", 10), ("atop", 1), ("before", 1),
                ("behind", 1), ("beneath", 1), ("beside", 1),
                ("besides", 1), ("between", 1), ("beyond", 1), ("by", 1),
                ("despite", 1), ("during", 1), ("except", 1), ("for", 1),
                ("from", 1), ("in place of", 1), ("inside", 1),
                ("instead of", 1), ("into", 1), ("near", 1), ("of", 1),
                ("on", 1), ("outside", 1), ("over", 1), ("past", 1),
                ("since", 1), ("through", 1), ("throughout", 1), ("to", 1),
                ("toward", 1), ("under", 1), ("until", 1), ("up", 1),
                ("upon", 1), ("without", 1), ("with", 1), ("within", 1)]
AUXILIARIES = [("do", 1), ("may", 1), ("might", 1), ("shall", 1),
               ("will", 1), ("would", 1), ("can", 1), ("could", 1),
               ("should", 1), ("ought to", 1), ("must", 1),
               ("will have to", 1), ("shall have to", 1),
               ("could have to", 1), ("should have to", 1),
               ("must have to", 1), ("need to", 1), ("try to", 1)]
TERMINATORS = [(".", 50), (";", 1), (":", 1), ("?", 1), ("!", 1), ("--", 1)]

# the text pool is made in blocks of TEXT_BLOCK bytes, each drawn from its
# own stream; its size is the configuration's `text_pool_bytes` (dbgen's
# 300 MiB for TPC-H), else TEXT_POOL_BYTES (small configurations)
TEXT_BLOCK = 4 << 20
TEXT_POOL_BYTES = 16 << 20
# mean lengths of the comments (dbgen's dss.h); a comment is 0.4 to 1.6
# times as long
COMMENT_MEAN = {"r_comment": 72, "n_comment": 72, "s_comment": 63,
                "c_comment": 73, "p_comment": 14, "ps_comment": 124,
                "o_comment": 49, "l_comment": 27}
# addresses: dbgen's v-strings of 10 to 40 characters of this alphabet
ADDRESS_LEN = (10, 40)
ALPHANUM = b"0123456789abcdefghijklmnopqrstuvwxyz ABCDEFGHIJKLMNOPQRSTUVWXYZ,"
# supplier comments with dbgen's Q16 text: 10 in 10,000, half of them
# complaints, each "Customer " and the word `noise` characters apart
BBB_PER_10000 = 10
BBB_BASE, BBB_COMPLAIN, BBB_COMMEND = b"Customer ", b"Complaints", b"Recommends"


class _Vocab:
    """The grammar's words as one table of tokens: a token's bytes with
    the space before it (none before a terminator)."""

    def __init__(self):
        words, self.part = [], {}
        for name, table in (("N", NOUNS), ("V", VERBS), ("J", ADJECTIVES),
                            ("D", ADVERBS), ("P", PREPOSITIONS),
                            ("X", AUXILIARIES), ("T", TERMINATORS)):
            ids = np.arange(len(words), len(words) + len(table))
            self.part[name] = _by_weight(ids, table)
            glue = "" if name == "T" else " "
            words += [glue + x for x, _ in table]
        # "J," of the phrase "J, J N": each adjective with its comma
        self.part["J,"] = _by_weight(
            np.arange(len(words), len(words) + len(ADJECTIVES)), ADJECTIVES)
        words += [" " + x + "," for x, _ in ADJECTIVES]
        self.the = len(words)
        words.append(" the")
        enc = [w.encode() for w in words]
        self.length = np.array([len(b) for b in enc], dtype=np.int64)
        self.offset = np.cumsum(self.length) - self.length
        self.bytes = np.frombuffer(b"".join(enc), dtype=np.uint8)

    def draw(self, r, name, n):
        slots = self.part[name]
        return slots[r.integers(0, len(slots), n)]


def _by_weight(ids, table) -> np.ndarray:
    """Each id repeated as often as its weight: a uniform draw of a slot
    is a draw by weight (as dbgen picks from a distribution)."""
    return np.repeat(ids, [w for _, w in table])


def _forms(r, table, n):
    return _by_weight(np.arange(len(table)), table)[
        r.integers(0, sum(w for _, w in table), n)]


def _noun_phrase(v, r, n):
    """(n, 3) tokens of dbgen's noun phrases: N, J N, "J, J N", D J N."""
    form = _forms(r, NOUN_PHRASES, n)
    out = np.full((n, 3), -1, dtype=np.int64)
    out[:, 2] = v.draw(r, "N", n)
    out[:, 1] = np.where(form >= 1, v.draw(r, "J", n), -1)
    out[:, 0] = np.where(form == 2, v.draw(r, "J,", n),
                         np.where(form == 3, v.draw(r, "D", n), -1))
    return out


def _verb_phrase(v, r, n):
    """(n, 3) tokens of dbgen's verb phrases: V, X V, V D, X V D."""
    form = _forms(r, VERB_PHRASES, n)
    out = np.full((n, 3), -1, dtype=np.int64)
    out[:, 0] = np.where(form % 2 == 1, v.draw(r, "X", n), -1)
    out[:, 1] = v.draw(r, "V", n)
    out[:, 2] = np.where(form >= 2, v.draw(r, "D", n), -1)
    return out


def _prep_phrase(v, r, n):
    """(n, 5) tokens: a preposition, "the" and a noun phrase."""
    return np.concatenate([v.draw(r, "P", n)[:, None],
                           np.full((n, 1), v.the, dtype=np.int64),
                           _noun_phrase(v, r, n)], axis=1)


def _text_block(v, seed, block):
    """TEXT_BLOCK bytes of sentences of dbgen's grammar, from the stream
    (seed, "text", block)."""
    r = rng(seed, "text", block)
    n = TEXT_BLOCK // 50   # sentences average about 62 bytes: more than enough
    form = _forms(r, GRAMMAR, n)
    none3 = np.full((n, 3), -1, dtype=np.int64)
    none5 = np.full((n, 5), -1, dtype=np.int64)
    p1, p2 = _prep_phrase(v, r, n), _prep_phrase(v, r, n)
    n2 = np.concatenate([none3[:, :2], _noun_phrase(v, r, n)], axis=1)
    # N [P] V [N | P] T, by the sentence's form (GRAMMAR's order)
    tail = np.where((form == 1)[:, None] | (form == 4)[:, None], p2,
                    np.where((form == 2)[:, None] | (form == 3)[:, None],
                             n2, none5))
    tokens = np.concatenate([
        _noun_phrase(v, r, n),
        np.where((form >= 3)[:, None], p1, none5),
        _verb_phrase(v, r, n), tail, v.draw(r, "T", n)[:, None]], axis=1)
    tokens = tokens[tokens >= 0]
    lens = v.length[tokens]
    ends = np.cumsum(lens)
    assert ends[-1] >= TEXT_BLOCK, "too few sentences for a block"
    tokens = tokens[:int(np.searchsorted(ends, TEXT_BLOCK)) + 1]
    lens = lens[:len(tokens)]
    # byte i of the block is byte i - (its token's place in the block) of
    # the token's text
    shift = np.repeat(v.offset[tokens] - (ends[:len(tokens)] - lens), lens)
    return v.bytes[shift[:TEXT_BLOCK] + np.arange(TEXT_BLOCK)]


def text_pool(seed: int, ex, size: int = TEXT_POOL_BYTES) -> np.ndarray:
    """dbgen's text pool: `size` bytes of sentences (whole blocks), with
    256 bytes of room after it for the widest comment's window
    (`text_bytes`)."""
    v = _Vocab()
    blocks = list(ex.map(lambda b: _text_block(v, seed, b),
                         range(max(1, size // TEXT_BLOCK))))
    return np.concatenate(blocks + [np.zeros(256, dtype=np.uint8)])


def _comment_spans(r, pool_len: int, name: str, n: int):
    """(starts, ends) of n comments of column `name` in the pool."""
    mean = COMMENT_MEAN[name]
    lens = r.integers(int(mean * 0.4), int(mean * 1.6) + 1, n)
    starts = r.integers(0, pool_len - lens + 1)
    return starts, starts + lens


def _comments(pool, r, name, n) -> Col:
    """n comments of column `name` (the pool's last 256 bytes are room,
    not text)."""
    return text_col(pool, *_comment_spans(r, len(pool) - 256, name, n))


# the program's schema: column -> type, and each table's primary key
SCHEMA = {
    "region": ({"r_regionkey": "int64", "r_name": "string",
                "r_comment": "text"}, ("r_regionkey",)),
    "nation": ({"n_nationkey": "int64", "n_name": "string",
                "n_regionkey": "int64", "n_comment": "text"},
               ("n_nationkey",)),
    "supplier": ({"s_suppkey": "int64", "s_name": "string",
                  "s_address": "text", "s_nationkey": "int64",
                  "s_phone": "string", "s_acctbal": MONEY,
                  "s_comment": "text"}, ("s_suppkey",)),
    "customer": ({"c_custkey": "int64", "c_name": "string",
                  "c_address": "text", "c_nationkey": "int64",
                  "c_phone": "string", "c_acctbal": MONEY,
                  "c_mktsegment": "string", "c_comment": "text"},
                 ("c_custkey",)),
    "part": ({"p_partkey": "int64", "p_name": "string", "p_mfgr": "string",
              "p_brand": "string", "p_type": "string", "p_size": "int32",
              "p_container": "string", "p_retailprice": MONEY,
              "p_comment": "text"}, ("p_partkey",)),
    "partsupp": ({"ps_partkey": "int64", "ps_suppkey": "int64",
                  "ps_availqty": "int32", "ps_supplycost": MONEY,
                  "ps_comment": "text"}, ("ps_partkey", "ps_suppkey")),
    "orders": ({"o_orderkey": "int64", "o_custkey": "int64",
                "o_orderstatus": "string", "o_totalprice": MONEY,
                "o_orderdate": "date32", "o_orderpriority": "string",
                "o_clerk": "string", "o_shippriority": "int32",
                "o_comment": "text"}, ("o_orderkey",)),
    "lineitem": ({"l_orderkey": "int64", "l_partkey": "int64",
                  "l_suppkey": "int64", "l_linenumber": "int32",
                  "l_quantity": MONEY, "l_extendedprice": MONEY,
                  "l_discount": MONEY, "l_tax": MONEY,
                  "l_returnflag": "string", "l_linestatus": "string",
                  "l_shipdate": "date32", "l_commitdate": "date32",
                  "l_receiptdate": "date32", "l_shipinstruct": "string",
                  "l_shipmode": "string", "l_comment": "text"},
                 ("l_orderkey", "l_linenumber")),
}


def _ranges(n: int):
    bounds = [round(i * n / CHUNKS) for i in range(CHUNKS + 1)]
    return [(bounds[c], bounds[c + 1]) for c in range(CHUNKS)]


def _run_chunks(ex, fn, n):
    """fn(c, lo, hi) over the chunks of n rows; each column's parts
    joined in chunk order."""
    parts = list(ex.map(lambda a: fn(*a),
                          [(c, lo, hi) for c, (lo, hi) in enumerate(_ranges(n))]))
    return {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}


def _numbered(prefix: str, n: int) -> np.ndarray:
    """prefix + the zero-padded numbers 1..n: sorted, as the numbers are."""
    return np.char.add(prefix, np.char.zfill(
        np.arange(1, n + 1).astype(str), 9)).astype(object)


def _phones(nk: np.ndarray, a, b, d) -> Col:
    # fixed-width fields: the integer key sorts as the string does
    key = (10 + nk) * 10**10 + a * 10**7 + b * 10**4 + d
    uniq, inv = np.unique(key, return_inverse=True)
    text = [f"{k // 10**10}-{k // 10**7 % 1000}-{k // 10**4 % 1000}-"
            f"{k % 10**4}" for k in uniq.tolist()]
    return string_col(inv.reshape(-1), text)


def _money(v) -> Col:
    return Col(np.asarray(v, dtype=np.int64), MONEY)


def _int(v, dtype="int64") -> Col:
    return Col(np.asarray(v, dtype=np.int64 if dtype == "int64"
                          else np.int32), dtype)


def _address_draws(r, m):
    """m addresses: (their characters, hi to a row; each row's length)."""
    lo, hi = ADDRESS_LEN
    alphabet = np.frombuffer(ALPHANUM, dtype=np.uint8)
    return alphabet[r.integers(0, len(alphabet), m * hi)], \
        r.integers(lo, hi + 1, m)


def _addresses(chars, lens) -> Col:
    starts = np.arange(len(lens), dtype=np.int64) * ADDRESS_LEN[1]
    return text_col(chars, starts, starts + lens)


def _region(seed, pool):
    r = rng(seed, "region")
    return {"r_regionkey": _int(np.arange(5)),
            "r_name": encode(REGIONS, np.arange(5)),
            "r_comment": _comments(pool, r, "r_comment", 5)}


def _nation(seed, pool):
    r = rng(seed, "nation")
    return {"n_nationkey": _int(np.arange(25)),
            "n_name": encode([n for n, _ in NATIONS], np.arange(25)),
            "n_regionkey": _int([k for _, k in NATIONS]),
            "n_comment": _comments(pool, r, "n_comment", 25)}


def _supplier_comments(pool, r, n) -> Col:
    """dbgen's supplier comments: BBB_PER_10000 in 10,000 get "Customer "
    at a random place and "Complaints" (half of them) or "Recommends"
    `noise` characters after it, written over the text; those rows' bytes
    follow the pool."""
    starts, ends = _comment_spans(r, len(pool) - 256, "s_comment", n)
    lens = ends - starts
    bad = r.integers(1, 10001, n) <= BBB_PER_10000
    complain = r.integers(0, 101, n) < 50
    width = len(BBB_BASE) + len(BBB_COMPLAIN)
    noise = r.integers(0, lens - width + 1)
    offset = r.integers(0, lens - width - noise + 1)
    rows = np.flatnonzero(bad)
    col = text_col(pool, starts, ends)
    if not len(rows):
        return col
    text = text_bytes(col, rows)
    w = text.dtype.itemsize
    mat = text.view(np.uint8).reshape(len(rows), w).copy()
    base = np.frombuffer(BBB_BASE, dtype=np.uint8)
    for i, row in enumerate(rows):
        at = int(offset[row])
        mat[i, at:at + len(base)] = base
        word = BBB_COMPLAIN if complain[row] else BBB_COMMEND
        at += len(base) + int(noise[row])
        mat[i, at:at + len(word)] = np.frombuffer(word, dtype=np.uint8)
    starts, ends = starts.copy(), ends.copy()
    starts[rows] = len(pool) + np.arange(len(rows)) * w
    ends[rows] = starts[rows] + lens[rows]
    return text_col(np.concatenate([pool, mat.ravel()]), starts, ends)


def _supplier(sf, seed, pool):
    r = rng(seed, "supplier")
    n = int(10_000 * sf)
    nk = r.integers(0, 25, n)
    phone = (r.integers(100, 1000, n), r.integers(100, 1000, n),
             r.integers(1000, 10000, n))
    bal = r.integers(-99999, 999999, n)
    return {
        "s_suppkey": _int(np.arange(1, n + 1)),
        "s_name": string_col(np.arange(n), _numbered("Supplier#", n)),
        "s_address": _addresses(*_address_draws(r, n)),
        "s_nationkey": _int(nk),
        "s_phone": _phones(nk, *phone),
        "s_acctbal": _money(bal),
        "s_comment": _supplier_comments(pool, r, n),
    }


def _customer(sf, seed, ex, pool):
    n = int(150_000 * sf)

    def chunk(c, lo, hi):
        r = rng(seed, "customer", c)
        m = hi - lo
        out = {"nk": r.integers(0, 25, m),
               "a": r.integers(100, 1000, m), "b": r.integers(100, 1000, m),
               "d": r.integers(1000, 10000, m),
               "bal": r.integers(-99999, 999999, m),
               "seg": r.integers(0, 5, m)}
        out["chars"], out["alen"] = _address_draws(r, m)
        out["cs"], out["ce"] = _comment_spans(r, len(pool) - 256,
                                              "c_comment", m)
        return out
    k = _run_chunks(ex, chunk, n)
    return {
        "c_custkey": _int(np.arange(1, n + 1)),
        "c_name": string_col(np.arange(n), _numbered("Customer#", n)),
        "c_address": _addresses(k["chars"], k["alen"]),
        "c_nationkey": _int(k["nk"]),
        "c_phone": _phones(k["nk"], k["a"], k["b"], k["d"]),
        "c_acctbal": _money(k["bal"]),
        "c_mktsegment": encode(SEGMENTS, k["seg"]),
        "c_comment": text_col(pool, k["cs"], k["ce"]),
    }


def _retail(keys: np.ndarray) -> np.ndarray:
    # dbgen's retail price formula, through float64 as the program has it
    return (90000 + (keys % 20001) / 10 + 100 * (keys % 1000)).astype(np.int64)


def _part(sf, seed, ex, pool):
    n = int(200_000 * sf)
    nc = len(COLORS)

    def chunk(c, lo, hi):
        r = rng(seed, "part", c)
        m = hi - lo
        name = np.zeros(m, dtype=np.int64)
        for _ in range(5):
            name = name * nc + r.integers(0, nc, m)
        out = {"name": name,
               "type": r.integers(0, 6, m) * 25 + r.integers(0, 5, m) * 5
               + r.integers(0, 5, m),
               "cont": r.integers(0, 5, m) * 8 + r.integers(0, 8, m),
               "mfgr": r.integers(0, 5, m),
               "brand": r.integers(0, 5, m) * 5 + r.integers(0, 5, m),
               "size": r.integers(1, 51, m)}
        out["cs"], out["ce"] = _comment_spans(r, len(pool) - 256,
                                              "p_comment", m)
        return out
    k = _run_chunks(ex, chunk, n)
    keys = np.arange(1, n + 1)
    uniq, inv = np.unique(k["name"], return_inverse=True)
    words = np.array(COLORS, dtype=object)
    digits = [(uniq // nc**p) % nc for p in range(4, -1, -1)]
    names = words[digits[0]]
    for d in digits[1:]:
        names = names + " " + words[d]
    types = [f"{a} {b} {c}" for a in TYPE_S1 for b in TYPE_S2 for c in TYPE_S3]
    conts = [f"{a} {b}" for a in CONTAIN_S1 for b in CONTAIN_S2]
    return {
        "p_partkey": _int(keys),
        "p_name": string_col(inv.reshape(-1), names),
        "p_mfgr": encode([f"Manufacturer#{m}" for m in range(1, 6)], k["mfgr"]),
        "p_brand": encode([f"Brand#{m}{x}" for m in range(1, 6)
                           for x in range(1, 6)], k["brand"]),
        "p_type": encode(types, k["type"]),
        "p_size": _int(k["size"], "int32"),
        "p_container": encode(conts, k["cont"]),
        "p_retailprice": _money(_retail(keys)),
        "p_comment": text_col(pool, k["cs"], k["ce"]),
    }


def _partsupp(sf, seed, ex, pool):
    n_part, n_supp = int(200_000 * sf), int(10_000 * sf)

    def chunk(c, lo, hi):
        r = rng(seed, "partsupp", c)
        m = 4 * (hi - lo)
        out = {"avail": r.integers(1, 10000, m),
               "cost": r.integers(100, 100100, m)}
        out["cs"], out["ce"] = _comment_spans(r, len(pool) - 256,
                                              "ps_comment", m)
        return out
    k = _run_chunks(ex, chunk, n_part)
    # four suppliers per part, the ones lineitem draws from
    pk = np.repeat(np.arange(1, n_part + 1), 4)
    sk = (pk + np.tile(np.arange(4), n_part) * (n_supp // 4 + 1)) % n_supp + 1
    return {
        "ps_partkey": _int(pk), "ps_suppkey": _int(sk),
        "ps_availqty": _int(k["avail"], "int32"),
        "ps_supplycost": _money(k["cost"]),
        "ps_comment": text_col(pool, k["cs"], k["ce"]),
    }


def _codes(categories):
    """(sorted distinct categories, int32 code of each category index)."""
    cats = np.asarray(categories, dtype=object).astype(str)
    dictionary, inverse = np.unique(cats, return_inverse=True)
    return dictionary.astype(object), inverse.astype(np.int32).reshape(-1)


def _orders_lineitem(sf, seed, ex, pool):
    """Orders and their lines. Each chunk draws its orders and its line
    counts, then (once every chunk's line count is known) its lines,
    each straight into its rows of the whole columns: no concatenation."""
    n_ord = int(1_500_000 * sf)
    n_cust, n_part, n_supp = (int(150_000 * sf), int(200_000 * sf),
                              int(10_000 * sf))
    n_clerk = max(int(sf * 1000), 2) - 1
    pool_len = len(pool) - 256
    enc = {"status": _codes(["F", "O", "P"]), "prio": _codes(PRIORITIES),
           "flag": _codes(["A", "N", "R"]),
           "lstatus": _codes(["F", "O"]), "instr": _codes(INSTRUCTIONS),
           "mode": _codes(SHIPMODES)}
    i64, i32 = np.int64, np.int32
    o = {"okey": np.empty(n_ord, i64), "ck": np.empty(n_ord, i64),
         "odate": np.empty(n_ord, i32), "total": np.empty(n_ord, i64),
         "status": np.empty(n_ord, i32), "prio": np.empty(n_ord, i32),
         "clerk": np.empty(n_ord, i32), "cs": np.empty(n_ord, i64),
         "ce": np.empty(n_ord, i64)}
    ranges = _ranges(n_ord)

    def orders(c):
        lo, hi = ranges[c]
        r, m = rng(seed, "orders", c), hi - lo
        base = np.arange(lo, hi)
        o["okey"][lo:hi] = (base // 8) * 32 + (base % 8) + 1  # 8 of 32 used
        # only 2/3 of customers have orders (dbgen skips custkey % 3 == 0)
        ck = r.integers(1, n_cust + 1, m)
        ck = np.where(ck % 3 == 0, (ck % (n_cust - 1)) + 1, ck)
        o["ck"][lo:hi] = np.where(ck % 3 == 0, ck + 1, ck)
        odate = r.integers(STARTDATE, ENDDATE - 151, m)
        o["odate"][lo:hi] = odate
        o["total"][lo:hi] = r.integers(100000, 50000000, m)
        o["status"][lo:hi] = enc["status"][1][
            np.where(odate + 151 < CURRENTDATE, 0,
                     np.where(odate > CURRENTDATE, 1, 2))]
        o["prio"][lo:hi] = enc["prio"][1][r.integers(0, 5, m)]
        o["clerk"][lo:hi] = r.integers(1, n_clerk + 1, m) - 1
        o["cs"][lo:hi], o["ce"][lo:hi] = _comment_spans(r, pool_len,
                                                        "o_comment", m)
        q = rng(seed, "lineitem", c)
        return q, q.integers(1, 8, m)               # 1..7 lines per order
    firsts = list(ex.map(orders, range(len(ranges))))
    sizes = [int(per.sum()) for _, per in firsts]
    offsets = np.concatenate([[0], np.cumsum(sizes)]).astype(int)
    n_li = int(offsets[-1])
    li = {k: np.empty(n_li, i64) for k in
          ("okey", "pk", "sk", "qty", "eprice", "disc", "tax", "cs", "ce")}
    li.update({k: np.empty(n_li, i32) for k in
               ("ln", "ship", "commit", "receipt", "flag", "lstatus",
                "instr", "mode")})

    def lines(c):
        (lo, hi), (q, per) = ranges[c], firsts[c]
        a, b = offsets[c], offsets[c + 1]
        n = b - a
        # the order of each line, by cumsum and take, which release the
        # GIL (np.repeat does not)
        starts = np.cumsum(per) - per
        marks = np.zeros(n, dtype=np.int64)
        marks[starts[1:]] = 1
        oi = np.cumsum(marks)
        l_od = o["odate"][lo:hi][oi].astype(np.int64)
        li["okey"][a:b] = o["okey"][lo:hi][oi]
        li["ln"][a:b] = np.arange(n) - starts[oi] + 1
        pk = q.integers(1, n_part + 1, n)
        li["pk"][a:b] = pk
        # a supplier of the part's four in partsupp
        li["sk"][a:b] = (pk + q.integers(0, 4, n) * (n_supp // 4 + 1)) \
            % n_supp + 1
        qty = q.integers(1, 51, n)
        li["qty"][a:b] = qty * 100
        li["eprice"][a:b] = qty * _retail(pk)
        li["disc"][a:b] = q.integers(0, 11, n)
        li["tax"][a:b] = q.integers(0, 9, n)
        ship = l_od + q.integers(1, 122, n)
        li["ship"][a:b] = ship
        li["commit"][a:b] = l_od + q.integers(30, 91, n)
        receipt = ship + q.integers(1, 31, n)
        li["receipt"][a:b] = receipt
        ra = np.array([2, 0])[q.integers(0, 2, n)]  # returned: R or A
        li["flag"][a:b] = enc["flag"][1][np.where(receipt <= CURRENTDATE,
                                                  ra, 1)]
        li["lstatus"][a:b] = enc["lstatus"][1][(ship > CURRENTDATE)
                                               .astype(np.int64)]
        li["instr"][a:b] = enc["instr"][1][q.integers(0, 4, n)]
        li["mode"][a:b] = enc["mode"][1][q.integers(0, 7, n)]
        li["cs"][a:b], li["ce"][a:b] = _comment_spans(q, pool_len,
                                                      "l_comment", n)
    list(ex.map(lines, range(len(ranges))))

    def s(key, table):
        return string_col(table[key], enc[key][0])
    orders_t = {
        "o_orderkey": Col(o["okey"], "int64"), "o_custkey": Col(o["ck"], "int64"),
        "o_orderstatus": s("status", o), "o_totalprice": Col(o["total"], MONEY),
        "o_orderdate": Col(o["odate"], "date32"), "o_orderpriority": s("prio", o),
        "o_clerk": string_col(o["clerk"], _numbered("Clerk#", n_clerk)),
        "o_shippriority": Col(np.zeros(n_ord, np.int32), "int32"),
        "o_comment": text_col(pool, o["cs"], o["ce"]),
    }
    lineitem = {
        "l_orderkey": Col(li["okey"], "int64"), "l_partkey": Col(li["pk"], "int64"),
        "l_suppkey": Col(li["sk"], "int64"), "l_linenumber": Col(li["ln"], "int32"),
        "l_quantity": Col(li["qty"], MONEY), "l_extendedprice": Col(li["eprice"], MONEY),
        "l_discount": Col(li["disc"], MONEY), "l_tax": Col(li["tax"], MONEY),
        "l_returnflag": s("flag", li), "l_linestatus": s("lstatus", li),
        "l_shipdate": Col(li["ship"], "date32"),
        "l_commitdate": Col(li["commit"], "date32"),
        "l_receiptdate": Col(li["receipt"], "date32"),
        "l_shipinstruct": s("instr", li), "l_shipmode": s("mode", li),
        "l_comment": text_col(pool, li["cs"], li["ce"]),
    }
    return orders_t, lineitem


def generate(config: dict, seed: int, threads: int = 0) -> Tables:
    """The eight tables at `config["scale_factor"]` from `seed`."""
    sf = float(config["scale_factor"])
    threads = threads or min(8, os.cpu_count() or 1)
    with ThreadPoolExecutor(threads) as ex:
        pool = text_pool(seed, ex, int(config.get("text_pool_bytes",
                                                  TEXT_POOL_BYTES)))
        orders, lineitem = _orders_lineitem(sf, seed, ex, pool)
        tables = {"region": _region(seed, pool),
                  "nation": _nation(seed, pool),
                  "supplier": _supplier(sf, seed, pool),
                  "customer": _customer(sf, seed, ex, pool),
                  "part": _part(sf, seed, ex, pool),
                  "partsupp": _partsupp(sf, seed, ex, pool),
                  "orders": orders, "lineitem": lineitem}
    return {name: {c: tables[name][c] for c in SCHEMA[name][0]}
            for name in SCHEMA}


def register(ctx, tables: Tables, config: dict) -> None:
    """The tables into the program's context as `register_tpch` registers
    them: each column ingested at first use, a generated string column
    RAW where ingest would make it so (`as_ingested`), a text column from
    its bytes and spans as an arrow string column is
    (`port.host_table`)."""
    from functools import partial

    from ballista_tpu_torch.batch import raw_dict_max
    from ballista_tpu_torch.client.context import LazyColumn
    from ballista_tpu_torch.datagen.tpch import as_ingested

    from ..port import host_table
    raw_max = raw_dict_max()
    for name in SCHEMA:
        fields, cols = host_table(tables[name], raw_max)
        ctx.register_host(
            name, fields,
            {c: h if isinstance(h, LazyColumn) else
             LazyColumn(len(h.values), partial(as_ingested, h, raw_max))
             for c, h in cols.items()},
            primary_key=SCHEMA[name][1])
