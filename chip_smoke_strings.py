"""The strings phase of chip_smoke.py: the queries that drive the device
string functions on the card, their independent numpy results, and the
comparisons that hold the port's results to them.

  * like_q2 ... like_q20 — TPC-H q2, q9, q13, q14, q16 and q20 with each
                   string predicate as TPC-H's LIKE text
                   (tpch.LIKE_QUERIES; like_q20 for UNITED STATES, as
                   q20_us: the reference's CANADA keeps no supplier at
                   SF10), each equal to phase 5's numpy result of its
                   Contains / StartsWith form;
  * strings_groupby — customer (name above the middle one, a string
                   ordering against a literal) joined with orders,
                   grouped by lower(c_mktsegment) and the phone's country
                   code cast to INT (5 x 25 buckets: segagg), into
                   SUM(o_totalprice), COUNT(*), MIN(length(upper(c_name))),
                   MAX(instr(c_name, '7')) and SUM(CAST(substring(c_phone,
                   4, 3) AS INT)) (numpy: np.char over the dictionaries,
                   exact int64 sums over the rows sorted by group);
  * string_dicts — upper, lower, trim, ltrim and rtrim over c_name's and
                   p_name's dictionaries on the device, each equal to
                   np.char's, and one host-loop transform (lpad);
  * string_edges — every new string class and cast (EDGE_CASES) over
                   EDGE_ROWS rows drawn from about EDGE_ENTRIES entries
                   (nulls, '', white-space runs, %, _ and \\, non-ASCII
                   text, the numeric and date texts of the casts), fetched
                   and held to the port's own CPU path value for value
                   (column digests; the CPU path runs in a process of its
                   own beside the card's queries).

Run by chip_smoke.py; imports numpy only at module level.  The tests
(tests/test_torch_string_functions.py, tests/test_torch_like_tpch.py)
hand EDGE_CASES and `groupby_frame` the JAX package's modules as well.
"""
from __future__ import annotations

import numpy as np

LIKE_OF = {"like_q2": "q2", "like_q9": "q9", "like_q13": "q13",
           "like_q14": "q14", "like_q16": "q16", "like_q20": "q20_us"}
EDGE_ROWS = 1 << 20
EDGE_ENTRIES = 65_536
EDGE_SEED = 14
DICT_TRANSFORMS = ("upper", "lower", "trim", "ltrim", "rtrim")

#: the edge texts every string class and cast meets (besides null)
EDGE_TEXTS = [
    "", "   ", " \t x y \n", "%", "_", "\\", "a\\b", "100%", "a%b_c", "é",
    "ß", "Straße", "ﬆ", "école", "e\u0301te\u0301", "😀", "a😀b",
    "ÉCOLE été", " ß ", "ǅungla", "\x1ftab\x1c", " 12 ", "1e3", "1_000",
    "-0", "9223372036854775807", "9223372036854775808",
    "-9223372036854775808", "NaN", "Infinity", "-inf", "2020-1-5",
    "2020-01-05T10:00", "2020", "2020-02-30", "2021-12-31 23:59", "yes",
    "0", "T", "no", "1.5", "-12.7", "12.345", "0.005", "aGVsbG8=", "%%",
    "w6k=", "ff", "-17", "zz", "777", "1,2,3,b", "a,b,c",
    "http://user:pw@Host.com:8080/p/a.html?x=1&y=2#frag",
    "https://[::1]/x", "noscheme.com/x", "Robert", "Tymczak", "Ashcraft"]
#: what the generated entries are made of: ASCII letters and digits,
#: LIKE's metacharacters, white space, and one- to four-byte characters
_ALPHABET = list("abeloABZ0179.-:/,% _\\\t") + [
    "é", "ß", "ﬆ", "\u0301", "😀", "ǅ", "日"]


def _port():
    from spark_rapids_tpu_torch import types as T
    from spark_rapids_tpu_torch.plan import aggregates as A
    from spark_rapids_tpu_torch.plan import expressions as E
    from spark_rapids_tpu_torch.plan import strings as S
    from spark_rapids_tpu_torch.session import col
    return T, E, S, A, col


# ---------------------------------------------------------------------------
# The queries (port side)
# ---------------------------------------------------------------------------

def like_query(name: str):
    """The port's query function of a LIKE form."""
    import functools
    from spark_rapids_tpu_torch import tpch
    if name == "like_q20":
        return functools.partial(tpch.q20, nation="UNITED STATES", like=True)
    return tpch.LIKE_QUERIES[name]


def name_floor(n_customers: int) -> str:
    """The middle customer's name: strings_groupby keeps the names above
    it (half the customers, at any scale)."""
    return f"Customer#{n_customers // 2:09d}"


def groupby_frame(E, S, A, T, col, customer, orders, n_customers: int):
    """strings_groupby over two DataFrames of a package whose modules are
    handed in (the port's here; the tests also hand the reference's)."""
    cust = customer.filter(E.GreaterThan(col("c_name"),
                                         E.Literal(name_floor(n_customers))))
    j = orders.join(cust, left_on=["o_custkey"], right_on=["c_custkey"])
    return (j.group_by(
        E.Alias(S.Lower(col("c_mktsegment")), "segment"),
        E.Alias(E.Cast(S.SplitPart(col("c_phone"), "-", 1), T.INT),
                "country"))
        .agg((A.Sum(col("o_totalprice")), "revenue"),
             (A.Count(None), "orders"),
             (A.Min(S.Length(S.Upper(col("c_name")))), "min_name_len"),
             (A.Max(S.Instr(col("c_name"), "7")), "max_seven_at"),
             (A.Sum(E.Cast(S.Substring(col("c_phone"), 4, 3), T.INT)),
              "sum_exchange"))
        .sort("segment", "country"))


def strings_groupby(s, t):
    T, E, S, A, col = _port()
    return groupby_frame(E, S, A, T, col, s.from_host(t["customer"]),
                         s.from_host(t["orders"]), t["customer"].num_rows)


#: every new string class, LIKE shape, ordering and cast: name -> a
#: function of (expressions module, strings module, col, types module)
#: that makes the expression
EDGE_CASES = {
    "upper": lambda E, S, c, T: S.Upper(c("s")),
    "lower": lambda E, S, c, T: S.Lower(c("s")),
    "initcap": lambda E, S, c, T: S.InitCap(c("s")),
    "trim": lambda E, S, c, T: S.StringTrim(c("s")),
    "ltrim": lambda E, S, c, T: S.StringTrimLeft(c("s")),
    "rtrim": lambda E, S, c, T: S.StringTrimRight(c("s")),
    "trim_chars": lambda E, S, c, T: S.StringTrim(
        c("s"), E.Literal("dl% ")),
    "ltrim_chars": lambda E, S, c, T: S.StringTrimLeft(
        c("s"), E.Literal("ah")),
    "rtrim_chars": lambda E, S, c, T: S.StringTrimRight(
        c("s"), E.Literal("o\\")),
    "substring": lambda E, S, c, T: S.Substring(c("s"), 2, 3),
    "concat": lambda E, S, c, T: S.Concat(c("s"), E.Literal("!")),
    "concat_around": lambda E, S, c, T: S.Concat(
        E.Literal(">>"), c("s"), E.Literal("é")),
    "concat_null": lambda E, S, c, T: S.Concat(
        c("s"), E.Literal(None, T.STRING)),
    "concat_ws": lambda E, S, c, T: S.ConcatWs(
        "-", c("s"), E.Literal("z")),
    "concat_ws_null_part": lambda E, S, c, T: S.ConcatWs(
        "-", E.Literal("a"), c("s"), E.Literal(None, T.STRING),
        E.Literal("z")),
    "concat_ws_alone": lambda E, S, c, T: S.ConcatWs(",", c("s")),
    "concat_ws_null_sep": lambda E, S, c, T: S.ConcatWs(
        E.Literal(None, T.STRING), c("s"), E.Literal("z")),
    "replace": lambda E, S, c, T: S.StringReplace(c("s"), "l", "L"),
    "replace_empty": lambda E, S, c, T: S.StringReplace(
        c("s"), "", "L"),
    "replace_delete": lambda E, S, c, T: S.StringReplace(
        c("s"), "é", ""),
    "lpad": lambda E, S, c, T: S.Lpad(c("s"), 8, "*"),
    "rpad": lambda E, S, c, T: S.Rpad(c("s"), 8, "ab"),
    "lpad_truncate": lambda E, S, c, T: S.Lpad(c("s"), 3),
    "rpad_empty_pad": lambda E, S, c, T: S.Rpad(c("s"), 6, ""),
    "repeat": lambda E, S, c, T: S.StringRepeat(c("s"), 2),
    "repeat_negative": lambda E, S, c, T: S.StringRepeat(c("s"), -1),
    "reverse": lambda E, S, c, T: S.Reverse(c("s")),
    "split_part": lambda E, S, c, T: S.SplitPart(c("s"), "l", 2),
    "split_part_last": lambda E, S, c, T: S.SplitPart(
        c("s"), " ", -1),
    "split_part_zero": lambda E, S, c, T: S.SplitPart(c("s"), ",", 0),
    "split_part_empty_delim": lambda E, S, c, T: S.SplitPart(
        c("s"), "", 1),
    "translate": lambda E, S, c, T: S.Translate(c("s"), "lé%", "Lx"),
    "substring_index": lambda E, S, c, T: S.SubstringIndex(
        c("s"), "l", 2),
    "substring_index_last": lambda E, S, c, T: S.SubstringIndex(
        c("s"), ",", -2),
    "left": lambda E, S, c, T: S.Left(c("s"), 3),
    "right": lambda E, S, c, T: S.Right(c("s"), 2),
    "right_zero": lambda E, S, c, T: S.Right(c("s"), 0),
    "base64": lambda E, S, c, T: S.Base64E(c("s")),
    "unbase64": lambda E, S, c, T: S.UnBase64(c("s")),
    "soundex": lambda E, S, c, T: S.SoundEx(c("s")),
    "hex": lambda E, S, c, T: S.Hex(c("s")),
    "conv_16_10": lambda E, S, c, T: S.Conv(c("s"), 16, 10),
    "conv_10_signed_2": lambda E, S, c, T: S.Conv(c("s"), 10, -2),
    "conv_36_16": lambda E, S, c, T: S.Conv(c("s"), 36, 16),
    "parse_url_host": lambda E, S, c, T: S.ParseUrl(c("s"), "HOST"),
    "parse_url_query_key": lambda E, S, c, T: S.ParseUrl(
        c("s"), "QUERY", "y"),
    "parse_url_userinfo": lambda E, S, c, T: S.ParseUrl(
        c("s"), "USERINFO"),
    "parse_url_file": lambda E, S, c, T: S.ParseUrl(c("s"), "FILE"),
    "locate": lambda E, S, c, T: S.StringLocate("l", c("s")),
    "locate_from": lambda E, S, c, T: S.StringLocate("l", c("s"), 4),
    "locate_zero": lambda E, S, c, T: S.StringLocate("", c("s"), 0),
    "locate_empty": lambda E, S, c, T: S.StringLocate("", c("s"), 3),
    "instr": lambda E, S, c, T: S.Instr(c("s"), "o"),
    "instr_non_ascii": lambda E, S, c, T: S.Instr(c("s"), "ß"),
    "ascii": lambda E, S, c, T: S.Ascii(c("s")),
    "levenshtein": lambda E, S, c, T: S.Levenshtein(c("s"), "hallo"),
    "find_in_set": lambda E, S, c, T: S.FindInSet("b", c("s")),
    "find_in_set_comma": lambda E, S, c, T: S.FindInSet(
        "a,b", c("s")),
    "length": lambda E, S, c, T: S.Length(c("s")),
    "octet_length": lambda E, S, c, T: S.OctetLength(c("s")),
    "bit_length": lambda E, S, c, T: S.BitLength(c("s")),
    "like_prefix": lambda E, S, c, T: S.Like(c("s"), "he%"),
    "like_suffix": lambda E, S, c, T: S.Like(c("s"), "%lo"),
    "like_contains": lambda E, S, c, T: S.Like(c("s"), "%ell%"),
    "like_equals": lambda E, S, c, T: S.Like(c("s"), "hello"),
    "like_prefix_suffix": lambda E, S, c, T: S.Like(c("s"), "h%o"),
    "like_underscore": lambda E, S, c, T: S.Like(c("s"), "h_llo"),
    "like_escapes": lambda E, S, c, T: S.Like(c("s"), r"a\%b\_c"),
    "like_escaped_percent": lambda E, S, c, T: S.Like(c("s"), r"%\%"),
    "like_backslash": lambda E, S, c, T: S.Like(c("s"), "%\\\\%"),
    "like_anything": lambda E, S, c, T: S.Like(c("s"), "%"),
    "like_empty": lambda E, S, c, T: S.Like(c("s"), ""),
    "like_general": lambda E, S, c, T: S.Like(c("s"), "%l%o%"),
    "like_non_ascii": lambda E, S, c, T: S.Like(c("s"), "%é%"),
    "like_one_char": lambda E, S, c, T: S.Like(c("s"), "_"),
    "like_own_escape": lambda E, S, c, T: S.Like(c("s"), "a#%%", "#"),
    "less": lambda E, S, c, T: E.LessThan(c("s"), E.Literal("hello")),
    "less_equal": lambda E, S, c, T: E.LessThanOrEqual(
        c("s"), E.Literal("hello")),
    "greater": lambda E, S, c, T: E.GreaterThan(c("s"), E.Literal("é")),
    "greater_equal_empty": lambda E, S, c, T: E.GreaterThanOrEqual(
        c("s"), E.Literal("")),
    "literal_less": lambda E, S, c, T: E.LessThan(
        E.Literal("b"), c("s")),
    "literal_greater_equal": lambda E, S, c, T: E.GreaterThanOrEqual(
        E.Literal("hello"), c("s")),
    "greater_absent": lambda E, S, c, T: E.GreaterThan(
        c("s"), E.Literal("hellp")),
    **{f"cast_{n.lower()}": (lambda n: lambda E, S, c, T: E.Cast(
        c("s"), getattr(T, n)))(n)
       for n in ("BYTE", "SHORT", "INT", "LONG", "FLOAT", "DOUBLE",
                 "BOOLEAN", "DATE")},
    "cast_decimal_10_2": lambda E, S, c, T: E.Cast(
        c("s"), T.DecimalType(10, 2)),
    "cast_decimal_38_4": lambda E, S, c, T: E.Cast(
        c("s"), T.DecimalType(38, 4)),
}


def edge_dictionary(entries: int = EDGE_ENTRIES, seed: int = EDGE_SEED
                    ) -> np.ndarray:
    """EDGE_TEXTS and words of up to 12 characters drawn from _ALPHABET,
    `entries` distinct strings, sorted."""
    rng = np.random.default_rng(seed)
    words = set(EDGE_TEXTS)
    while len(words) < entries:
        n = entries - len(words)
        lens = rng.integers(0, 13, n)
        picks = rng.integers(0, len(_ALPHABET), int(lens.sum()))
        at = 0
        for k in lens.tolist():
            words.add("".join(_ALPHABET[i] for i in picks[at:at + k]))
            at += k
    return np.array(sorted(words), str)


def edge_table(rows: int = EDGE_ROWS, entries: int = EDGE_ENTRIES,
               seed: int = EDGE_SEED):
    """A HostBatch: "s" draws `rows` codes over edge_dictionary (one row
    in 16 null), "i" is the row number."""
    from spark_rapids_tpu_torch import types as T
    from spark_rapids_tpu_torch.columnar.host import HostBatch, HostColumn
    d = edge_dictionary(entries, seed)
    rng = np.random.default_rng(seed + 1)
    codes = rng.integers(0, len(d), rows).astype(np.int32)
    valid = rng.random(rows) >= 1 / 16
    codes[~valid] = 0
    return HostBatch([HostColumn(codes, valid, T.STRING, d),
                      HostColumn(np.arange(rows, dtype=np.int64), None,
                                 T.LONG)], ["s", "i"])


def edge_values(s, table, names=None):
    """Every EDGE_CASES expression (or those `names`) over `table`, one
    column each."""
    T, E, S, _A, col = _port()
    return s.from_host(table).select(
        *[E.Alias(EDGE_CASES[name](E, S, col, T), name)
          for name in (names or EDGE_CASES)])


# ---------------------------------------------------------------------------
# numpy results
# ---------------------------------------------------------------------------

def _col(hb, name):
    return hb.column_by_name(name)


def expected_groupby(t) -> dict:
    """strings_groupby in numpy: the string work per dictionary entry by
    np.char, gathered per customer, the orders joined by index (c_custkey
    is 0..n-1), grouped through a stable argsort, exact int64 sums."""
    cust, orders = t["customer"], t["orders"]
    n = cust.num_rows
    name, phone, seg = (_col(cust, c) for c in ("c_name", "c_phone",
                                                "c_mktsegment"))
    keep = (name.dictionary > name_floor(n))[name.data]
    seg_names, seg_code = np.unique(np.char.lower(seg.dictionary),
                                    return_inverse=True)
    seg_of = seg_code.reshape(-1)[seg.data]
    country = np.char.partition(phone.dictionary, "-")[:, 0].astype(
        np.int64)[phone.data]
    exchange = np.array([p[3:6] for p in phone.dictionary.tolist()]).astype(
        np.int64)[phone.data]
    name_len = np.char.str_len(np.char.upper(name.dictionary))[name.data]
    seven_at = (np.char.find(name.dictionary, "7") + 1)[name.data]
    ocust = _col(orders, "o_custkey").data
    rows = keep[ocust]
    c = ocust[rows]
    price = _col(orders, "o_totalprice").data[rows]
    key = seg_of[c].astype(np.int64) * 64 + country[c]
    order = np.argsort(key, kind="stable")
    ks = key[order]
    starts = np.flatnonzero(np.r_[True, ks[1:] != ks[:-1]]) if len(ks) \
        else np.zeros(0, np.int64)
    firsts = ks[starts]
    return {"segment": [str(seg_names[k // 64]) for k in firsts],
            "country": (firsts % 64).tolist(),
            "revenue": np.add.reduceat(price[order], starts).tolist(),
            "orders": np.diff(np.r_[starts, len(ks)]).tolist(),
            "min_name_len": np.minimum.reduceat(
                name_len[c][order], starts).tolist(),
            "max_seven_at": np.maximum.reduceat(
                seven_at[c][order], starts).tolist(),
            "sum_exchange": np.add.reduceat(
                exchange[c][order], starts).tolist()}


def expected(name: str, tables):
    if name == "strings_groupby":
        return expected_groupby(tables)
    raise KeyError(name)


def expected_transform(d: np.ndarray, kind: str) -> np.ndarray:
    """np.char's transform of every entry (exact for these ASCII names;
    numpy's strip takes Python's white space)."""
    fn = {"upper": np.char.upper, "lower": np.char.lower,
          "trim": np.char.strip, "ltrim": np.char.lstrip,
          "rtrim": np.char.rstrip}[kind]
    return np.asarray(fn(d), str)


def column_digest(c) -> str:
    """sha256 of a HostColumn's values: its null mask, then its valid
    values (a string column's as the entries they name, so dictionaries
    that differ only in unused entries agree; numbers by their bytes, so
    -0.0 is not 0.0 and a NaN's bits count)."""
    import hashlib
    h = hashlib.sha256()
    valid = c.valid_mask()
    h.update(np.packbits(valid).tobytes())
    x = c.data[valid]
    if c.dictionary is not None:
        used, x = np.unique(x, return_inverse=True)
        words = c.dictionary[used]
        h.update(np.char.str_len(words).astype(np.int64).tobytes())
        h.update("".join(words.tolist()).encode("utf-8", "surrogatepass"))
        x = x.astype(np.int64)
    h.update(np.ascontiguousarray(x).tobytes())
    return h.hexdigest()


def cpu_edge_digests(rows: int = EDGE_ROWS, entries: int = EDGE_ENTRIES,
                     seed: int = EDGE_SEED, threads: int = 2):
    """string_edges on the port's CPU path, in a process of its own (the
    smoke runs it beside the card's queries): ({column: column_digest},
    the collect's ms)."""
    import time
    import torch
    from spark_rapids_tpu_torch.session import TpuSession
    torch.set_num_threads(threads)
    table = edge_table(rows, entries, seed)
    t0 = time.perf_counter()
    out = edge_values(TpuSession(device="cpu"), table).collect()
    ms = (time.perf_counter() - t0) * 1e3
    return {n: column_digest(c) for n, c in zip(out.names, out.columns)}, ms
