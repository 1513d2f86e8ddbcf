"""The structs phase of chip_smoke.py: STRUCT and MAP columns, the regex
automaton and the JSON and misc functions on the card, at SF10 on the
data phase's TPC-H columns.

Every nested column here is built with the port's numpy constructors
(`columnar/host.struct_column`, `map_column`), never from Arrow.  Cases
(each a cold run and one warm run through TpuSession() on cuda,
printing its walls, the peak device memory, the plan's exec names and
its kernel launches):

  * struct_q1: lineitem's q1 columns wrapped in one STRUCT `l` (every
    11th row a null struct), q1 written over GetStructField: the shatter
    turns the fields into lanes and q1 runs as q1 does; equal to numpy's
    q1 over the non-null rows, with q1's kernels (seg_sums);
  * struct_q3: orders as a STRUCT `o`, q3 joining on `o.o_orderkey`
    (and `o.o_custkey`), grouping by its fields: equal to q3's numpy
    answer, with build_table and probe_first launched;
  * struct_group: a group-by and a sort on a whole STRUCT key of
    (l_returnflag, l_linestatus, l_shipmode), every 13th row a null
    struct, over all lineitem rows: the struct re-nests at the top,
    equal to numpy's counts in Spark's struct order (a null struct
    first);
  * map_sf10: a MAP<INT, LONG> per order (keys each line's 1-based
    position in its order, values l_partkey; every 17th map null):
    element_at(m, 1), size(m) and array_max(map_keys(m)) on the device,
    a filter on element_at IS NOT NULL and the sums, equal to numpy; a
    passthrough of 1,000 maps re-nests on the host, entry by entry;
  * rlike_q9, rlike_q13: q9 with `p_name RLIKE 'green'` and q13 with
    `o_comment RLIKE 'special.*requests'`, built here (tpch.py keeps its
    own forms), equal to q9's and q13's numpy answers; each prints the
    DFA's states, the dictionary's entries and bytes, and the runner's
    CUDA-event ms;
  * json_supp: a JSON text column over supplier (s_suppkey, s_name,
    s_acctbal): get_json_object, json_tuple and from_json -> field ->
    to_json, equal to Python's json;
  * mono_id: monotonically_increasing_id and spark_partition_id over
    lineitem: unique, and each `(batch << 33) | row`.

struct_q1 and map_sf10 (both parts) run again under
`sql.compile.wholePlan=ON`, print the decision and equal the eager run.
The numpy results (`WANTS`) are computed in the data phase's fork pool,
before the card is used.  Imports torch only at module level.
"""
from __future__ import annotations

import datetime as pydt
import json
import re
import time

import numpy as np
import torch

TABLE_COLUMNS = {
    "lineitem": ("l_orderkey", "l_partkey", "l_suppkey", "l_quantity",
                 "l_extendedprice", "l_discount", "l_tax", "l_returnflag",
                 "l_linestatus", "l_shipdate", "l_shipmode"),
    "orders": ("o_orderkey", "o_custkey", "o_orderdate", "o_shippriority",
               "o_comment"),
    "customer": ("c_custkey", "c_mktsegment"),
    "part": ("p_partkey", "p_name"),
    "supplier": ("s_suppkey", "s_nationkey", "s_name", "s_acctbal"),
    "partsupp": ("ps_partkey", "ps_suppkey", "ps_supplycost"),
    "nation": ("n_nationkey", "n_name"),
}
#: the lineitem fields struct_q1's STRUCT holds
Q1_FIELDS = ("l_quantity", "l_extendedprice", "l_discount", "l_tax",
             "l_returnflag", "l_linestatus", "l_shipdate")
#: the orders fields struct_q3's STRUCT holds
Q3_FIELDS = ("o_orderkey", "o_custkey", "o_orderdate", "o_shippriority")
GROUP_FIELDS = ("l_returnflag", "l_linestatus", "l_shipmode")
NULL_Q1, NULL_GROUP, NULL_MAP = 11, 13, 17
PASSTHROUGH = 1000
CASES = ("struct_q1", "struct_q3", "struct_group", "map_sf10",
         "map_passthrough", "rlike_q9", "rlike_q13", "json_supp",
         "mono_id")
#: the numpy results the data phase's pool computes
WANTS = ("structs q1", "structs group", "structs map")
#: the later queries' numpy results the phase reads
LATER_WANTS = ("q3", "q9", "q13")
RLIKE = {"rlike_q9": ("part", "p_name", "green"),
         "rlike_q13": ("orders", "o_comment", "special.*requests")}
Q3_DATE = (pydt.date(1995, 3, 15) - pydt.date(1970, 1, 1)).days
Q1_CUTOFF = (pydt.date(1998, 12, 1) - pydt.date(1970, 1, 1)).days - 90


def narrow(tables) -> dict:
    return {n: tables[n].select(list(c)) for n, c in TABLE_COLUMNS.items()}


# ---------------------------------------------------------------------------
# the nested batches (numpy constructors only)
# ---------------------------------------------------------------------------

def _every(n: int, k: int) -> np.ndarray:
    return np.arange(n) % k != 0


def struct_batch(hb, fields, name: str, null_every=None):
    """One STRUCT column `name` over `fields` of `hb` (no copy of the
    children), every `null_every`-th row a null struct."""
    from spark_rapids_tpu_torch.columnar import host as H
    valid = None if null_every is None else _every(hb.num_rows, null_every)
    col = H.struct_column([hb.column_by_name(f) for f in fields],
                          list(fields), valid)
    return H.HostBatch([col], [name])


def map_parts(tables):
    """(the line order, the orders' keys sorted, each order's line count):
    lineitem's rows ordered by l_orderkey (stable), against each order in
    key order."""
    lk = tables["lineitem"].column_by_name("l_orderkey").data
    perm = np.argsort(lk, kind="stable")
    okeys = np.sort(tables["orders"].column_by_name("o_orderkey").data)
    sk = lk[perm]
    counts = np.searchsorted(sk, okeys, "right") - \
        np.searchsorted(sk, okeys, "left")
    return perm.astype(np.int32), okeys, counts.astype(np.int64)


def map_batch(tables, parts):
    """One MAP<INT, LONG> per order, in key order: each line's 1-based
    position in its order -> l_partkey, every NULL_MAP-th map null."""
    from spark_rapids_tpu_torch import types as T
    from spark_rapids_tpu_torch.columnar import host as H
    perm, okeys, counts = parts
    off = np.zeros(len(counts) + 1, np.int64)
    np.cumsum(counts, out=off[1:])
    keys = (np.arange(int(off[-1]), dtype=np.int64) -
            np.repeat(off[:-1], counts) + 1).astype(np.int32)
    vals = tables["lineitem"].column_by_name("l_partkey").data[perm]
    m = H.map_column(H.HostColumn(keys, None, T.INT),
                     H.HostColumn(vals, None, T.LONG), off,
                     _every(len(counts), NULL_MAP))
    return H.HostBatch([H.HostColumn(okeys, None, T.LONG), m],
                       ["o_orderkey", "m"])


def json_batch(tables):
    from spark_rapids_tpu_torch.columnar import host as H
    su = tables["supplier"]
    keys = su.column_by_name("s_suppkey").data
    names = su.column_by_name("s_name")
    names = names.dictionary[names.data]
    bal = su.column_by_name("s_acctbal").data
    text = [json.dumps({"k": int(k), "n": str(n), "b": int(b) / 100})
            for k, n, b in zip(keys.tolist(), names.tolist(),
                               bal.tolist())]
    return H.HostBatch([H.string_column(np.array(text, str))], ["j"]), text


# ---------------------------------------------------------------------------
# the queries
# ---------------------------------------------------------------------------

def _col(name):
    from spark_rapids_tpu_torch.session import col
    return col(name)


def _field(struct: str, name: str):
    from spark_rapids_tpu_torch.plan.collections import GetStructField
    return GetStructField(_col(struct), name)


class _FieldSession:
    """A session whose `from_host` reads one STRUCT batch through its
    fields (GetStructField, named as the fields), so tpch.q1 runs over
    the struct as written."""

    def __init__(self, s, batch, struct: str, fields):
        self.s, self.batch, self.struct, self.fields = s, batch, struct, \
            fields

    def from_host(self, hb):
        df = self.s.from_host(hb)
        if hb is not self.batch:
            return df
        return df.select(*[_field(self.struct, f) for f in self.fields],
                         names=list(self.fields))


def struct_q1(s, t):
    from spark_rapids_tpu_torch import tpch
    return tpch.q1(_FieldSession(s, t["l1"], "l", Q1_FIELDS),
                   {"lineitem": t["l1"]})


def struct_q3(s, t):
    from spark_rapids_tpu_torch import types as T
    from spark_rapids_tpu_torch.plan import expressions as E
    from spark_rapids_tpu_torch.plan.aggregates import Sum
    date = E.Literal(Q3_DATE, T.DATE)
    cust = s.from_host(t["customer"]).filter(
        E.EqualTo(_col("c_mktsegment"), E.Literal("BUILDING")))
    orders = s.from_host(t["o3"]).filter(
        E.LessThan(_field("o", "o_orderdate"), date))
    li = s.from_host(t["lineitem"]).filter(
        E.GreaterThan(_col("l_shipdate"), date))
    j = cust.join(orders, left_on=["c_custkey"],
                  right_on=[_field("o", "o_custkey")]) \
        .join(li, left_on=[_field("o", "o_orderkey")],
              right_on=["l_orderkey"])
    revenue = E.Multiply(_col("l_extendedprice"),
                         E.Subtract(E.Literal(1), _col("l_discount")))
    return (j.group_by(*[E.Alias(_field("o", f), f) for f in
                         ("o_orderkey", "o_orderdate", "o_shippriority")])
            .agg((Sum(revenue), "revenue"))
            .sort(("revenue", False, False), ("o_orderdate", True, True))
            .limit(10))


def struct_group(s, t):
    from spark_rapids_tpu_torch.plan.aggregates import Count
    return s.from_host(t["lg"]).group_by("g").agg((Count(None), "n")) \
        .sort("g")


def map_sf10(s, t):
    from spark_rapids_tpu_torch.plan import collections as C
    from spark_rapids_tpu_torch.plan import expressions as E
    from spark_rapids_tpu_torch.plan.aggregates import Count, Sum
    m = _col("m")
    return (s.from_host(t["maps"])
            .select(C.MapElementAt(m, 1), C.Size(m),
                    C.ArrayMax(C.MapKeys(m)), names=["v1", "n", "kmax"])
            .filter(E.IsNotNull(_col("v1")))
            .agg((Sum(_col("v1")), "sum_v1"), (Sum(_col("n")), "sum_n"),
                 (Sum(_col("kmax")), "sum_kmax"), (Count(None), "rows")))


def map_passthrough(s, t):
    return s.from_host(t["maps_head"])


def rlike_q9(s, t):
    from spark_rapids_tpu_torch.plan import datetime as DT
    from spark_rapids_tpu_torch.plan import expressions as E
    from spark_rapids_tpu_torch.plan.aggregates import Sum
    from spark_rapids_tpu_torch.plan.strings import RLike
    part = s.from_host(t["part"]).filter(RLike(_col("p_name"), "green"))
    j = (s.from_host(t["lineitem"])
         .join(part, left_on=["l_partkey"], right_on=["p_partkey"])
         .join(s.from_host(t["supplier"]),
               left_on=["l_suppkey"], right_on=["s_suppkey"])
         .join(s.from_host(t["partsupp"]),
               left_on=["l_partkey", "l_suppkey"],
               right_on=["ps_partkey", "ps_suppkey"])
         .join(s.from_host(t["orders"]),
               left_on=["l_orderkey"], right_on=["o_orderkey"])
         .join(s.from_host(t["nation"]),
               left_on=["s_nationkey"], right_on=["n_nationkey"]))
    amount = E.Subtract(
        E.Multiply(_col("l_extendedprice"),
                   E.Subtract(E.Literal(1), _col("l_discount"))),
        E.Multiply(_col("ps_supplycost"), _col("l_quantity")))
    return (j.group_by(_col("n_name"),
                       E.Alias(DT.Year(_col("o_orderdate")), "o_year"))
            .agg((Sum(amount), "sum_profit"))
            .sort(("n_name", True, True), ("o_year", False, False)))


def rlike_q13(s, t):
    from spark_rapids_tpu_torch.plan import expressions as E
    from spark_rapids_tpu_torch.plan.aggregates import Count
    from spark_rapids_tpu_torch.plan.strings import RLike
    orders = s.from_host(t["orders"]).filter(
        E.Not(RLike(_col("o_comment"), "special.*requests")))
    j = s.from_host(t["customer"]).join(
        orders, how="left_outer", left_on=["c_custkey"],
        right_on=["o_custkey"])
    per_cust = j.group_by("c_custkey").agg(
        (Count(_col("o_orderkey")), "c_count"))
    return (per_cust.group_by("c_count").agg((Count(None), "custdist"))
            .sort(("custdist", False, False), ("c_count", False, False)))


def json_supp(s, t):
    from spark_rapids_tpu_torch import types as T
    from spark_rapids_tpu_torch.plan.collections import GetStructField
    from spark_rapids_tpu_torch.plan.json_fns import (FromJson,
                                                      GetJsonObject, ToJson,
                                                      json_tuple)
    j = _col("j")
    schema = T.StructType([T.StructField("k", T.LONG),
                           T.StructField("n", T.STRING),
                           T.StructField("b", T.DOUBLE)])
    parsed = FromJson(j, schema)
    return s.from_host(t["json"]).select(
        GetJsonObject(j, "$.n"), *json_tuple(j, "k", "b"),
        GetStructField(parsed, "k"), ToJson(parsed),
        names=["n", "k", "b", "fk", "tj"])


def mono_id(s, t):
    from spark_rapids_tpu_torch.plan.misc import (MonotonicallyIncreasingID,
                                                  SparkPartitionID)
    return s.from_host(t["lineitem"]).select(
        MonotonicallyIncreasingID(), SparkPartitionID(), names=["id", "p"])


BUILDS = {"struct_q1": struct_q1, "struct_q3": struct_q3,
          "struct_group": struct_group, "map_sf10": map_sf10,
          "map_passthrough": map_passthrough, "rlike_q9": rlike_q9,
          "rlike_q13": rlike_q13, "json_supp": json_supp,
          "mono_id": mono_id}


# ---------------------------------------------------------------------------
# numpy results
# ---------------------------------------------------------------------------

def expected(name: str, tables):
    li = tables["lineitem"]
    if name == "structs q1":
        import chip_smoke as C
        from spark_rapids_tpu_torch.columnar import host as H
        keep = _every(li.num_rows, NULL_Q1)
        sub = H.HostBatch([H.HostColumn(li.column_by_name(f).data[keep],
                                        None, li.column_by_name(f).dtype,
                                        li.column_by_name(f).dictionary)
                           for f in Q1_FIELDS], list(Q1_FIELDS))
        return C.expected_q1(sub)
    if name == "structs group":
        cols = [li.column_by_name(f) for f in GROUP_FIELDS]
        valid = _every(li.num_rows, NULL_GROUP)
        code = np.zeros(li.num_rows, np.int64)
        for c in cols:
            code = code * (len(c.dictionary) + 1) + c.data
        # a null struct first (Spark's order: nulls first ascending)
        code = np.where(valid, code + 1, 0)
        uniq, counts = np.unique(code, return_counts=True)
        rows = []
        for u, n in zip(uniq.tolist(), counts.tolist()):
            if u == 0:
                rows.append((None, n))
                continue
            u -= 1
            parts = []
            for c in reversed(cols):
                w = len(c.dictionary) + 1
                parts.append(str(c.dictionary[u % w]))
                u //= w
            rows.append((dict(zip(GROUP_FIELDS, reversed(parts))), n))
        return rows
    if name == "structs map":
        parts = map_parts(tables)
        _perm, _okeys, counts = parts
        valid = _every(len(counts), NULL_MAP)
        first = np.zeros(len(counts) + 1, np.int64)
        np.cumsum(counts, out=first[1:])
        vals = li.column_by_name("l_partkey").data[parts[0]]
        live = valid & (counts > 0)
        v1 = vals[first[:-1][live]]
        sums = {"sum_v1": [int(v1.sum())],
                "sum_n": [int(counts[live].sum())],
                "sum_kmax": [int(counts[live].sum())],
                "rows": [int(live.sum())]}
        return parts, sums
    raise KeyError(name)


# ---------------------------------------------------------------------------
# the phase
# ---------------------------------------------------------------------------

def _session(conf=None):
    from spark_rapids_tpu_torch.session import TpuSession
    return TpuSession(conf)


def _walk(node):
    yield node
    for c in getattr(node, "children", ()):
        yield from _walk(c)
    for c in (getattr(node, "device_child", None),
              getattr(node, "host_child", None)):
        if c is not None:
            yield from _walk(c)


def _check(C, name, got, want, t):
    d = got.to_pydict() if name not in ("struct_q1", "struct_q3",
                                        "mono_id") else None
    if name == "struct_q1":
        C.check(C.lanes_of(got) == want["structs q1"],
                "struct_q1 differs from numpy's q1 over the non-null rows")
    elif name == "struct_q3":
        C.check_top("struct_q3", C.lanes_of(got), want["q3"])
    elif name == "struct_group":
        rows = list(zip(d["g"], d["n"]))
        C.check(rows == want["structs group"], "struct_group differs from "
                f"numpy:\n{rows}\n{want['structs group']}")
    elif name == "map_sf10":
        C.check(d == want["structs map"][1], f"map_sf10 {d} differs from "
                f"numpy {want['structs map'][1]}")
    elif name == "map_passthrough":
        m = t["maps_head"]
        C.check(d == m.to_pydict(), "map_passthrough's re-nested maps "
                "differ from the batch's, entry by entry")
    elif name in ("rlike_q9", "rlike_q13"):
        base = name.split("_")[1]
        C.check_later(base, C.lanes_of(got), want[base])
    elif name == "json_supp":
        text = t["json_text"]
        objs = [json.loads(x) for x in text]
        exp = {"n": [o["n"] for o in objs],
               "k": [str(o["k"]) for o in objs],
               "b": [json.dumps(o["b"]) for o in objs],
               "fk": [o["k"] for o in objs],
               "tj": [json.dumps({"k": o["k"], "n": o["n"],
                                  "b": float(o["b"])},
                                 separators=(",", ":")) for o in objs]}
        order = np.argsort(np.array(d["fk"]), kind="stable")
        want_order = np.argsort(np.array(exp["fk"]), kind="stable")
        for k in exp:
            C.check([d[k][i] for i in order] ==
                    [exp[k][i] for i in want_order],
                    f"json_supp.{k} differs from Python's json")
    elif name == "mono_id":
        ids = got.column_by_name("id").data
        pid = got.column_by_name("p").data.astype(np.int64)
        C.check(bool(np.all(np.diff(pid) >= 0)),
                "mono_id's partition ids do not ascend")
        starts = np.searchsorted(pid, np.arange(int(pid[-1]) + 1))
        row = np.arange(len(pid)) - starts[pid]
        C.check(np.array_equal(ids, (pid << 33) | row),
                "mono_id's ids are not (batch << 33) | row")
        C.check(len(ids) == t["lineitem"].num_rows and
                len(np.unique(ids)) == len(ids), "mono_id's ids repeat")


def _rlike_runner(C, name, t, dev):
    """The DFA's states, the dictionary's entries and bytes, and the
    runner's CUDA-event ms over it."""
    from spark_rapids_tpu_torch.ops import regex as R
    from spark_rapids_tpu_torch.ops import strings as S
    table, column, pattern = RLIKE[name]
    d = t[table].column_by_name(column).dictionary
    dfa = R.compile_dfa(pattern)
    lengths = R.utf8_lengths(d)
    offsets, bytes_ = S.dict_byte_tensors(d, dev)
    order = R.entry_order(lengths, dev)
    table_t = torch.from_numpy(dfa.table.T.astype(np.int16).copy()).to(dev)
    acc = torch.from_numpy(dfa.accepting.copy()).to(dev)
    mask = R.dfa_matches_lanes(table_t, acc, offsets, bytes_, order)
    rx = re.compile(pattern)
    step = max(len(d) // 20000, 1)
    sample = np.arange(0, len(d), step)
    got = mask.cpu().numpy()[sample]
    C.check(np.array_equal(got, np.array(
        [rx.search(v) is not None for v in d[sample].tolist()])),
        f"{name}: the runner differs from Python re over every "
        f"{step}th entry")
    ms = C.cuda_ms(lambda: R.dfa_matches_lanes(table_t, acc, offsets,
                                               bytes_, order),
                   reps=3, warmup=1)
    C.log(f"[structs] {name} runner: DFA of {dfa.num_states} states over "
          f"{len(d)} entries, {int(lengths.sum())} bytes (longest "
          f"{int(lengths.max())}): {ms:.2f} ms (CUDA events, "
          f"{len(order.live)} steps); {int(mask.sum())} entries match")


def structs_phase(C, tables, want) -> dict:
    """Every case on the card; -> launches by case."""
    from spark_rapids_tpu_torch.columnar.device import (UPLOADS,
                                                        reset_upload_counts)
    from spark_rapids_tpu_torch.exec import compiled as CP
    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    t = dict(tables)
    t["l1"] = struct_batch(tables["lineitem"], Q1_FIELDS, "l", NULL_Q1)
    t["o3"] = struct_batch(tables["orders"], Q3_FIELDS, "o")
    t["lg"] = struct_batch(tables["lineitem"], GROUP_FIELDS, "g",
                           NULL_GROUP)
    t["maps"] = map_batch(tables, want["structs map"][0])
    t["maps_head"] = t["maps"].slice(0, PASSTHROUGH)
    t["json"], t["json_text"] = json_batch(tables)
    m = t["maps"].columns[1]
    C.log(f"[structs] nested batches built with numpy in "
          f"{time.perf_counter() - t0:.1f} s: map_sf10 {len(m)} maps, "
          f"{int(m.offsets[-1])} entries (keys {m.elements().data[0].data.nbytes}"
          f" bytes, values {m.elements().data[1].data.nbytes} bytes, "
          f"offsets {m.offsets.nbytes} bytes)")
    s = _session()
    launches = {}
    eager = {}
    for name in CASES:
        reset_upload_counts()
        got, _ctx, cold, _w, peak, ln = C._timed(s, BUILDS[name], t,
                                                 reps=0)
        up_cold, narrow_cold = UPLOADS["bytes"], UPLOADS["narrow_ns"]
        reset_upload_counts()
        t0 = time.perf_counter()
        BUILDS[name](s, t).collect()
        torch.cuda.synchronize()
        warm = (time.perf_counter() - t0) * 1e3
        up_warm, narrow_warm = UPLOADS["bytes"], UPLOADS["narrow_ns"]
        q = BUILDS[name](s, t).physical()
        execs = sorted({type(n).__name__ for n in _walk(q.root)})
        _check(C, name, got, want, t)
        C._check_launches(name, ln)
        launches[name] = ln
        eager[name] = got.to_pydict() if name in ("struct_q1", "map_sf10",
                                                  "map_passthrough") \
            else None
        extra = (f"; execs {execs}; host-to-device bytes cold {up_cold}, "
                 f"warm {up_warm}; host narrowing cold "
                 f"{narrow_cold / 1e6:.1f} ms, warm {narrow_warm / 1e6:.1f} "
                 "ms")
        if name == "map_sf10":
            extra += (f"; ragged lanes m#keys and m#vals "
                      f"{int(m.offsets[-1])} values each")
        C._query_log(name, got.num_rows, cold, warm, peak, ln, extra,
                     tag="structs")
        if name in RLIKE:
            _rlike_runner(C, name, t, dev)
        del got
    # whole-plan capture: the decision, equal to eager
    CP.clear_caches()
    on = _session({"spark.rapids.tpu.sql.compile.wholePlan": "ON"})
    for name in ("struct_q1", "map_sf10", "map_passthrough"):
        q = BUILDS[name](on, t).physical()
        walls = []
        for _ in range(2):                   # the capture, then a replay
            t0 = time.perf_counter()
            got = q.collect()
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
            C.check(got.to_pydict() == eager[name],
                    f"{name} under wholePlan=ON differs from eager")
        top = "; the re-nest runs on the host over the captured device " \
            "part" if q._renest_top() is not None else ""
        C.log(f"[structs] {name} wholePlan=ON: decision {CP.decision(q)}"
              f"{top}; capture run {walls[0]:.1f} ms, replay "
              f"{walls[1]:.1f} ms, equal to eager")
    C.log(f"[structs] phase {time.perf_counter() - t_phase:.1f} s")
    return launches
