"""The io phase of chip_smoke.py: the port's own file formats on the card,
at SF10 on the data phase's TPC-H columns.

Writes (each printing its seconds, its bytes on disk, its MB/s of raw
lane bytes and the codec's ratio against the raw lanes):

  * `write_parquet` of the columns q1, q3 and q6 read: lineitem's eight
    (60,012,150 rows), orders' four (15,000,000) and customer's two
    (1,500,000), in ZSTD, the writer's default, through the DataFrame
    API; lineitem again in SNAPPY as LINEITEM_FILES files; row groups at
    the writer's default (1,048,576 rows, a quarter of the scan's batch:
    AUTO merges a file's row groups into the batches of the same query
    over the tables in memory).

Cases (the query cases each a cold and a warm run through TpuSession()
on cuda, printing the walls, the host decode ms of each row group
summed, the row groups and bytes decoded, the host-to-device bytes and
the kernel launches), each held against numpy:

  * pq_q1, pq_q3, pq_q6: q1, q3 and q6 over `read_parquet` of those
    files, each equal to phase 5's numpy result, its launches equal to
    phase 5's for the same query; q6 under each reader strategy
    (PERFILE, MULTITHREADED, COALESCING; the others under AUTO), printing
    the row groups that pruning kept;
  * pq_roundtrip: q3's result written with `partition_by` (o_orderdate)
    and with `bucket_by` (o_orderkey, 4 buckets), each read back equal;
  * cache_q3: q3 over orders' q3 filter `cache()`d: its cached bytes
    against the raw lane bytes of the rows it holds, two replays equal
    to numpy;
  * csv_supp, json_supp_io, hive_supp_io: supplier written and read back
    in each text format (DOUBLE balances from CSV and JSON, exact
    decimals from Hive text with its schema);
  * avro_orders: orders' first AVRO_ROWS rows through Avro;
  * iceberg_cust: customer as an Iceberg table of two data files, one
    positional and one equality delete file;
  * ifn_q6: input_file_name() grouped over the SNAPPY lineitem files,
    each file's count equal to numpy's.

Files go to a temporary directory under TMPDIR, removed at the end.
Imports torch only at module level.
"""
from __future__ import annotations

import json
import os
import shutil
import tempfile
import time

import numpy as np
import torch

TABLE_COLUMNS = {
    "lineitem": ("l_orderkey", "l_quantity", "l_extendedprice",
                 "l_discount", "l_tax", "l_returnflag", "l_linestatus",
                 "l_shipdate"),
    "orders": ("o_orderkey", "o_custkey", "o_orderdate", "o_shippriority"),
    "customer": ("c_custkey", "c_mktsegment", "c_nationkey"),
    "supplier": ("s_suppkey", "s_name", "s_address", "s_phone",
                 "s_nationkey", "s_acctbal", "s_comment"),
}
#: the columns of each table the query files hold
QUERY_COLUMNS = {"lineitem": TABLE_COLUMNS["lineitem"],
                 "orders": TABLE_COLUMNS["orders"],
                 "customer": ("c_custkey", "c_mktsegment")}
WANTS = ("q1", "q3", "q6")
CASES = ("pq_q1", "pq_q3", "pq_q6_perfile", "pq_q6_multithreaded",
         "pq_q6_coalescing", "pq_roundtrip", "cache_q3", "csv_supp",
         "json_supp_io", "hive_supp_io", "avro_orders", "iceberg_cust",
         "ifn_q6")
STRATEGIES = ("PERFILE", "MULTITHREADED", "COALESCING")
LINEITEM_FILES = 6
AVRO_ROWS = 1_000_000
LIMIT_S = 150.0
READER = "spark.rapids.tpu.sql.format.parquet.reader.type"


def narrow(tables) -> dict:
    return {n: tables[n].select(list(c)) for n, c in TABLE_COLUMNS.items()}


def _session(conf=None):
    from spark_rapids_tpu_torch.session import TpuSession
    return TpuSession(conf)


class FileSession:
    """A session whose `from_host` of a TPC-H table reads that table's
    files instead (the tpch queries stay as written)."""

    def __init__(self, real, tables, files):
        self._real = real
        self._files = {id(tables[k]): v for k, v in files.items()
                       if k in tables}

    def from_host(self, table):
        return self._real.read_parquet(*self._files[id(table)])

    def __getattr__(self, name):
        return getattr(self._real, name)


def _raw_bytes(hb) -> int:
    from spark_rapids_tpu_torch.columnar.host import host_nbytes
    return sum(host_nbytes(c) for c in hb.columns)


def _file_bytes(path: str) -> int:
    if os.path.isfile(path):
        return os.path.getsize(path)
    return sum(os.path.getsize(os.path.join(d, f))
               for d, _s, fs in os.walk(path) for f in fs)


def _log_write(C, what, secs, raw, nbytes):
    C.log(f"[io] write {what}: {secs:.2f} s, {nbytes} bytes on disk, "
          f"{raw / secs / 1e6:.1f} MB/s of raw lanes, ratio "
          f"{raw / nbytes:.2f} against the raw lanes ({raw} bytes)")


def write_query_files(C, s, t, root) -> dict:
    """The query tables in ZSTD through `write_parquet`, and lineitem in
    SNAPPY as several files.  -> {table: [files]}, with
    "lineitem_snappy"."""
    from spark_rapids_tpu_torch.io.parquet import write_table
    files = {}
    for name, cols in QUERY_COLUMNS.items():
        hb = t[name].select(list(cols))
        d = os.path.join(root, f"{name}_zstd")
        t0 = time.perf_counter()
        s.from_host(hb).write_parquet(d)
        secs = time.perf_counter() - t0
        files[name] = [os.path.join(d, "part-00000.parquet")]
        _log_write(C, f"{name} ZSTD ({hb.num_rows} rows, "
                   "DataFrame.write_parquet)", secs, _raw_bytes(hb),
                   _file_bytes(d))
    li = t["lineitem"].select(list(QUERY_COLUMNS["lineitem"]))
    n = li.num_rows
    step = -(-n // LINEITEM_FILES)
    snappy = []
    t0 = time.perf_counter()
    for i, off in enumerate(range(0, n, step)):
        p = os.path.join(root, "lineitem_snappy", f"part-{i:05d}.parquet")
        os.makedirs(os.path.dirname(p), exist_ok=True)
        write_table(li.slice(off, min(step, n - off)), p, "snappy")
        snappy.append(p)
    secs = time.perf_counter() - t0
    files["lineitem_snappy"] = snappy
    _log_write(C, f"lineitem SNAPPY ({n} rows, {len(snappy)} files)", secs,
               _raw_bytes(li), _file_bytes(os.path.dirname(snappy[0])))
    return files


def _query_case(C, s, name, build, t, files, base):
    """One query over the files: cold and warm walls, decode and upload
    counts, launches; -> (result, launches)."""
    from spark_rapids_tpu_torch.columnar.device import (UPLOADS,
                                                        reset_upload_counts)
    from spark_rapids_tpu_torch.io.parquet import (DECODE_COUNTS,
                                                   reset_decode_counts)
    reset_decode_counts()
    reset_upload_counts()
    got, _ctx, cold, warm, peak, ln = C._timed(
        FileSession(s, t, files), lambda fs, tt: build(fs, tt), t, reps=1)
    dec = dict(DECODE_COUNTS)
    up = UPLOADS["bytes"]
    C._check_launches(base, ln)
    C.log(f"[io] {name}: {got.num_rows} rows; cold {cold:.1f} ms, warm "
          f"{warm:.1f} ms; cold and warm together decoded {dec['units']} "
          f"row groups, {dec['rows']} rows, {dec['file_bytes']} file bytes "
          f"in {dec['decode_ns'] / 1e6:.1f} host ms (each row group's "
          f"decode summed; concurrent ones overlap); host-to-device {up} "
          f"bytes; peak "
          f"{peak:.2f} GiB; kernel launches {ln}")
    return got, ln


def _check_query(C, name, q, got, want):
    lanes = C.lanes_of(got)
    if q == "q3":
        C.check_top(name, lanes, want[q])
    else:
        C.check(lanes == want[q], f"{name} differs from {q}'s numpy result")


def _values(hb, cols=None):
    """Column -> Python values of a HostBatch."""
    return {n: hb.column_by_name(n).to_pylist()
            for n in (cols or hb.names)}


def _sorted_rows(d: dict, key: str) -> list:
    names = list(d)
    rows = list(zip(*(d[n] for n in names)))
    k = names.index(key)
    return sorted(rows, key=lambda r: r[k])


def io_phase(C, tables, want, path_launches) -> dict:
    """Every case on the card; `path_launches` are q1's, q3's and q6's
    from the path phase of this run.  -> launches by case."""
    t_phase = time.perf_counter()
    root = tempfile.mkdtemp(prefix="chip_smoke_io_")
    try:
        launches = _cases(C, tables, want, path_launches, root)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    secs = time.perf_counter() - t_phase
    C.log(f"[io] phase {secs:.1f} s (limit {LIMIT_S:g} s)")
    C.check(secs < LIMIT_S, f"the io phase took {secs:.1f} s, past its "
            f"{LIMIT_S:g} s")
    return launches


def _cases(C, t, want, path_launches, root) -> dict:
    from spark_rapids_tpu_torch import tpch
    from spark_rapids_tpu_torch.io import parquet as P
    s = _session()
    launches = {}
    files = write_query_files(C, s, t, root)
    # pq_q1, pq_q3 under AUTO; pq_q6 under each strategy
    for q in ("q1", "q3"):
        got, ln = _query_case(C, s, f"pq_{q}", getattr(tpch, q), t, files,
                              f"pq_{q}")
        _check_query(C, f"pq_{q}", q, got, want)
        C.check(ln == path_launches[q], f"pq_{q} launched {ln}, {q} "
                f"{path_launches[q]}")
        launches[f"pq_{q}"] = ln
    li_files = files["lineitem"]
    total_rg = sum(len(P.read_footer(f).row_groups) for f in li_files)
    for strategy in STRATEGIES:
        name = f"pq_q6_{strategy.lower()}"
        ss = _session({READER: strategy})
        got, ln = _query_case(C, ss, name, tpch.q6, t, files, "pq_q6")
        _check_query(C, name, "q6", got, want)
        C.check(ln == path_launches["q6"], f"{name} launched {ln}, q6 "
                f"{path_launches['q6']}")
        launches[name] = ln
    q6_plan = tpch.q6(FileSession(s, t, files), t).physical()
    scan = _find(q6_plan.root, "ParquetScanExec")
    kept = P._scan_units(li_files, P.conjunctive_terms(scan.filter_expr))
    C.log(f"[io] pq_q6: row-group pruning kept {len(kept)} of {total_rg} "
          f"row groups (its pushed filter: {scan.filter_expr!r})")
    launches["pq_roundtrip"] = _roundtrip(C, s, t, files, want, root)
    launches["cache_q3"] = _cache_case(C, s, t, want)
    launches.update(_text_cases(C, s, t, root))
    launches["avro_orders"] = _avro_case(C, s, t, root)
    launches["iceberg_cust"] = _iceberg_case(C, s, t, root)
    launches["ifn_q6"] = _ifn_case(C, s, files["lineitem_snappy"],
                                   t["lineitem"].num_rows)
    return launches


def _find(node, cls_name):
    if type(node).__name__ == cls_name:
        return node
    for c in list(getattr(node, "children", ())) + \
            [getattr(node, n) for n in ("host_child", "device_child")
             if getattr(node, n, None) is not None]:
        hit = _find(c, cls_name)
        if hit is not None:
            return hit
    return None


def _count_launches(fn):
    from spark_rapids_tpu_torch.ops.hopper import LAUNCHES, \
        reset_launch_counts
    reset_launch_counts()
    out = fn()
    torch.cuda.synchronize()
    return out, dict(LAUNCHES)


def _roundtrip(C, s, t, files, want, root) -> dict:
    """q3's result written partitioned and bucketed, read back equal."""
    from spark_rapids_tpu_torch import tpch
    from spark_rapids_tpu_torch.io.parquet import hive_partitions, read_table
    from spark_rapids_tpu_torch.plan import expressions as E
    from spark_rapids_tpu_torch.plan.aggregates import Count
    df = tpch.q3(FileSession(s, t, files), t)
    res = df.collect()
    rows = _sorted_rows(_values(res), "o_orderkey")
    t0 = time.perf_counter()
    pdir = os.path.join(root, "q3_partitioned")
    _x, ln = _count_launches(lambda: df.write_parquet(
        pdir, partition_by=["o_orderdate"]))
    back = []
    for f, parts in hive_partitions(pdir):
        hb = read_table(f)
        d = _values(hb)
        n = hb.num_rows
        d["o_orderdate"] = [parts["o_orderdate"]] * n
        back += _sorted_rows({k: d[k] for k in res.names}, "o_orderkey")
    as_text = [tuple(str(v) if k == 1 else v for k, v in enumerate(r))
               for r in rows]
    C.check(sorted(back) == sorted(as_text),
            "q3 partitioned by o_orderdate did not read back equal")
    bdir = os.path.join(root, "q3_bucketed")
    df.write_parquet(bdir, bucket_by=(["o_orderkey"], 4))
    bfiles = sorted(os.path.join(bdir, f) for f in os.listdir(bdir))
    got = s.read_parquet(*bfiles).filter(E.IsNotNull(E.ColumnRef(
        "o_orderkey"))).collect()
    C.check(_sorted_rows(_values(got), "o_orderkey") == rows,
            "q3 bucketed by o_orderkey did not read back equal")
    counts = s.read_parquet(*bfiles).group_by("o_orderkey").agg(
        (Count(None), "n")).collect()
    C.check(sorted(counts.column_by_name("n").to_pylist()) ==
            [1] * res.num_rows, "a q3 row was written to two buckets")
    C._check_launches("pq_roundtrip", ln)
    C.log(f"[io] pq_roundtrip: q3's {res.num_rows} rows written into "
          f"{len(hive_partitions(pdir))} o_orderdate partitions and "
          f"{len(bfiles)} of 4 o_orderkey buckets, each read back equal, "
          f"in {(time.perf_counter() - t0) * 1e3:.1f} ms; write launches "
          f"{ln}")
    return ln


def _cache_case(C, s, t, want) -> dict:
    """q3 over orders' q3 filter, cached."""
    from spark_rapids_tpu_torch import tpch
    from spark_rapids_tpu_torch import types as T
    from spark_rapids_tpu_torch.plan import expressions as E
    from spark_rapids_tpu_torch.session import col
    orders = t["orders"]
    cached = s.from_host(orders).filter(E.LessThan(
        col("o_orderdate"), E.Literal(C.Q3_DATE, T.DATE))).cache()

    class CachedSession:
        def __init__(self, real):
            self._real = real

        def from_host(self, table):
            return cached if table is orders else self._real.from_host(table)

        def __getattr__(self, name):
            return getattr(self._real, name)
    cs = CachedSession(s)
    t0 = time.perf_counter()
    got, ln = _count_launches(lambda: tpch.q3(cs, t).collect())
    cold = (time.perf_counter() - t0) * 1e3
    lc = cached._plan
    _check_query(C, "cache_q3", "q3", got, want)
    C._check_launches("cache_q3", ln)
    walls = []
    for _ in range(2):
        t0 = time.perf_counter()
        again = tpch.q3(cs, t).collect()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
        _check_query(C, "cache_q3", "q3", again, want)
    C.check(lc.cached_bytes() > 0, "cache_q3 cached nothing")
    kept = orders.column_by_name("o_orderdate").data < C.Q3_DATE
    raw = int(kept.sum()) * sum(c.data.itemsize for c in orders.columns)
    C.log(f"[io] cache_q3: {lc.cached_bytes()} cached bytes against "
          f"{raw} raw lane bytes of its {int(kept.sum())} rows (ratio "
          f"{raw / lc.cached_bytes():.2f}; {lc.raw_bytes()} uncompressed "
          f"page bytes); first run "
          f"(materializes) {cold:.1f} ms, replays {walls[0]:.1f} and "
          f"{walls[1]:.1f} ms, each equal to q3's numpy result; launches "
          f"{ln}")
    return ln


def _text_cases(C, s, t, root) -> dict:
    """supplier through CSV, JSON lines and Hive text."""
    from spark_rapids_tpu_torch.io import text as TX
    from spark_rapids_tpu_torch.plan import expressions as E
    from spark_rapids_tpu_torch.session import col
    supp = t["supplier"]
    exact = _values(supp)
    as_double = dict(exact)
    as_double["s_acctbal"] = [float(v) for v in exact["s_acctbal"]]
    exact_rows = _sorted_rows(exact, "s_suppkey")
    double_rows = _sorted_rows(as_double, "s_suppkey")
    out = {}
    for name, ext, writer, reader, want_rows in (
            ("csv_supp", "csv", TX.write_csv, "read_csv", double_rows),
            ("json_supp_io", "jsonl", TX.write_json, "read_json",
             double_rows),
            ("hive_supp_io", "hive", TX.write_hive_text, "read_hive_text",
             exact_rows)):
        p = os.path.join(root, f"supplier.{ext}")
        t0 = time.perf_counter()
        writer(supp, p)
        w = time.perf_counter() - t0
        kw = {"schema": supp.schema} if reader == "read_hive_text" else {}
        t0 = time.perf_counter()
        got, ln = _count_launches(lambda: getattr(s, reader)(p, **kw).filter(
            E.GreaterThanOrEqual(col("s_suppkey"), E.Literal(0))).collect())
        r = time.perf_counter() - t0
        rows = _sorted_rows(_values(got, supp.names), "s_suppkey")
        C.check(rows == want_rows, f"{name} did not read back equal")
        C.log(f"[io] {name}: {got.num_rows} rows written in {w:.2f} s "
              f"({os.path.getsize(p)} bytes), read back through the card "
              f"in {r:.2f} s, equal; launches {ln}")
        out[name] = ln
    return out


def _avro_case(C, s, t, root) -> dict:
    from spark_rapids_tpu_torch.io.avro import write_avro
    from spark_rapids_tpu_torch.plan import expressions as E
    from spark_rapids_tpu_torch.session import col
    o = t["orders"].slice(0, min(AVRO_ROWS, t["orders"].num_rows))
    p = os.path.join(root, "orders.avro")
    t0 = time.perf_counter()
    write_avro(o, p)
    w = time.perf_counter() - t0
    t0 = time.perf_counter()
    got, ln = _count_launches(lambda: s.read_avro(p).filter(
        E.GreaterThanOrEqual(col("o_orderkey"), E.Literal(0))).collect())
    r = time.perf_counter() - t0
    want = {n: o.column_by_name(n).data.tolist() for n in o.names}
    C.check(C.lanes_of(got) == want, "avro_orders did not read back equal")
    C.log(f"[io] avro_orders: {o.num_rows} rows written in {w:.2f} s "
          f"({os.path.getsize(p)} bytes, deflate), read back through the "
          f"card in {r:.2f} s, equal; launches {ln}")
    return ln


def _iceberg_case(C, s, t, root) -> dict:
    """customer as an Iceberg table: two data files, a positional delete
    of every 1,000th row of the first, an equality delete of one market
    segment."""
    from spark_rapids_tpu_torch.columnar.host import from_numpy
    from spark_rapids_tpu_torch import types as T
    from spark_rapids_tpu_torch.io.avro import write_avro_records
    from spark_rapids_tpu_torch.io.parquet import write_table
    from spark_rapids_tpu_torch.plan import expressions as E
    from spark_rapids_tpu_torch.session import col
    cust = t["customer"]
    n = cust.num_rows
    half = n // 2
    tbl = os.path.join(root, "iceberg_customer")
    data_dir, meta_dir = os.path.join(tbl, "data"), os.path.join(tbl,
                                                                "metadata")
    os.makedirs(data_dir)
    os.makedirs(meta_dir)
    t0 = time.perf_counter()
    f1, f2 = (os.path.join(data_dir, f"part-{i}.parquet") for i in (0, 1))
    write_table(cust.slice(0, half), f1)
    write_table(cust.slice(half, n - half), f2)
    dead_pos = np.arange(0, half, 1000, dtype=np.int64)
    pd = os.path.join(data_dir, "pos-del.parquet")
    write_table(from_numpy({"file_path": np.array([f1] * len(dead_pos)),
                            "pos": dead_pos}, T.StructType(
        [T.StructField("file_path", T.STRING),
         T.StructField("pos", T.LONG)])), pd)
    seg = cust.column_by_name("c_mktsegment")
    dead_seg = str(seg.dictionary[0])
    ed = os.path.join(data_dir, "eq-del.parquet")
    write_table(from_numpy({"c_mktsegment": np.array([dead_seg])},
                           T.StructType([T.StructField("c_mktsegment",
                                                       T.STRING)])), ed)
    entry = {"type": "record", "name": "manifest_entry", "fields": [
        {"name": "status", "type": "int"},
        {"name": "data_file", "type": {"type": "record", "name": "r2",
                                       "fields": [
            {"name": "content", "type": "int"},
            {"name": "file_path", "type": "string"},
            {"name": "equality_ids",
             "type": ["null", {"type": "array", "items": "int"}]}]}}]}
    mpath = os.path.join(meta_dir, "manifest.avro")
    write_avro_records(entry, [
        {"status": 1, "data_file": {"content": c, "file_path": f,
                                    "equality_ids": ids}}
        for c, f, ids in ((0, f1, None), (0, f2, None), (1, pd, None),
                          (2, ed, [2]))], mpath)
    lpath = os.path.join(meta_dir, "snap-1.avro")
    write_avro_records({"type": "record", "name": "manifest_file",
                        "fields": [{"name": "manifest_path",
                                    "type": "string"}]},
                       [{"manifest_path": mpath}], lpath)
    fields = [{"id": i + 1, "name": nm, "required": False, "type": ty}
              for i, (nm, ty) in enumerate((("c_custkey", "long"),
                                            ("c_mktsegment", "string"),
                                            ("c_nationkey", "long")))]
    with open(os.path.join(meta_dir, "v1.metadata.json"), "w") as f:
        json.dump({"format-version": 2, "current-snapshot-id": 1,
                   "schemas": [{"schema-id": 0, "type": "struct",
                                "fields": fields}],
                   "current-schema-id": 0,
                   "snapshots": [{"snapshot-id": 1,
                                  "manifest-list": lpath}]}, f)
    w = time.perf_counter() - t0
    keep = np.ones(n, bool)
    keep[dead_pos] = False
    keep &= seg.dictionary[seg.data] != dead_seg
    t0 = time.perf_counter()
    got, ln = _count_launches(lambda: s.read_iceberg(tbl).filter(
        E.GreaterThanOrEqual(col("c_custkey"), E.Literal(0))).collect())
    r = time.perf_counter() - t0
    want = {nm: (cust.column_by_name(nm).dictionary[
        cust.column_by_name(nm).data[keep]].tolist()
        if cust.column_by_name(nm).dictionary is not None
        else cust.column_by_name(nm).data[keep].tolist())
        for nm in cust.names}
    C.check(C.lanes_of(got) == want, "iceberg_cust differs from numpy")
    C.log(f"[io] iceberg_cust: {n} customers in 2 data files, "
          f"{len(dead_pos)} positional deletes, the equality delete of "
          f"c_mktsegment {dead_seg!r}: {got.num_rows} rows equal numpy; "
          f"written in {w:.2f} s, read through the card in {r:.2f} s; "
          f"launches {ln}")
    return ln


def _ifn_case(C, s, li_files, n) -> dict:
    """input_file_name() grouped over the SNAPPY lineitem files, each
    file's count equal to the rows `write_query_files` gave it."""
    from spark_rapids_tpu_torch.plan.aggregates import Count
    from spark_rapids_tpu_torch.plan.misc import InputFileName
    from spark_rapids_tpu_torch.session import col
    t0 = time.perf_counter()
    got, ln = _count_launches(lambda: s.read_parquet(*li_files).select(
        InputFileName(), col("l_quantity"), names=["f", "q"]).group_by(
        "f").agg((Count(None), "n")).collect())
    r = (time.perf_counter() - t0) * 1e3
    step = -(-n // LINEITEM_FILES)
    want = {f: min(step, n - i * step) for i, f in enumerate(li_files)}
    d = got.to_pydict()
    C.check(dict(zip(d["f"], d["n"])) == want,
            f"ifn_q6 counts {d} differ from the files' {want}")
    C.log(f"[io] ifn_q6: {len(want)} files, each file's count equal "
          f"({sum(want.values())} rows) in {r:.1f} ms; launches {ln}")
    return ln
