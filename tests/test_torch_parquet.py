"""The port's Parquet reader and writer (spark_rapids_tpu_torch/io/
parquet.py, io/thrift.py) against the JAX package's, which reads and
writes through pyarrow.

  * port copies of the parquet tests of tests/test_io.py;
  * one matrix of codec x data page version x dictionary x row-group size
    over every flat type with nulls, files written by pyarrow: the port's
    read equals the reference's `read_parquet(...).collect()` (its CPU
    engine, pyarrow's decode) value for value and type for type;
  * the encodings pyarrow writes on request (DELTA_BINARY_PACKED,
    DELTA_LENGTH_BYTE_ARRAY, DELTA_BYTE_ARRAY, BYTE_STREAM_SPLIT, RLE
    booleans), INT96 and the timestamp units, decimals as INT32, INT64
    and FIXED_LEN_BYTE_ARRAY of every width;
  * files the port writes, read by `pq.read_table`: the reference
    writer's Arrow schema and values, in every codec;
  * the pruned (file, row group) units equal the reference's
    `_scan_units`; pushdown, `partition_by` and `bucket_by`;
  * TPC-H q1, q3 and q6 at scale 0.001 from the port's files, equal to
    the reference's CPU engine over pyarrow's files;
  * each refusal names its item.

Every read is exact; DOUBLE query results compare within rtol 1e-12
(sums may add in another order).
"""
import datetime as pydt
import decimal as pydec
import itertools
import os

import numpy as np
import pyarrow as pa
import pyarrow.dataset as ds
import pyarrow.parquet as pq
import pytest
import torch

from spark_rapids_tpu import tpch as JTPCH
from spark_rapids_tpu.io import parquet as JP
from spark_rapids_tpu.plan import expressions as JE
from spark_rapids_tpu.session import TpuSession as JSession
from spark_rapids_tpu.session import col as jcol
from spark_rapids_tpu_torch import tpch as PTPCH
from spark_rapids_tpu_torch.columnar.host import from_arrow, to_arrow
from spark_rapids_tpu_torch.exec.plan import ExecContext
from spark_rapids_tpu_torch.io import parquet as P
from spark_rapids_tpu_torch.plan import expressions as E
from spark_rapids_tpu_torch.plan.aggregates import Count, Sum
from spark_rapids_tpu_torch.session import TpuSession, col, lit

torch.set_num_threads(1)

JCPU = {"spark.rapids.tpu.sql.enabled": "false"}
_CTX = pydec.Context(prec=80)


def _session(conf=None):
    return TpuSession(conf, device="cpu")


def _same(hb, tbl):
    """A port HostBatch equals a pyarrow table: the types from_arrow
    gives and every value."""
    want = from_arrow(tbl)
    assert hb.names == want.names
    for name in want.names:
        a, b = hb.column_by_name(name), want.column_by_name(name)
        assert a.dtype == b.dtype, name
        assert a.to_pylist() == b.to_pylist(), name


# ---------------------------------------------------------------------------
# port copies of tests/test_io.py
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def pq_files(tmp_path_factory):
    root = tmp_path_factory.mktemp("pq")
    rng = np.random.default_rng(7)
    paths = []
    for i in range(3):
        tbl = pa.table({
            "a": pa.array(np.arange(i * 1000, (i + 1) * 1000), pa.int64()),
            "b": pa.array(rng.uniform(0, 100, 1000).round(3)),
            "s": pa.array([f"g{j % 5}" for j in range(1000)]),
        })
        p = str(root / f"part{i}.parquet")
        pq.write_table(tbl, p, row_group_size=250)
        paths.append(p)
    return paths


def oracle(paths, columns=None):
    return pa.concat_tables([pq.read_table(p, columns=columns)
                             for p in paths])


@pytest.mark.parametrize("strategy",
                         ["PERFILE", "MULTITHREADED", "COALESCING", "AUTO"])
def test_scan_strategies_match_oracle(pq_files, strategy):
    s = _session({"spark.rapids.tpu.sql.format.parquet.reader.type":
                  strategy})
    out = to_arrow(s.read_parquet(*pq_files).collect())
    exp = oracle(pq_files)
    assert out.sort_by("a").to_pydict() == exp.sort_by("a").to_pydict()


def test_scan_device_plan_and_query(pq_files):
    s = _session()
    df = s.read_parquet(*pq_files).filter(E.LessThan(col("a"), lit(500))) \
        .group_by("s").agg((Sum(col("b")), "sb"), (Count(None), "c"))
    q = df.physical()
    assert q.kind == "device"
    out = to_arrow(q.collect()).sort_by("s")
    exp_tbl = oracle(pq_files)
    exp = exp_tbl.filter(pa.compute.less(exp_tbl["a"], 500)) \
        .group_by("s").aggregate([("b", "sum"), ("s", "count")]) \
        .sort_by("s")
    assert out.column("s").to_pylist() == exp.column("s").to_pylist()
    assert out.column("sb").to_pylist() == pytest.approx(
        exp.column("b_sum").to_pylist())
    assert out.column("c").to_pylist() == exp.column("s_count").to_pylist()


def test_column_pruning(pq_files):
    s = _session()
    out = s.read_parquet(*pq_files, columns=["a"]).collect()
    assert out.names == ["a"]
    assert out.num_rows == 3000
    # the planner narrows a scan to what the query reads
    q = s.read_parquet(*pq_files).select(col("b"), names=["b"]).physical()
    assert "ParquetScanExec" in q.physical_tree()
    assert q.collect().names == ["b"]


def test_conjunctive_terms():
    e = E.And(E.And(E.GreaterThan(col("a"), lit(5)),
                    E.GreaterThanOrEqual(lit(10), col("b"))),
              E.EqualTo(col("s"), lit("x")))
    terms = P.conjunctive_terms(e)
    assert ("a", ">", 5) in terms
    assert ("b", "<=", 10) in terms
    assert ("s", "=", "x") in terms
    # non-pushable shapes are skipped, not mis-translated
    assert P.conjunctive_terms(E.Or(E.GreaterThan(col("a"), lit(1)),
                                    E.GreaterThan(col("b"), lit(2)))) == []


def test_row_group_pruning(pq_files):
    # files hold a-ranges [0,1000),[1000,2000),[2000,3000) in 250-row groups
    terms = P.conjunctive_terms(E.And(E.GreaterThanOrEqual(col("a"),
                                                           lit(2500)),
                                      E.LessThan(col("a"), lit(2700))))
    units = P._scan_units(pq_files, terms)
    assert len(units) == 1  # only one 250-row group covers [2500,2700)
    assert len(P._scan_units(pq_files, [])) == 12


def test_filter_pushdown_through_plan(pq_files):
    s = _session()
    df = s.read_parquet(*pq_files).filter(
        E.And(E.GreaterThanOrEqual(col("a"), lit(2500)),
              E.LessThan(col("a"), lit(2700))))
    q = df.physical()
    ctx = ExecContext(q.conf, q.device)
    out = list(q.execute_host_batches(ctx))
    assert sum(b.num_rows for b in out) == 200
    # pruning means only one 250-row group was decoded
    assert ctx.metrics["scanned_rows"] == 250


def test_write_parquet_roundtrip(pq_files, tmp_path):
    s = _session()
    df = s.read_parquet(*pq_files).filter(E.LessThan(col("a"), lit(100)))
    out_path = str(tmp_path / "out")
    df.write_parquet(out_path)
    back = s.read_parquet(out_path + "/part-00000.parquet").collect()
    assert back.num_rows == 100
    assert sorted(back.column_by_name("a").to_pylist()) == list(range(100))


def test_write_parquet_partitioned(pq_files, tmp_path):
    s = _session()
    df = s.read_parquet(*pq_files).filter(E.LessThan(col("a"), lit(50)))
    out_dir = str(tmp_path / "parts")
    df.write_parquet(out_dir, partition_by=["s"])
    back = ds.dataset(out_dir, format="parquet", partitioning="hive") \
        .to_table()
    assert back.num_rows == 50
    # the reference writes the same directories and rows
    jdir = str(tmp_path / "jparts")
    JSession(JCPU).read_parquet(*pq_files).filter(
        jcol("a") < JE.Literal(50)).write_parquet(jdir, partition_by=["s"])
    jback = ds.dataset(jdir, format="parquet", partitioning="hive") \
        .to_table()
    assert sorted(os.listdir(out_dir)) == sorted(os.listdir(jdir))
    assert back.sort_by("a").to_pydict() == jback.sort_by("a").to_pydict()
    for f, parts in P.hive_partitions(out_dir):
        got = P.read_table(f)
        assert got.num_rows and parts.keys() == {"s"}


def test_format_disable_falls_back(pq_files):
    s = _session({"spark.rapids.tpu.sql.format.parquet.enabled": "false"})
    q = s.read_parquet(*pq_files).physical()
    assert q.kind == "host"
    assert "disabled" in " ".join(q.meta.reasons)
    assert q.collect().num_rows == 3000


# ---------------------------------------------------------------------------
# the reader matrix: files written by pyarrow, read by both packages
# ---------------------------------------------------------------------------

def _flat_table(n: int, seed: int) -> pa.Table:
    rng = np.random.default_rng(seed)
    nulls = rng.random(n) < 0.2

    def arr(vals, ty):
        return pa.array([None if m else v for v, m in zip(vals, nulls)], ty)
    epoch = pydt.date(1970, 1, 1)
    return pa.table({
        "b": arr((rng.random(n) < 0.5).tolist(), pa.bool_()),
        "i8": arr(rng.integers(-128, 127, n).tolist(), pa.int8()),
        "i16": arr(rng.integers(-3000, 3000, n).tolist(), pa.int16()),
        "i32": arr(rng.integers(-2 ** 31, 2 ** 31 - 1, n).tolist(),
                   pa.int32()),
        "i64": arr(rng.integers(-2 ** 62, 2 ** 62, n).tolist(), pa.int64()),
        "f32": arr(rng.standard_normal(n).astype(np.float32).tolist(),
                   pa.float32()),
        "f64": arr(rng.standard_normal(n).tolist(), pa.float64()),
        "d": arr([epoch + pydt.timedelta(days=int(x))
                  for x in rng.integers(-20000, 20000, n)], pa.date32()),
        "ts": arr([int(x) for x in rng.integers(-2 ** 50, 2 ** 50, n)],
                  pa.timestamp("us", tz="UTC")),
        "s": arr([f"v{x}é" for x in rng.integers(0, 50, n)], pa.string()),
        "sw": arr([f"wide{x}" for x in rng.integers(0, 10 ** 6, n)],
                  pa.string()),
        "dec": arr([pydec.Decimal(int(x)).scaleb(-2)
                    for x in rng.integers(-10 ** 9, 10 ** 9, n)],
                   pa.decimal128(12, 2)),
        "dec30": arr([pydec.Decimal(int(x) * 10 ** 12 + 7).scaleb(-3, _CTX)
                      for x in rng.integers(-10 ** 9, 10 ** 9, n)],
                     pa.decimal128(30, 3)),
    })


@pytest.fixture(scope="module")
def flat_table():
    return _flat_table(2500, 3)


@pytest.mark.parametrize(
    "codec,version,dictionary,rg",
    list(itertools.product(["NONE", "SNAPPY", "GZIP", "ZSTD"],
                           ["1.0", "2.0"], [True, False], [700, 5000])))
def test_reader_matrix_equals_the_reference(flat_table, tmp_path, codec,
                                            version, dictionary, rg):
    path = str(tmp_path / "m.parquet")
    pq.write_table(flat_table, path, compression=codec,
                   data_page_version=version, use_dictionary=dictionary,
                   row_group_size=rg, data_page_size=4096)
    ref = JSession(JCPU).read_parquet(path).collect()
    got = _session().read_parquet(path).collect()
    _same(got, ref)
    # the port's units are the reference's
    assert P._scan_units([path], []) == JP._scan_units([path], [])


@pytest.mark.parametrize("columns,encoding,version", [
    (["i32", "i64"], "DELTA_BINARY_PACKED", "2.0"),
    (["i32", "i64"], "DELTA_BINARY_PACKED", "1.0"),
    (["s", "sw"], "DELTA_LENGTH_BYTE_ARRAY", "1.0"),
    (["s", "sw"], "DELTA_BYTE_ARRAY", "2.0"),
    (["f32", "f64"], "BYTE_STREAM_SPLIT", "1.0"),
    (["b"], "RLE", "2.0"),
])
def test_requested_encodings(flat_table, tmp_path, columns, encoding,
                             version):
    path = str(tmp_path / "e.parquet")
    tbl = flat_table.select(columns)
    pq.write_table(tbl, path, use_dictionary=False,
                   column_encoding={c: encoding for c in columns},
                   data_page_version=version, data_page_size=2048)
    _same(P.read_table(path), pq.read_table(path))


def test_dictionary_then_plain_in_one_chunk(tmp_path):
    # a dictionary that outgrows its limit falls back to PLAIN mid-chunk
    vals = [f"value-{i:07d}" for i in range(60_000)]
    tbl = pa.table({"s": pa.array(vals[:30_000] + vals[:30_000])})
    path = str(tmp_path / "fb.parquet")
    pq.write_table(tbl, path, dictionary_pagesize_limit=64 << 10,
                   data_page_size=8 << 10)
    encs = pq.ParquetFile(path).metadata.row_group(0).column(0).encodings
    assert "PLAIN" in encs and any("DICTIONARY" in e for e in encs)
    _same(P.read_table(path), pq.read_table(path))


def test_int96_and_timestamp_units(tmp_path):
    path = str(tmp_path / "t.parquet")
    ts = pa.array([0, 1_000_000, -86_400_000_000 * 400 + 123, None,
                   2 ** 45, -1], pa.timestamp("us"))
    pq.write_table(pa.table({"ts": ts}), path,
                   use_deprecated_int96_timestamps=True)
    assert "int96" in str(pq.ParquetFile(path).schema)
    got = P.read_table(path).column_by_name("ts").to_pylist()
    want = pq.read_table(path).column("ts").cast(
        pa.timestamp("us", tz="UTC")).to_pylist()
    assert got == want
    for unit in ("ms", "ns"):
        t2 = pa.table({"ts": pa.array([0, 1000, -5000, None],
                                      pa.timestamp(unit, tz="UTC"))})
        pq.write_table(t2, path, coerce_timestamps=None)
        _same(P.read_table(path), pq.read_table(path))


@pytest.mark.parametrize("precision", [5, 9, 12, 18, 20, 30, 38])
@pytest.mark.parametrize("as_integer", [False, True])
def test_decimals_of_every_width(tmp_path, precision, as_integer):
    top = pydec.Decimal(10 ** precision - 1).scaleb(-2, _CTX)
    vals = [top, top.copy_negate(), None, pydec.Decimal("1.23"),
            pydec.Decimal("-0.01")]
    tbl = pa.table({"x": pa.array(vals, pa.decimal128(precision, 2))})
    path = str(tmp_path / "d.parquet")
    pq.write_table(tbl, path, store_decimal_as_integer=as_integer)
    _same(P.read_table(path), pq.read_table(path))
    st = pq.ParquetFile(path).metadata.row_group(0).column(0).statistics
    assert P.column_stats(P.read_footer(path), 0, "x") == (st.min, st.max)


def test_statistics_read_as_pyarrow_s(tmp_path):
    tbl = pa.table({
        "i": pa.array(np.arange(50) * 7 % 31),
        "f": pa.array(np.linspace(-1, 1, 50)),
        "s": pa.array([f"a{i}" for i in range(50)]),
        "d": pa.array([pydt.date(2000, 1, 1 + i % 28) for i in range(50)]),
        "t": pa.array([i * 10 ** 6 for i in range(50)],
                      pa.timestamp("us", tz="UTC")),
        "b": pa.array([i % 2 == 0 for i in range(50)])})
    path = str(tmp_path / "s.parquet")
    pq.write_table(tbl, path, row_group_size=10)
    footer, pf = P.read_footer(path), pq.ParquetFile(path)
    for rg in range(5):
        for i, name in enumerate(tbl.column_names):
            st = pf.metadata.row_group(rg).column(i).statistics
            assert P.column_stats(footer, rg, name) == (st.min, st.max)


# ---------------------------------------------------------------------------
# the writer: files pyarrow reads as the reference writer's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("compression",
                         ["zstd", "snappy", "gzip", "none"])
def test_port_files_read_by_pyarrow_as_the_reference_writer_s(
        flat_table, tmp_path, compression):
    src = str(tmp_path / "src.parquet")
    pq.write_table(flat_table, src)
    jout, pout = str(tmp_path / "j"), str(tmp_path / "p")
    JSession(JCPU).read_parquet(src).write_parquet(
        jout, compression=compression, row_group_rows=900)
    _session().read_parquet(src).write_parquet(
        pout, compression=compression, row_group_rows=900)
    j = pq.read_table(jout + "/part-00000.parquet")
    p = pq.read_table(pout + "/part-00000.parquet")
    assert p.schema.remove_metadata() == j.schema.remove_metadata()
    assert p.to_pydict() == j.to_pydict()
    meta = pq.ParquetFile(pout + "/part-00000.parquet").metadata
    assert meta.num_row_groups == 3
    codec = meta.row_group(0).column(0).compression
    assert codec == compression.upper().replace("NONE", "UNCOMPRESSED")
    # and the port reads its own file back
    _same(P.read_table(pout + "/part-00000.parquet"), j)


def test_writer_statistics_prune_as_pyarrow_s(tmp_path):
    tbl = pa.table({"a": pa.array(np.arange(4000), pa.int64()),
                    "s": pa.array([f"k{i // 1000}" for i in range(4000)]),
                    "f": pa.array(np.where(np.arange(4000) % 7 == 0, np.nan,
                                           np.arange(4000) / 3.0))})
    port, ref = str(tmp_path / "p.parquet"), str(tmp_path / "r.parquet")
    P.write_table(from_arrow(tbl), port, row_group_rows=1000)
    pq.write_table(tbl, ref, row_group_size=1000)
    for terms in ([("a", ">=", 2500)], [("s", "=", "k2")],
                  [("f", "<", 10.0)], [("a", "<", 10), ("s", "=", "k3")],
                  [("a", "=", pydt.date(2000, 1, 1))]):
        want = [rg for _p, rg in JP._scan_units([ref], terms)]
        assert [rg for _p, rg in P._scan_units([port], terms)] == want
        assert [rg for _p, rg in JP._scan_units([port], terms)] == want


def test_a_large_dictionary_is_written_plain(tmp_path):
    vals = [f"{i:08d}-" + "x" * 40 for i in range(30_000)]
    hb = from_arrow(pa.table({"s": pa.array(vals)}))
    path = str(tmp_path / "big.parquet")
    P.write_table(hb, path)
    encs = pq.ParquetFile(path).metadata.row_group(0).column(0).encodings
    assert not any("DICTIONARY" in e for e in encs)
    assert pq.read_table(path).column("s").to_pylist() == vals


def test_pruned_units_equal_the_reference_s(pq_files):
    for terms in ([("a", ">=", 2500)], [("a", "<", 0)],
                  [("b", ">", 99.9)], [("s", "=", "g3")],
                  [("a", "=", 1999), ("b", "<=", 50.0)],
                  [("a", ">", "x")]):
        assert P._scan_units(pq_files, terms) == \
            JP._scan_units(pq_files, terms)


def test_auto_merges_the_row_groups_of_one_file(pq_files):
    """AUTO merges a file's row groups up to the batch target, each batch
    keeping its one file's provenance; MULTITHREADED yields each row
    group, as the reference's AUTO does."""
    from spark_rapids_tpu_torch.config import TpuConf

    def batches(strategy):
        conf = TpuConf({"spark.rapids.tpu.sql.format.parquet.reader.type":
                        strategy, "spark.rapids.tpu.sql.batchSizeRows": 500})
        return [(hb.num_rows, origin) for hb, origin in
                P.host_batch_stream_with_origin(pq_files, None, conf)]
    assert batches("AUTO") == [(500, p) for p in pq_files for _ in "ab"]
    assert batches("MULTITHREADED") == [(250, p) for p in pq_files
                                        for _ in "abcd"]


def test_a_pushed_filter_stays_with_its_query(pq_files):
    """A filtered query, then unfiltered ones, over one read_parquet
    DataFrame: the later ones read every row, whole and pruned to a
    column (the reference pushes the filter into the DataFrame's own
    scan, and its next query prunes by it: ROADMAP Queue 3 item 21)."""
    for conf in ({}, JCPU):
        df = _session(conf).read_parquet(*pq_files)
        assert df.filter(E.LessThan(col("a"), lit(5))).collect() \
            .num_rows == 5
        assert df.collect().num_rows == 3000
        assert df.filter(E.LessThan(col("a"), lit(5))).select(
            col("b"), names=["b"]).collect().num_rows == 5
        assert df.select(col("b"), names=["b"]).collect().num_rows == 3000
        assert df._plan.pushed_filter is None
    ref = JSession(JCPU).read_parquet(*pq_files)
    assert ref.filter(jcol("a") < JE.Literal(5)).collect().num_rows == 5
    assert ref.collect().num_rows == 250


def test_date_and_timestamp_terms_prune(tmp_path):
    """DATE and TIMESTAMP literals are their lanes' integers (days,
    microseconds): the port reads the footer's bounds as those integers,
    a nanosecond maximum rounded up, and prunes.  The reference compares
    them with pyarrow's date and datetime statistics, which raises
    TypeError, and keeps every row group (ROADMAP Queue 3 item 22)."""
    from spark_rapids_tpu_torch import types as T
    n, sec = 1000, 10 ** 6
    path = str(tmp_path / "dt.parquet")
    pq.write_table(pa.table({
        "d": pa.array([pydt.date(2000, 1, 1) + pydt.timedelta(days=i)
                       for i in range(n)], pa.date32()),
        "ms": pa.array(np.arange(n) * 1000, pa.timestamp("ms")),
        "us": pa.array(np.arange(n) * sec, pa.timestamp("us", tz="UTC")),
        "ns": pa.array(np.arange(n) * 10 ** 9 + 1, pa.timestamp("ns"))}),
        path, row_group_size=250)
    day0 = (pydt.date(2000, 1, 1) - pydt.date(1970, 1, 1)).days
    for term, kept in {("d", "<", day0 + 250): [0],
                       ("d", ">=", day0 + 750): [3],
                       ("d", "=", day0 + 500): [2],
                       ("ms", ">", 749 * sec): [3],
                       ("us", "<=", 250 * sec): [0, 1],
                       ("ns", ">", 999 * sec): [3],
                       ("d", "<", pydt.date(2000, 9, 7)): [0]}.items():
        assert [rg for _p, rg in P._scan_units([path], [term])] == kept
    for term in (("d", "<", day0 + 250), ("ms", ">", 749 * sec)):
        assert len(JP._scan_units([path], [term])) == 4
    df = _session().read_parquet(path).filter(
        E.LessThan(col("d"), E.Literal(day0 + 250, T.DATE)))
    q = df.physical()
    ctx = ExecContext(q.conf, q.device)
    assert q.collect(ctx).num_rows == 250
    assert ctx.metrics["scanned_rows"] == 250


def test_bucket_by_writes_the_reference_s_buckets(pq_files, tmp_path):
    pout, jout = str(tmp_path / "pb"), str(tmp_path / "jb")
    _session().read_parquet(*pq_files).write_parquet(
        pout, bucket_by=(["a", "s"], 5))
    JSession(JCPU).read_parquet(*pq_files).write_parquet(
        jout, bucket_by=(["a", "s"], 5))
    assert sorted(os.listdir(pout)) == sorted(os.listdir(jout))
    for f in os.listdir(jout):
        a = pq.read_table(os.path.join(pout, f)).sort_by("a")
        b = pq.read_table(os.path.join(jout, f)).sort_by("a")
        assert a.to_pydict() == b.to_pydict()


def test_input_file_name_reads_each_file(pq_files):
    from spark_rapids_tpu_torch.plan.misc import InputFileName
    for conf in ({}, {"spark.rapids.tpu.sql.enabled": "false"},
                 {"spark.rapids.tpu.sql.format.parquet.reader.type":
                  "COALESCING"}):
        s = _session(conf)
        out = s.read_parquet(*pq_files).select(
            InputFileName(), col("a"), names=["f", "a"]) \
            .group_by("f").agg((Count(None), "c")).collect().to_pydict()
        assert sorted(zip(out["f"], out["c"])) == [(p, 1000)
                                                   for p in pq_files]


# ---------------------------------------------------------------------------
# TPC-H from Parquet files
# ---------------------------------------------------------------------------

_QUERY_COLUMNS = {
    "lineitem": ["l_orderkey", "l_quantity", "l_extendedprice",
                 "l_discount", "l_tax", "l_returnflag", "l_linestatus",
                 "l_shipdate"],
    "orders": ["o_orderkey", "o_custkey", "o_orderdate", "o_shippriority"],
    "customer": ["c_custkey", "c_mktsegment"]}


class _FileSession:
    """A session whose `from_host` / `from_arrow` of a TPC-H table reads
    that table's Parquet files instead (the queries stay as written)."""

    def __init__(self, real, tables, files):
        self._real = real
        self._files = {id(tables[k]): v for k, v in files.items()}

    def from_host(self, table):
        return self._real.read_parquet(*self._files[id(table)])

    from_arrow = from_host

    def __getattr__(self, name):
        return getattr(self._real, name)


def _close(a: dict, b: dict):
    assert a.keys() == b.keys()
    for k in a:
        for x, y in zip(a[k], b[k], strict=True):
            if isinstance(x, float):
                assert x == pytest.approx(y, rel=1e-12)
            else:
                assert x == y, k


@pytest.mark.parametrize("query", ["q1", "q3", "q6"])
def test_tpch_from_the_port_s_files_equals_the_reference(tmp_path, query):
    ptables = PTPCH.gen_tables(0.001)
    jtables = JTPCH.gen_tables(0.001)
    pfiles, jfiles = {}, {}
    for name, cols in _QUERY_COLUMNS.items():
        p = str(tmp_path / f"p_{name}.parquet")
        P.write_table(ptables[name].select(cols), p, row_group_rows=2000)
        pfiles[name] = [p]
        j = str(tmp_path / f"j_{name}.parquet")
        pq.write_table(jtables[name].select(cols), j, row_group_size=2000)
        jfiles[name] = [j]
    got = getattr(PTPCH, query)(_FileSession(
        _session(), ptables, pfiles), ptables).collect().to_pydict()
    want = getattr(JTPCH, query)(_FileSession(
        JSession(JCPU), jtables, jfiles), jtables).collect().to_pydict()
    _close(got, want)
    assert got[list(got)[0]]
    # and equal to the port's in-memory run
    _close(got, getattr(PTPCH, query)(_session(), ptables)
           .collect().to_pydict())


# ---------------------------------------------------------------------------
# refusals
# ---------------------------------------------------------------------------

def test_nested_columns_name_item_8b(tmp_path):
    path = str(tmp_path / "n.parquet")
    pq.write_table(pa.table({"l": pa.array([[1, 2], None]), "a": [1, 2]}),
                   path)
    with pytest.raises(NotImplementedError, match="item 8b"):
        P.read_table(path)
    with pytest.raises(NotImplementedError, match="item 8b"):
        _session().read_parquet(path).schema
    assert P.read_table(path, ["a"]).to_pydict() == {"a": [1, 2]}


@pytest.mark.parametrize("codec", ["LZ4", "BROTLI"])
def test_unported_codecs_name_themselves(tmp_path, codec):
    path = str(tmp_path / "c.parquet")
    pq.write_table(pa.table({"a": [1, 2]}), path, compression=codec)
    with pytest.raises(NotImplementedError, match="codec"):
        P.read_table(path)


def test_legacy_bit_packed_levels_are_refused(tmp_path, monkeypatch):
    path = str(tmp_path / "bp.parquet")
    monkeypatch.setattr(P, "RLE", P.BIT_PACKED)   # the header's level enc
    P.write_table(from_arrow(pa.table({"a": pa.array([1, None, 3])})), path)
    monkeypatch.undo()
    with pytest.raises(NotImplementedError, match="BIT_PACKED"):
        P.read_table(path)


def test_read_orc_names_item_8c():
    with pytest.raises(NotImplementedError, match="item 8c"):
        _session().read_orc("x.orc")


def test_input_file_name_after_a_file_scan_is_empty_for_memory_sources(
        pq_files):
    # a query over no file gives "" even right after a file scan in the
    # same thread set the CPU engine's current file
    from spark_rapids_tpu_torch.plan.misc import InputFileName
    for conf in ({"spark.rapids.tpu.sql.enabled": "false"}, {}):
        s = _session(conf)
        s.read_parquet(pq_files[0]).collect()
        got = s.from_pydict({"a": [1, 2]}).select(
            InputFileName(), names=["f"]).collect().to_pydict()
        assert got == {"f": ["", ""]}
