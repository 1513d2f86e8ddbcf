"""The port's Iceberg read path (spark_rapids_tpu_torch/io/iceberg.py):
port copies of tests/test_iceberg.py.  The fixture writes a spec-shaped
v2 table with the port's own writers (Parquet data and delete files,
Avro manifest list and manifests); the reference's `read_iceberg` reads
the same table to the same rows.
"""
import json
import os

import pyarrow as pa
import pytest
import torch

from spark_rapids_tpu.io.iceberg import read_iceberg as jread_iceberg
from spark_rapids_tpu_torch.columnar.host import from_arrow
from spark_rapids_tpu_torch.io.avro import write_avro_records
from spark_rapids_tpu_torch.io.iceberg import read_iceberg, resolve_snapshot
from spark_rapids_tpu_torch.io.parquet import write_table
from spark_rapids_tpu_torch.plan.aggregates import Count, Sum
from spark_rapids_tpu_torch.session import TpuSession, col

torch.set_num_threads(1)


def _write(tbl: pa.Table, path: str) -> None:
    write_table(from_arrow(tbl), path)


DATA_FILE_SCHEMA = {
    "type": "record", "name": "r2", "fields": [
        {"name": "content", "type": "int"},
        {"name": "file_path", "type": "string"},
        {"name": "file_format", "type": "string"},
        {"name": "record_count", "type": "long"},
        {"name": "file_size_in_bytes", "type": "long"},
        {"name": "equality_ids",
         "type": ["null", {"type": "array", "items": "int"}]},
    ]}

MANIFEST_ENTRY_SCHEMA = {
    "type": "record", "name": "manifest_entry", "fields": [
        {"name": "status", "type": "int"},
        {"name": "snapshot_id", "type": ["null", "long"]},
        {"name": "data_file", "type": DATA_FILE_SCHEMA},
    ]}

MANIFEST_LIST_SCHEMA = {
    "type": "record", "name": "manifest_file", "fields": [
        {"name": "manifest_path", "type": "string"},
        {"name": "manifest_length", "type": "long"},
        {"name": "partition_spec_id", "type": "int"},
        {"name": "content", "type": "int"},
        {"name": "added_snapshot_id", "type": "long"},
    ]}

ICEBERG_SCHEMA = {
    "schema-id": 0, "type": "struct", "fields": [
        {"id": 1, "name": "id", "required": True, "type": "long"},
        {"id": 2, "name": "v", "required": False, "type": "double"},
        {"id": 3, "name": "cat", "required": False, "type": "string"},
    ]}


def _entry(path, content=0, nrec=0, eq_ids=None):
    return {"status": 1, "snapshot_id": 1, "data_file": {
        "content": content, "file_path": path, "file_format": "PARQUET",
        "record_count": nrec,
        "file_size_in_bytes": os.path.getsize(path),
        "equality_ids": eq_ids}}


def build_table(root, snapshots):
    """snapshots: list of (snapshot_id, entries) -> writes full layout."""
    meta_dir = os.path.join(root, "metadata")
    os.makedirs(meta_dir, exist_ok=True)
    snaps = []
    for sid, entries in snapshots:
        mpath = os.path.join(meta_dir, f"manifest-{sid}.avro")
        write_avro_records(MANIFEST_ENTRY_SCHEMA, entries, mpath)
        lpath = os.path.join(meta_dir, f"snap-{sid}.avro")
        write_avro_records(MANIFEST_LIST_SCHEMA, [{
            "manifest_path": mpath,
            "manifest_length": os.path.getsize(mpath),
            "partition_spec_id": 0, "content": 0,
            "added_snapshot_id": sid}], lpath)
        snaps.append({"snapshot-id": sid, "manifest-list": lpath,
                      "timestamp-ms": 1700000000000 + sid})
    meta = {"format-version": 2, "table-uuid": "0000", "location": root,
            "current-snapshot-id": snapshots[-1][0],
            "schemas": [ICEBERG_SCHEMA], "current-schema-id": 0,
            "snapshots": snaps}
    with open(os.path.join(meta_dir, "v1.metadata.json"), "w") as f:
        json.dump(meta, f)
    with open(os.path.join(meta_dir, "version-hint.text"), "w") as f:
        f.write("1")


@pytest.fixture()
def iceberg_table(tmp_path):
    root = str(tmp_path / "tbl")
    data_dir = os.path.join(root, "data")
    os.makedirs(data_dir)
    f1 = os.path.join(data_dir, "part-0.parquet")
    f2 = os.path.join(data_dir, "part-1.parquet")
    _write(pa.table({
        "id": pa.array(range(0, 50), pa.int64()),
        "v": pa.array([float(i) for i in range(50)]),
        "cat": pa.array(["a" if i % 2 else "b" for i in range(50)]),
    }), f1)
    _write(pa.table({
        "id": pa.array(range(50, 80), pa.int64()),
        "v": pa.array([float(i) * 2 for i in range(30)]),
        "cat": pa.array(["c"] * 30),
    }), f2)
    # position deletes: kill rows 0..4 of part-0
    pd = os.path.join(data_dir, "pos-del.parquet")
    _write(pa.table({
        "file_path": pa.array([f1] * 5),
        "pos": pa.array(range(5), pa.int64()),
    }), pd)
    # equality deletes on cat (field id 3): kill cat == 'c'
    ed = os.path.join(data_dir, "eq-del.parquet")
    _write(pa.table({"cat": pa.array(["c"])}), ed)

    build_table(root, [
        (1, [_entry(f1, 0, 50)]),
        (2, [_entry(f1, 0, 50), _entry(f2, 0, 30),
             _entry(pd, 1, 5), _entry(ed, 2, 1, eq_ids=[3])]),
    ])
    return root, f1, f2


def test_snapshot_resolution(iceberg_table):
    root, f1, f2 = iceberg_table
    snap = resolve_snapshot(root)
    assert snap.snapshot_id == 2
    assert sorted(snap.data_files) == sorted([f1, f2])
    assert len(snap.pos_delete_files) == 1
    assert snap.eq_deletes[0][1] == [3]


def test_read_with_deletes(iceberg_table):
    root, _, _ = iceberg_table
    t = read_iceberg(root)
    ids = t.column_by_name("id").to_pylist()
    # rows 0-4 position-deleted; 50-79 equality-deleted (cat == 'c')
    assert ids == list(range(5, 50))
    assert t.to_pydict() == jread_iceberg(root).to_pydict()


def test_time_travel(iceberg_table):
    root, _, _ = iceberg_table
    t1 = read_iceberg(root, snapshot_id=1)
    assert t1.column_by_name("id").to_pylist() == list(range(50))
    assert t1.to_pydict() == jread_iceberg(root, snapshot_id=1).to_pydict()
    with pytest.raises(ValueError):
        read_iceberg(root, snapshot_id=99)


def test_session_read_iceberg_device(iceberg_table):
    root, _, _ = iceberg_table
    s = TpuSession(device="cpu")
    df = (s.read_iceberg(root)
          .group_by("cat").agg((Sum(col("id")), "sid"), (Count(None), "n"))
          .sort("cat"))
    q = df.physical()
    assert q.kind == "device", q.explain()
    out = q.collect()
    got = dict(zip(out.column_by_name("cat").to_pylist(),
                   out.column_by_name("n").to_pylist()))
    # ids 5..49: odd ids are 'a' (23 rows of odd in 5..49), evens 'b'
    exp_a = sum(1 for i in range(5, 50) if i % 2)
    exp_b = sum(1 for i in range(5, 50) if not i % 2)
    assert got == {"a": exp_a, "b": exp_b}


def test_session_read_iceberg_time_travel(iceberg_table):
    root, _, _ = iceberg_table
    s = TpuSession(device="cpu")
    assert s.read_iceberg(root, snapshot_id=1).count() == 50
    assert s.read_iceberg(root).count() == 45


SEQ_ENTRY_SCHEMA = {
    "type": "record", "name": "manifest_entry", "fields": [
        {"name": "status", "type": "int"},
        {"name": "snapshot_id", "type": ["null", "long"]},
        {"name": "sequence_number", "type": ["null", "long"]},
        {"name": "data_file", "type": DATA_FILE_SCHEMA},
    ]}

SEQ_LIST_SCHEMA = {
    "type": "record", "name": "manifest_file", "fields": [
        {"name": "manifest_path", "type": "string"},
        {"name": "manifest_length", "type": "long"},
        {"name": "partition_spec_id", "type": "int"},
        {"name": "content", "type": "int"},
        {"name": "sequence_number", "type": "long"},
        {"name": "added_snapshot_id", "type": "long"},
    ]}


def test_equality_delete_sequence_scoping(tmp_path):
    """Delete-then-reinsert: an equality delete (seq 2) must not drop rows
    from a data file added later (seq 3) — v2 spec strict-lower rule."""
    root = str(tmp_path / "tbl")
    data_dir = os.path.join(root, "data")
    meta_dir = os.path.join(root, "metadata")
    os.makedirs(data_dir)
    os.makedirs(meta_dir)

    f_old = os.path.join(data_dir, "old.parquet")
    _write(pa.table({"id": pa.array([1, 2], pa.int64()),
                             "v": pa.array([1.0, 2.0]),
                             "cat": pa.array(["c", "d"])}), f_old)
    ed = os.path.join(data_dir, "eq-del.parquet")
    _write(pa.table({"cat": pa.array(["c"])}), ed)
    f_new = os.path.join(data_dir, "new.parquet")  # re-insert of 'c'
    _write(pa.table({"id": pa.array([3], pa.int64()),
                             "v": pa.array([3.0]),
                             "cat": pa.array(["c"])}), f_new)

    def entry(path, content, seq, eq_ids=None):
        return {"status": 1, "snapshot_id": seq, "sequence_number": seq,
                "data_file": {
                    "content": content, "file_path": path,
                    "file_format": "PARQUET", "record_count": 1,
                    "file_size_in_bytes": os.path.getsize(path),
                    "equality_ids": eq_ids}}

    entries = [entry(f_old, 0, 1),
               entry(ed, 2, 2, eq_ids=[3]),
               entry(f_new, 0, 3)]
    mpath = os.path.join(meta_dir, "manifest-1.avro")
    write_avro_records(SEQ_ENTRY_SCHEMA, entries, mpath)
    lpath = os.path.join(meta_dir, "snap-1.avro")
    write_avro_records(SEQ_LIST_SCHEMA, [{
        "manifest_path": mpath, "manifest_length": os.path.getsize(mpath),
        "partition_spec_id": 0, "content": 0, "sequence_number": 3,
        "added_snapshot_id": 3}], lpath)
    meta = {"format-version": 2, "table-uuid": "0001", "location": root,
            "current-snapshot-id": 3,
            "schemas": [ICEBERG_SCHEMA], "current-schema-id": 0,
            "snapshots": [{"snapshot-id": 3, "manifest-list": lpath,
                           "timestamp-ms": 1700000000003}]}
    with open(os.path.join(meta_dir, "v1.metadata.json"), "w") as f:
        json.dump(meta, f)
    with open(os.path.join(meta_dir, "version-hint.text"), "w") as f:
        f.write("1")

    t = read_iceberg(root)
    # id=1 (cat 'c', seq 1 < delete seq 2) dropped; id=2 kept;
    # id=3 (re-inserted at seq 3, NOT < 2) must survive.
    assert sorted(t.column_by_name("id").to_pylist()) == [2, 3]
    assert sorted(jread_iceberg(root).column("id").to_pylist()) == [2, 3]


def test_iceberg_disabled_conf_falls_back(iceberg_table):
    root, _, _ = iceberg_table
    s = TpuSession({"spark.rapids.tpu.sql.format.iceberg.enabled": False},
                   device="cpu")
    df = s.read_iceberg(root)
    q = df.physical()
    assert "iceberg scan disabled" in q.explain()
    assert q.collect().num_rows == 45
