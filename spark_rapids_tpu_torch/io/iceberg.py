"""Iceberg read path: metadata.json -> manifest lists -> manifests ->
parquet data files, with v2 delete-file filtering.

Counterpart of spark_rapids_tpu/io/iceberg.py (the reference's iceberg
support, IcebergProviderImpl.scala role).  The metadata chain is JSON and
Avro (io/avro.py), the data and delete files Parquet through the port's
own reader (io/parquet.py); delete files apply on the host before the
upload: position deletes by row index, equality deletes as an anti-join
on the equality-id columns, scoped by Iceberg v2's sequence numbers
(`_delete_applies`).  Format versions 1 and 2, snapshot selection (time
travel by snapshot id), ADDED / EXISTING against DELETED manifest
entries.  Read path only, as the reference's.
"""
from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .. import types as t
from ..columnar.host import HostBatch, concat_host
from .avro import read_avro_rows
from .parquet import empty_batch, read_table
from .text import _TextLogicalScan


def _local(path: str) -> str:
    """Iceberg metadata stores absolute URIs; strip file:// for local."""
    if path.startswith("file://"):
        return path[len("file://"):]
    return path


class IcebergSnapshot:
    """Resolved file sets of one snapshot.

    ``seq_of`` maps every file path to its *data sequence number* (Iceberg
    v2 spec): inherited from the manifest-list entry when the manifest
    entry's own sequence_number is null and status is ADDED.  ``None``
    means the table carries no sequence metadata (v1 / legacy layouts).
    """

    def __init__(self, data_files: List[str],
                 pos_delete_files: List[str],
                 eq_deletes: List[Tuple[str, List[int]]],
                 schema: Optional[dict], snapshot_id: Optional[int],
                 seq_of: Optional[Dict[str, Optional[int]]] = None):
        self.data_files = data_files
        self.pos_delete_files = pos_delete_files
        self.eq_deletes = eq_deletes        # (path, equality_field_ids)
        self.schema = schema
        self.snapshot_id = snapshot_id
        self.seq_of = seq_of or {}


def load_table_metadata(table_path: str) -> dict:
    """Latest metadata json via version-hint.text or highest vN."""
    meta_dir = os.path.join(table_path, "metadata")
    hint = os.path.join(meta_dir, "version-hint.text")
    if os.path.exists(hint):
        with open(hint) as f:
            v = f.read().strip()
        cand = os.path.join(meta_dir, f"v{v}.metadata.json")
    else:
        versions = sorted(
            (f for f in os.listdir(meta_dir)
             if f.endswith(".metadata.json")),
            key=lambda n: int(n.split(".")[0].lstrip("v"))
            if n.split(".")[0].lstrip("v").isdigit() else -1)
        if not versions:
            raise FileNotFoundError(f"no metadata.json under {meta_dir}")
        cand = os.path.join(meta_dir, versions[-1])
    with open(cand) as f:
        return json.load(f)


def resolve_snapshot(table_path: str,
                     snapshot_id: Optional[int] = None) -> IcebergSnapshot:
    meta = load_table_metadata(table_path)
    snaps = meta.get("snapshots", [])
    sid = snapshot_id if snapshot_id is not None \
        else meta.get("current-snapshot-id")
    snap = next((s for s in snaps if s["snapshot-id"] == sid), None)
    if snap is None:
        if snapshot_id is not None:
            raise ValueError(f"snapshot {snapshot_id} not found")
        return IcebergSnapshot([], [], [], _current_schema(meta), None)

    data, pos_del, eq_del = [], [], []
    seq_of: Dict[str, Optional[int]] = {}
    _, manifests = read_avro_rows(_local(snap["manifest-list"]))
    for m in manifests:
        mpath = _local(m["manifest_path"])
        mseq = m.get("sequence_number")      # manifest's data sequence num
        # content: 0=data manifest, 1=delete manifest (v1 files omit it)
        _, entries = read_avro_rows(mpath)
        for e in entries:
            if e.get("status") == 2:               # DELETED entry
                continue
            df = e["data_file"]
            fpath = _local(df["file_path"])
            # v2 spec: null entry sequence_number on an ADDED entry
            # inherits the manifest's sequence number.
            eseq = e.get("sequence_number")
            if eseq is None and e.get("status") == 1:
                eseq = mseq
            seq_of[fpath] = eseq
            content = df.get("content", 0)
            if content == 0:
                data.append(fpath)
            elif content == 1:
                pos_del.append(fpath)
            elif content == 2:
                eq_ids = df.get("equality_ids") or []
                eq_del.append((fpath, list(eq_ids)))
    return IcebergSnapshot(data, pos_del, eq_del,
                           _current_schema(meta), sid, seq_of)


def _current_schema(meta: dict) -> Optional[dict]:
    sid = meta.get("current-schema-id")
    for sc in meta.get("schemas", []):
        if sc.get("schema-id") == sid:
            return sc
    return meta.get("schema")


def _field_names_by_id(schema: Optional[dict]) -> Dict[int, str]:
    if not schema:
        return {}
    return {f["id"]: f["name"] for f in schema.get("fields", [])}


def _delete_applies(data_seq: Optional[int], del_seq: Optional[int],
                    strict: bool) -> bool:
    """Iceberg v2 sequence-number scoping: an equality delete applies only
    to data files with *strictly lower* data sequence number; a position
    delete applies to files with lower-or-equal sequence number.  Tables
    without sequence metadata (v1/legacy) apply deletes everywhere."""
    if data_seq is None or del_seq is None:
        return True
    return data_seq < del_seq if strict else data_seq <= del_seq


def _iceberg_type(ty) -> t.DataType:
    """The port type of an Iceberg primitive type."""
    if isinstance(ty, str):
        simple = {"boolean": t.BOOLEAN, "int": t.INT, "long": t.LONG,
                  "float": t.FLOAT, "double": t.DOUBLE, "string": t.STRING,
                  "date": t.DATE, "timestamp": t.TIMESTAMP,
                  "timestamptz": t.TIMESTAMP}
        if ty in simple:
            return simple[ty]
        if ty.startswith("decimal("):
            p, s = ty[len("decimal("):-1].split(",")
            return t.DecimalType(int(p), int(s))
    raise TypeError(f"unsupported iceberg type {ty} in the port")


def _keep_rows(hb: HostBatch, keep: np.ndarray) -> HostBatch:
    from ..exec.host_exec import take_rows
    return take_rows(hb, np.flatnonzero(keep))


def _key_tuples(hb: HostBatch, cols: Sequence[str]) -> list:
    return list(zip(*[hb.column_by_name(c).to_pylist() for c in cols]))


def read_iceberg(table_path: str,
                 snapshot_id: Optional[int] = None) -> HostBatch:
    """Materialize a snapshot as one HostBatch, deletes applied."""
    snap = resolve_snapshot(table_path, snapshot_id)
    if not snap.data_files:
        fields = (snap.schema or {}).get("fields", [])
        return empty_batch(t.StructType([
            t.StructField(f["name"], _iceberg_type(f["type"]))
            for f in fields]))

    # position deletes: {data file path -> [(position, delete_seq)]}
    pos_by_file: Dict[str, list] = {}
    for pf in snap.pos_delete_files:
        d = read_table(pf)
        dseq = snap.seq_of.get(pf)
        for fp, pos in zip(d.column_by_name("file_path").to_pylist(),
                           d.column_by_name("pos").to_pylist()):
            pos_by_file.setdefault(_local(fp), []).append((pos, dseq))

    names = _field_names_by_id(snap.schema)
    eq_tables = [(read_table(p),
                  [names.get(i) for i in ids] if ids else None,
                  snap.seq_of.get(p))
                 for p, ids in snap.eq_deletes]

    parts = []
    for fpath in snap.data_files:
        hb = read_table(fpath)
        fseq = snap.seq_of.get(fpath)
        dead = [pos for pos, dseq in pos_by_file.get(fpath, ())
                if _delete_applies(fseq, dseq, strict=False)]
        if dead:
            keep = np.ones(hb.num_rows, bool)
            dead = np.asarray(dead, np.int64)
            keep[dead[(dead >= 0) & (dead < hb.num_rows)]] = False
            hb = _keep_rows(hb, keep)
        for dt, cols, dseq in eq_tables:
            if not _delete_applies(fseq, dseq, strict=True):
                continue
            key_cols = cols or dt.names
            key_cols = [c for c in key_cols if c in hb.names]
            if not key_cols:
                continue
            dead_keys = set(_key_tuples(dt, key_cols))
            keep = np.array([k not in dead_keys
                             for k in _key_tuples(hb, key_cols)], bool)
            hb = _keep_rows(hb, keep)
        parts.append(hb)
    return concat_host(parts)


# ---------------------------------------------------------------------------
# scan plumbing
# ---------------------------------------------------------------------------

def _read_iceberg_scan(path: str, schema, opts) -> HostBatch:
    hb = read_iceberg(path, (opts or {}).get("snapshot_id"))
    if schema is not None:
        hb = hb.select([n for n in schema.names if n in hb.names])
    return hb


class LogicalIcebergScan(_TextLogicalScan):
    """Iceberg snapshot scan (IcebergProviderImpl role). paths = one
    table root; opts: snapshot_id for time travel."""
    reader = staticmethod(_read_iceberg_scan)
    fmt = "iceberg"
