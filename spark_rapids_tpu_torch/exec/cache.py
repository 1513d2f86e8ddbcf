"""Cached-plan materialization — the ParquetCachedBatchSerializer role.

Counterpart of spark_rapids_tpu/exec/cache.py.  The reference stores a
cached DataFrame as zstd Parquet bytes written through pyarrow; the port
writes them with its own writer (io/parquet.py, Zstandard from
native/codecs.cpp) and decodes them a row group at a time.

The first materialization streams the child's host batches into an
in-memory Parquet buffer (one shot); replays decode from the buffer
through the standard host-to-device upload.  The logical node pins the
buffer on the LOGICAL plan object, so every physical re-plan of the same
DataFrame reuses it (Spark's cache is keyed by the logical plan too).
"""
from __future__ import annotations

import io as _io
from typing import Iterator, Optional

from ..columnar.host import HostBatch
from ..plan import logical as L
from .host_exec import HostNode

#: rows a row group of the cache buffer (each a unit `read_batches`
#: decodes)
CACHE_ROW_GROUP_ROWS = 1 << 20


class LogicalCache(L.LogicalPlan):
    """Caches the child's result on first materialization."""

    def __init__(self, child: L.LogicalPlan):
        super().__init__(child)
        self._buffer: Optional[bytes] = None
        self._raw_bytes = 0

    def _resolve_schema(self):
        return self.child.schema

    def materialized(self) -> bool:
        return self._buffer is not None

    def cached_bytes(self) -> int:
        return len(self._buffer) if self._buffer is not None else 0

    def raw_bytes(self) -> int:
        """The uncompressed bytes of the cached pages (the ratio's
        denominator)."""
        return self._raw_bytes

    def materialize(self, ctx) -> None:
        """Run the child as a query on `ctx`, the context of the query
        that reads the cache: it shares that query's device permit,
        memory budget and metrics (a query of its own would wait for a
        second permit while the reader holds one)."""
        if self._buffer is not None:
            return
        from ..io.parquet import ParquetFileWriter
        from ..plan.overrides import apply_overrides
        q = apply_overrides(self.child, ctx.conf, ctx.device)
        schema = self.schema
        sink = _io.BytesIO()
        writer = ParquetFileWriter(sink, schema, "zstd")
        try:
            for hb in q.execute_host_batches(ctx):
                if hb.num_rows:
                    writer.write_batch(hb.select(schema.names),
                                       CACHE_ROW_GROUP_ROWS)
        finally:
            writer.close()
        self._buffer = sink.getvalue()
        self._raw_bytes = writer.uncompressed_bytes

    def read_batches(self, batch_rows: int) -> Iterator[HostBatch]:
        assert self._buffer is not None, "cache not materialized"
        from ..io.parquet import read_buffer_row_groups
        for hb in read_buffer_row_groups(self._buffer):
            n = hb.num_rows
            for off in range(0, n, batch_rows):
                yield hb.slice(off, min(batch_rows, n - off)) \
                    if n > batch_rows else hb

    def describe(self):
        state = f"{self.cached_bytes()}B" if self.materialized() \
            else "cold"
        return f"Cache[{state}]"


class CachedHostScan(HostNode):
    """Host exec over a LogicalCache: materializes lazily at EXECUTE time
    (never during plan conversion — explain stays side-effect free) and
    STREAMS batches from the compressed buffer (peak memory = one decoded
    row group, which is the cache's whole point)."""

    def __init__(self, lc: LogicalCache, conf):
        super().__init__()
        self._lc = lc
        self._conf = conf

    @property
    def output_schema(self):
        return self._lc.schema

    def _execute(self, ctx) -> Iterator[HostBatch]:
        self._lc.materialize(ctx)
        yield from self._lc.read_batches(ctx.conf.batch_size_rows)

    def describe(self):
        return f"CachedHostScan[{self._lc.describe()}]"
