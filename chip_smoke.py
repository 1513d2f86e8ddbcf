"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py            # from the repository root, one card

Phases, in order; any failure exits non-zero and no phase catches its
own failure:

  1. device  — the card's name and power limit (nvidia-smi) and
               torch.cuda.get_device_name().
  2. build   — nvcc builds every kernel source (spark_rapids_tpu_torch/
               csrc/) for sm_90a, one process per source, all started
               together; prints the build seconds.
  3. data    — every TPC-H table at scale factor 10 from the port's
               gen_tables, and the independent numpy results of every
               query of phase 5, in forked processes, one a query (joins
               as indexes into the 0..n-1 primary keys, or argsort and
               searchsorted; exact int64 decimal sums; DOUBLE results
               by the engine's casts).  One
               cut, the reference generator's: partsupp has two
               suppliers a part (4,000,000 rows at SF10), half of the
               spec's four (8,000,000), so m2m's and outer's builds
               repeat each key twice, not four times.  No query runs
               below SF10 (CUT_SCALES is empty): the seven whose join
               builds exceed 2 x sql.batchSizeRows (q7, q8, q9, q12 and
               q21 on orders, q22 on o_custkey, q4 on its late lineitem)
               sub-partition those joins.  Prints the phase's seconds.
  4. kernels — each kernel against its plain PyTorch version on the
               card, at the shapes the main path gives it.  seg_sums /
               seg_reduce at TPC-H q1's (capacity 4,194,304, the q1 key
               domain, q1's integer lanes plus one f64 lane) over
               int32/int64/float64/int8 reduce lanes, plus edge cases
               (int64 wraparound, all-dead rows, ±0.0/±inf in one
               bucket); integers exactly, f64 sums to rtol 1e-12 (their
               order follows the grid and the rows).  Then four more
               bucket distributions, each held and timed: q1's real one
               (the first lineitem batch's packed l_returnflag,
               l_linestatus key under q1's filter), every live row in
               one bucket, domain 1024 (maxDomain's default) with q1's
               lanes, and the uniform one with its last 60 % of rows
               dead (a join's output batch past its pair total).
               Beside each event time (host work of the call included),
               the kernel's own device time from torch.profiler, and
               seg_reduce's device launches a call.
               compaction_order, build_table and probe_first at q3's
               second join: the first join's ~1.4M unique order keys
               tabled at capacity 4,194,304, probed by the first
               lineitem batch (4,194,304
               rows, the shipdate filter as its nulls), whose match mask
               is the compaction's keep; plus 0 %, 100 % and a
               non-power-of-two capacity for compaction and
               duplicate-heavy and ±2^63 keys for the table, and four
               more builds, each held and timed: q3's lane with 1 % of
               its rows valid, 2,000 valid rows of 2,097,152, one key
               on 10,000 rows and every row dead.  Those three must
               equal their plain versions exactly (the table in all 16
               bytes of every slot), and build_table must make 2 device
               launches a call at each timed build (profiler count).
               probe_first also at semi's shapes (partsupp's (part,
               supplier) pairs packed into one lane by the port's
               range_pack_spec and packed_lane, probed by the first
               lineitem batch, every row valid), with its validity
               misaligned by one row, every row or no row valid, and
               3,000,017 rows.
               probe_counts and expand_pairs at m2m's shapes: partsupp's
               part keys tabled at capacity 4,194,304 (two rows a key),
               probed by the first lineitem batch with the 1994 filter
               as its validity, and that batch's expansion; plus a key
               10,000 times in one build, a total of 0, all-dead probes,
               ±2^63 keys, a probe capacity of 3,000,017, a validity
               lane misaligned by one row and the batch with its first
               3,000,000 rows owning no pairs; exactly.  expand_pairs is
               timed at m2m's shapes, the key 10,000 times and the
               3,000,000 rows without pairs, probe_first at q3's and
               semi's.  build_table, probe_first, probe_counts and
               expand_pairs are also timed with the L2 flushed before
               each call (as the query's other work leaves it).
               compaction_order also at 1 %, 50 % and 99 % kept and on
               a mask misaligned by one row.  Times each kernel (event
               time, host work of the call included, and kernel-only
               device time from torch.profiler, every launch of the call
               summed), its plain version and the one-call PyTorch
               yardstick where one exists (index_add_ / scatter_reduce_
               / a stable argsort / a stable sort / searchsorted /
               repeat_interleave), which the port itself never calls;
               compaction_order at each of its masks.  compaction_order
               must make at most 2 device launches a call, and
               probe_first, probe_counts and expand_pairs 1 at each of
               their timed shapes (profiler count).
  5. path    — q1, q6, a MIN/MAX/FIRST/LAST group-by, q3 and the three
               join-path queries of tpch.JOIN_QUERIES (m2m, outer, semi),
               then TPC-H q4, q5, q7, q8, q10, q11, q12, q15, q17, q18
               and q19 (the reference's text), q18 again at TPC-H's
               validation bound 300 (`q18_300`: the reference's 7200
               keeps no order) and q11 at TPC-H's fraction 0.0001 / SF
               (`q11_spec`: the reference's 0.0001 keeps no part at
               SF10), and the strings and COUNT(DISTINCT) queries q2,
               q9, q13, q14, q16, q20, q21 and q22, with q20 also for
               UNITED STATES (`q20_us`: the reference's CANADA keeps no
               supplier at SF10; every query of this slice but q20 must
               return rows), through TpuSession() on cuda, each checked against
               its numpy result (exact int64 decimal sums via a stable
               argsort and np.add.reduceat, HALF_UP averages in Python
               ints; string predicates by np.char over the
               dictionaries, q22's prefixes by a '<U2' cast, distinct
               counts as the distinct values of the packed (order,
               supplier) or (group, supplier) lane; DOUBLE columns within rtol 1e-12,
               the README's f64 tolerance; q3's top 10 and q18's top 100
               compare the tied set on a tie at their last row; the
               join-path queries expand their pairs with argsort,
               searchsorted and repeat).  Launch counts are zeroed just
               before each query and read just after it; each query
               must have launched the kernels of its path
               (PATH_KERNELS), and each of the seven above must have
               sub-partitioned a join; each prints its sub-partitioned
               joins, their partition counts k and its bucket joins, and
               its out-of-core aggregations.  Then wall ms per
               query: one cold run, median of 3 warm; the peak device
               memory of every query; the host-to-device copy
               rate from pageable memory that the upload sees; the
               `dictionary` phase: the dictionary work of q9, q21 and
               q22, each held to numpy:
               p_name's and c_phone's byte tensors (host clock),
               Contains over p_name, Substring over c_phone and q21's
               distinct count over its lineitem (CUDA events); and a
               torch.profiler breakdown of one warm q1, q3, m2m, q5 and
               q18_300.
  6. ooc     — q4, q18 at the bound 300 and q21 at SF10 through
               TpuSession(OOC_CONF): a 1 GiB device budget and a 512 MiB
               host spill store, so the sub-partitioned joins' buckets
               and the adaptive join's stages spill to the host and on
               to disk, and q18's group-by runs out of core.  Each must
               equal its numpy result; over the three, batches must have
               spilled to the host and to disk, and q18 must have
               elected the out-of-core aggregation.  Prints each
               query's spill batches, bytes and ms beside its cold wall
               and its unbudgeted cold and warm walls from phase 5.
  7. tpcds   — the TPC-H tables are dropped first (host memory), then
               TPC-DS at SF10 from the port's tpcds.gen_tables (the
               reference generator's values: store_sales 28,804,040
               rows) and the independent numpy results of its 23
               queries and of phase 8, in forked processes, before this
               phase uses the card (chip_smoke_tpcds.py: dimension rows
               by surrogate key, lexsort groups, exact int64 decimal
               sums, rollup levels, ranks and window totals spelled
               out).  Each query (tpcds.QUERIES) runs through
               TpuSession() on cuda and must equal its numpy result
               (DOUBLE columns within rtol 1e-12; runs of tied sort keys
               as multisets) and launch the kernels of its path
               (PATH_KERNELS ds_*); q27, q36, q70 and q86 must run
               ExpandExec, q33, q56, q60 and q76 UnionExec, q12, q20,
               q36, q70, q86 and q98 WindowExec.  Prints each query's
               cold wall, median of 3 warm walls, peak device memory,
               operators and launches.
  8. window  — one WindowExec over all of store_sales, partitioned by
               ss_item_sk and ordered by ss_sold_date_sk (q47's and
               q51's shapes): row_number, rank, dense_rank,
               percent_rank, cume_dist, ntile(4), lead and lag with a
               default, first_value, last_value, count, the average
               over the whole partition, and ss_net_paid's sum running,
               over ROWS -3..3 and over RANGE 30 days preceding, its
               min and max over ROWS -3..3 and over that RANGE (a
               sparse table).  Held against numpy (a lexsort, then
               per-segment arithmetic; the RANGE bounds by searchsorted
               on the packed (item, date) key) and, over the first
               1,000,000 rows, against the port's own CPU path.  Prints
               the collect's cold wall, the operator's warm wall and the
               peak device memory.
  6b. scalars — after ooc, over the TPC-H tables (chip_smoke_scalars.py):
               the seven statistical aggregates over lineitem grouped by
               (l_returnflag, l_linestatus) (`moments_q1`: seg_sums), one
               projection of every new scalar family grouped into SUM,
               MIN and MAX (`scalars_q1`: seg_sums, seg_reduce),
               range(0, 100,000,000).sample(0.01, seed=7) grouped by
               id % 1000 and its count() (`range_sample`:
               compaction_order) and every new expression over NaN, ±inf,
               -0.0, nulls and Long.MIN_VALUE, fetched and compared
               elementwise (`edge_values`), each through TpuSession() on
               cuda and equal to numpy at chip_smoke_scalars' tolerances
               (exact families bit for bit, transcendental ones within 4
               ulps, DOUBLE sums and statistics within rtol 1e-9); the
               lineitem results come from the data phase's pool, the
               others from two threads beside the card's queries.
  6c. strings — after scalars, over the TPC-H tables
               (chip_smoke_strings.py): q2, q9, q13, q14, q16 and q20 with
               their string predicates as TPC-H's LIKE text (`like_q2` ...
               `like_q20`, q20 for UNITED STATES), each equal to phase 5's
               numpy result of its Contains / StartsWith form;
               `strings_groupby` (customer above the middle name ⋈
               orders, 1,500,000 ⋈ 15,000,000, grouped by
               lower(c_mktsegment) and the phone's country code cast to
               INT: 125 buckets, segagg; SUM, COUNT, MIN(length(upper)),
               MAX(instr) and SUM of a cast substring), equal to numpy
               (np.char over the dictionaries, exact int64 sums; from
               the data phase's pool); `string_dicts`: upper, lower and
               the trims over c_name's 1,500,000 and p_name's 2,000,000
               entries on the card, each equal to np.char's and timed
               with CUDA events, and lpad's host loop on the host clock;
               `string_edges`: every new string class and cast over
               4,194,304 rows of 65,536 edge entries, fetched and equal to
               the port's own CPU path value for value (column digests;
               the CPU path runs in a spawned process from the phase's
               start, beside the card's queries).  Each prints its
               cold wall, median of 3 warm walls (none for string_edges,
               whose host loops over its entries every run repeats),
               peak device memory and launches, and the phase its
               seconds.
  9. scalars dense — last: TPC-DS q7, q26, q56 and q60 at scale 0.1
               (i_item_id's 1,800 values) and store_sales ⋈ item grouped
               by (i_category, i_class, i_color) at SF10 (1,683 buckets),
               each equal to numpy and each running the dense group-by
               tier (exec/aggregate.GROUPBY_TIERS); its SF10 numpy result
               from the tpcds pool.  Both scalars phases print each
               query's cold wall, median of 3 warm walls (1 for
               edge_values), peak device memory and launches.
  9b. fallback — after scalars dense (chip_smoke_fallback.py): the 22
               TPC-H queries with sql.enabled=false at SF1 on the port's
               CPU engine (numpy, in a spawned process from the phase's
               start), each equal to the card's result of the query at
               SF1 (SF0.1 with the cut printed if the CPU part passes
               120 s), each printing the CPU engine's wall beside the
               card's warm wall; and three SF10 plans that mix the
               engines (fb_concat_groupby: a CPU projection uploaded into
               a card join and group-by; fb_q16_mix: a card join fetched
               into a CPU aggregate with COUNT(DISTINCT) beside SUM and a
               string MIN; fb_q3_format: q3 on the card under a CPU
               projection), each equal to numpy, with its placement held
               to the stated one from its explain lines and physical
               tree, and printing its cold wall, median of 3 warm walls,
               peak, launches, CPU operators' ms and each transition's
               bytes and ms.
  9c. decimals — the wide decimal lane, CpuWindowExec and the
               aggregate-twin CSE (chip_smoke_decimals.py): dec_ds_window
               (TPC-DS q98 with WinSum disabled, its window on the CPU
               engine) right after scalars dense, while the TPC-DS tables
               are loaded; after fallback, at SF10 on the TPC-H columns
               kept from the data phase: dec_q1 (q1's DECIMAL sums as two
               half lanes through seg_sums), dec_wrap (SUM and AVG of a
               DECIMAL(18,8) past 2^63, exact), dec_rank (a card
               aggregate ranked by CpuWindowExec on its decimal128 key)
               and cse_q15 (q15's shared view: its group-by calls halved
               against the plan with the sharing off).  Each equal to
               numpy, its placement held to the stated one, printing its
               cold wall, median of 3 warm walls, peak, launches, CPU
               operators' ms and transitions' bytes and ms.
  9d. chaos — last (chip_smoke_chaos.py), at SF10 on the TPC-H columns
               kept from the data phase: the recovery ladder.  q6 and q3
               under each recoverable fault (execute OOM, h2d and d2h IO
               errors, a reserve OOM) and MIN/MAX under a reserve OOM,
               each equal to its clean run and to numpy; q1's first
               segagg election and q3's first hash-table join election
               shed by `kernel:oom` onto the sorted group-by and the
               sorted join tier; q3, m2m, outer and semi with the join
               family off, then the compact family off, each equal to
               numpy, their warm walls beside the kernel path's; q18_300
               under the ooc phase's budget with an `ooc` OOM (equal to
               its clean run), a corrupt spill block (classified
               corruption) and an injected deadline (every reservation
               released); a real allocator OOM (the process capped
               between q18_300's measured in-core and out-of-core peaks,
               the budget the whole card), recovered by the query rung's
               out-of-core replay; q1 under an injected fatal error and
               a device-side assert in a spawned child, each leaving a
               dump classified fatal_device; two threads sharing one
               device permit.  Each case prints its wall and launches.
  9e. joins — after chaos (chip_smoke_joins.py), at SF10 on the TPC-H
               columns kept from the data phase: q3, q4, q19, q22, m2m,
               outer and semi under join.denseReplace AUTO and OFF, each
               equal to phase 5's numpy result beside phase 5's ON walls,
               with the tier counters (some join must run the dense tier
               under each); q3 and bloom_sel (lineitem ⋈ one month of
               orders) with the bloom runtime filter on and off
               (bloom_sel must filter rows); composite keys on the
               multi-lane sorted tier (ck_str2, ck_str_int, ck_wide, the
               last sub-partitioned); hash() and xxhash64() over every
               lineitem row, grouped and the first 1,000,000 fetched,
               against a numpy murmur3 and XXH64.  Each prints its cold
               wall, median of 3 warm walls, peak, launches and counters.
  9f. late — after joins (chip_smoke_late.py), at SF10 on the TPC-H
               columns kept from the data phase: q1, q6, q3, q5, q7, q9,
               q10, q18_300, m2m, outer, semi and bloom_sel under the
               defaults (selection vectors, thin join batches, encoded
               execution) and with those three keys off, each equal to
               numpy in both modes, printing its walls beside phase 5's,
               peak, launches, the late-materialization and encoded
               counters and its host-to-device bytes with the host
               narrowing ms, cold and warm.  A join-chain case must
               defer a gather, q1 must upload fewer bytes under the
               defaults, every off case must launch what the tree before
               these keys launched (chip_smoke_late.EXPECT_OFF), and
               compaction_order must launch inside lanes.compact_thin.
  9g. capture — after late (chip_smoke_capture.py), at SF10 on the same
               TPC-H columns; its TPC-DS part (ds_q3) right after the
               decimals' TPC-DS part: q1, q6, q3, m2m, q5, q18_300 and
               ds_q3 with `sql.compile.wholePlan` ON (whole-plan capture
               as CUDA graphs, exec/compiled.py) and OFF, each equal to
               numpy in both modes, printing the decision (whole, split
               and its segments, or the fallback and its error), the
               cold wall and the median of 3 warm walls (replays), peak,
               the graphs' capture ms and pool bytes, and the launches
               of a warm run counted from torch.profiler's kernel events
               (OFF's must equal its wrappers' counts; ON's, what the
               replays launched, must equal OFF's and hold PATH_KERNELS
               where OFF sub-partitioned no join); q1, q6,
               q3 and ds_q3 must capture.  Then the dispatch floor, q6
               with two literal sets sharing one graph, the device-busy
               share of q1 and q3 ON and OFF (torch.profiler), and
               compaction_order, build_table and probe_counts captured
               at the kernel phase's shapes and replayed 3 times with
               new inputs, each equal to its plain version.  The TPC-H
               part must finish within 150 s.
  9h. nested — after capture (chip_smoke_nested.py), at SF10 on the
               TPC-H columns it keeps from the data phase: ARRAY columns
               and the holistic aggregates.  pct_q1 (percentile and
               median over q1's groups, within 4 ulps of numpy's exact
               lerp), approx_q1 and approx_global (approx_percentile
               over every lineitem batch, the sketched path, each rank
               within two merge levels' error), collect_q3 (q3's join
               into collect_list / collect_set, then size, sort_array,
               element_at, array_max and array_contains), explode_q3 and
               posexplode_q3 (the sets exploded by GenerateExec and
               counted; explode_q3 again under wholePlan=ON, its
               decision printed, equal to eager) and collect_sf10
               (collect_list of l_partkey by l_suppkey over every
               lineitem row), each equal to numpy computed in the data
               phase's pool, printing its walls, peak, exec names,
               launches and ragged value-lane sizes.
  9i. structs — after nested (chip_smoke_structs.py), at SF10 on the
               TPC-H columns it keeps: STRUCT and MAP columns built with
               the numpy constructors and shattered into lanes, the
               regex automaton, the JSON and misc functions.  struct_q1
               (q1 over a STRUCT with null rows), struct_q3 (q3 joining
               on a struct field), struct_group (group-by and sort on a
               whole struct, over every lineitem row), map_sf10 (a MAP a
               order: element_at, size, map_keys on the device) and
               map_passthrough (1,000 maps re-nested), rlike_q9 and
               rlike_q13 (the DFA over p_name's and o_comment's
               dictionaries, the runner timed by CUDA events), json_supp
               and mono_id, each equal to numpy (or Python's json);
               struct_q1 and both map cases again under wholePlan=ON,
               each decision printed, equal to eager.
  9j. udf — after structs (chip_smoke_udf.py), at SF10 on the TPC-H
               columns it keeps: udf_q1 (q1's disc_price and charge
               compiled from Python lambdas: q1's trees, q1's answer and
               the launches of q1 in phase 5, q1's wholePlan=ON
               decision), tpuudf_q3 and hive_q3 (q3's filters and DOUBLE
               revenue as TpuUDFs over torch tensors, the revenue as a
               TpuHiveUDF: the launches of q3 in phase 5, within 1e-12 of
               the exact revenue, captured under ON), hive_supp (a
               row-based hive UDF over
               s_name as a CPU island feeding a device join into
               lineitem's aggregation, its host ms and transition
               bytes), pyudf_part (udf() falling back to PythonUDF over
               p_name, then a device SUM / MAX group-by), worker_wire
               (orders' four lanes through a forked worker over the
               numpy wire and back unchanged, after the card's work,
               no launch), and, where pandas imports, the six pandas
               execs each followed by a device group-by, the orders
               cases over a quarter of orders ("pandas: absent"
               otherwise), each equal to numpy or plain Python.
Each phase after the data prints its seconds.
  10. result — a `kernels` JSON line (launches by query over every
               query of phases 5, 6b, 6c, 7, 9, 9b, 9c, 9d, 9e, 9f, 9g,
               9h, 9i and 9j), the whole run's
               seconds, the nvidia-smi line, and last {"ok": true,
               "device": {...}}.

Flags: --scale (default 10), --seed (default 20240706), --kernels-only
(phases 1-4 only, then the kernels line and the nvidia-smi line without
the result line: copied to the root of another tree of the port, it
times that tree's kernels the same way, for an A B B A comparison in
one call), --walls q1,q3,q6 (phases 1-3 without the numpy results, then
each named query's cold wall and the median of 5 warm walls as a
`{"walls": ...}` JSON line and the nvidia-smi line, without the result
line: the same A B B A for query walls).
"""
from __future__ import annotations

import argparse
import collections
import concurrent.futures
import datetime as pydt
import gc
import json
import multiprocessing
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12          # H100 SXM HBM3 (NVIDIA data sheet)
# H100 SXM, 67 TFLOP/s outside the tensor cores (NVIDIA data sheet): the
# rate charged for the kernels' scalar adds and compares
SCALAR_OPS_PER_S = 67e12
Q1_CAPACITY = 1 << 22              # sql.batchSizeRows: q1's batch bucket
TPU_KERNELS = {
    "seg_sums": "spark_rapids_tpu/ops/pallas/segagg.py:57",
    "seg_reduce": "spark_rapids_tpu/ops/pallas/segagg.py:123",
    "compaction_order": "spark_rapids_tpu/ops/pallas/compact.py:53",
    "build_table": "spark_rapids_tpu/ops/pallas/hashjoin.py:111",
    "probe_first": "spark_rapids_tpu/ops/pallas/hashjoin.py:182",
    "probe_counts": "spark_rapids_tpu/ops/pallas/hashjoin.py:253",
    "expand_pairs": "spark_rapids_tpu/ops/pallas/hashjoin.py:324"}
SOURCES = {"seg_sums": "spark_rapids_tpu_torch/csrc/segagg.cu",
           "seg_reduce": "spark_rapids_tpu_torch/csrc/segagg.cu",
           "compaction_order": "spark_rapids_tpu_torch/csrc/compact.cu",
           "build_table": "spark_rapids_tpu_torch/csrc/hashjoin.cu",
           "probe_first": "spark_rapids_tpu_torch/csrc/hashjoin.cu",
           "probe_counts": "spark_rapids_tpu_torch/csrc/hashjoin.cu",
           "expand_pairs": "spark_rapids_tpu_torch/csrc/hashjoin.cu"}
# the kernels each query of the main path must launch: q1 groups by a
# packed dictionary domain (seg_sums), q6 is a global reduction that
# reaches no kernel, the MIN/MAX/FIRST/LAST group-by needs both segagg
# kernels, q3's two joins (a semi join and a unique-build inner join)
# table, probe and compact, m2m and outer run the counted probe and the
# pair expansion over a build with repeated keys (m2m then groups by a
# 7-value ship mode), and semi probes for the matched flag only.  Every
# join of the eleven later queries has a unique build side (probe_first);
# q4 (5 priorities), q5 (25 nations) and q12 (7 ship modes) group by a
# dictionary domain (seg_sums), the others by a computed Year or by a
# key whose range is over segagg.maxDomain (the sorted group-by).  The
# strings and COUNT(DISTINCT) queries have unique builds too.  q18's
# HAVING at 7200 keeps no order: its group-by runs out of core, its
# adaptive join then builds on orders, sub-partitioned, and probes with
# no row, so no table is built (the hash table is built at the first
# probe) and only the scatter's compactions launch.  q22 groups
# by its 25 phone prefixes (seg_sums), q21 by a 100,000-name dictionary
# (sorted: over denseDomainMax).
# Under the defaults (`join.lazySelection`, `join.lateMaterialization`) a
# join whose parent is an aggregation or another join's probe side emits
# a selection vector instead of compacting, and a thin join's output
# compacts only at its sink (columnar/lanes.compact_thin).  A query then
# compacts where a join feeds another join's build side (concat), a sort,
# a top-N or the result, where the sub-partition join scatters, and
# where a semi or outer join's unmatched rows come out.  The entries that
# lost compaction_order (their joins all feed aggregations or probes,
# and at TPC-H 0.001 none sub-partitions): m2m (its expanded pairs reach
# the aggregation as a selection), q4, q7, q9, q12 (they compact at SF10
# only in the sub-partition scatter), q14, q17, q19 (JOIN_AGG)
UNIQUE_JOIN = ("build_table", "probe_first", "compaction_order")
JOIN_AGG = ("build_table", "probe_first")
PATH_KERNELS = {"q1": ("seg_sums",), "q6": (),
                "minmax": ("seg_sums", "seg_reduce"),
                "q3": UNIQUE_JOIN,
                "m2m": ("build_table", "probe_counts", "expand_pairs",
                        "seg_sums"),
                "outer": ("build_table", "probe_counts", "expand_pairs",
                          "compaction_order"),
                "semi": UNIQUE_JOIN,
                "q4": JOIN_AGG + ("seg_sums",),
                "q5": UNIQUE_JOIN + ("seg_sums",),
                "q7": JOIN_AGG, "q8": UNIQUE_JOIN, "q10": UNIQUE_JOIN,
                "q11": UNIQUE_JOIN,
                "q12": JOIN_AGG + ("seg_sums",),
                "q15": UNIQUE_JOIN,
                "q17": JOIN_AGG, "q18": ("compaction_order",),
                "q18_300": UNIQUE_JOIN, "q19": JOIN_AGG,
                "q11_spec": UNIQUE_JOIN,
                "q2": UNIQUE_JOIN, "q9": JOIN_AGG, "q13": UNIQUE_JOIN,
                "q14": JOIN_AGG, "q16": UNIQUE_JOIN, "q20": UNIQUE_JOIN,
                "q20_us": UNIQUE_JOIN,
                "q21": UNIQUE_JOIN, "q21_vn": UNIQUE_JOIN,
                "q22": UNIQUE_JOIN + ("seg_sums",)}
# TPC-DS (tpcds.QUERIES at SF10): every query joins unique dimension
# builds; q33 (i_manufact_id, 1,000 values), q43 (store name x id,
# 847 slots), q65 (its per-store average, 120 stores) and q70 (its
# per-state sums, 8 states) group by domains the segmented-aggregation
# gate takes (maxDomain 1,024).  The others' keys are over it at SF10
# (i_item_id: 180,000 values) or carry the grouping id, whose range no
# scan bounds
DS_SEGAGG = ("q33", "q43", "q65", "q70")
DS_QUERIES = ("q3", "q7", "q12", "q19", "q20", "q26", "q27", "q33", "q36",
              "q42", "q43", "q52", "q55", "q56", "q60", "q65", "q70", "q73",
              "q76", "q86", "q93", "q96", "q98")
# the star joins whose every join feeds an aggregation or another join's
# probe side: no compaction under the defaults (TPC-DS 0.0005 and 0.01)
DS_JOIN_AGG = ("q3", "q7", "q12", "q19", "q20", "q26", "q42", "q43", "q52",
               "q55", "q96", "q98")
PATH_KERNELS.update({f"ds_{q}": (JOIN_AGG if q in DS_JOIN_AGG
                                 else UNIQUE_JOIN) + (
    ("seg_sums",) if q in DS_SEGAGG else ()) for q in DS_QUERIES})
# the scalars phase: the statistical aggregates and the scalar families
# group lineitem by a 12-bucket dictionary domain (segagg: seg_sums, and
# seg_reduce for scalars_q1's MIN/MAX), the sample compacts its kept
# rows, edge_values only projects, and the dense-tier queries join
# unique dimension builds before their 1,683- to 1,801-bucket group-bys
DENSE_QUERIES = ("q7", "q26", "q56", "q60")
DENSE_SCALE = 0.1
PATH_KERNELS.update({"moments_q1": ("seg_sums",),
                     "scalars_q1": ("seg_sums", "seg_reduce"),
                     "range_sample": ("compaction_order",),
                     "edge_values": (), "dense_sf10": JOIN_AGG,
                     # q7's and q26's joins all feed their aggregations
                     **{f"dense_{q}": JOIN_AGG if q in ("q7", "q26")
                        else UNIQUE_JOIN for q in DENSE_QUERIES}})
# the strings phase: the LIKE forms run their queries' joins;
# strings_groupby filters customer, joins it and groups by a 5 x 25
# domain into SUM / COUNT (seg_sums) and MIN / MAX (seg_reduce); the
# dictionary transforms and the edge projection reach no kernel
# (like_q9 and like_q14 as q9 and q14; strings_groupby's join feeds its
# aggregation: no compaction under the defaults)
PATH_KERNELS.update({**{f"like_{q}": JOIN_AGG if q in ("q9", "q14")
                        else UNIQUE_JOIN for q in (
    "q2", "q9", "q13", "q14", "q16", "q20")},
    "strings_groupby": JOIN_AGG + ("seg_sums", "seg_reduce"),
    "string_dicts": (), "string_edges": ()})
# the fallback phase: fb_concat_groupby joins orders with the uploaded
# customer projection (unique c_custkey) and groups by its 125-value
# string on the card (SUM, COUNT: seg_sums; MIN, MAX: seg_reduce);
# fb_q16_mix and fb_q3_format run q16's and q3's joins on the card (the
# group-by's join emits a selection vector under the defaults)
PATH_KERNELS.update({"fb_concat_groupby": JOIN_AGG + ("seg_sums",
                                                      "seg_reduce"),
                     "fb_q16_mix": UNIQUE_JOIN, "fb_q3_format": UNIQUE_JOIN})
# the decimals phase: dec_q1 and dec_wrap group by q1's 12-bucket
# dictionary domain into two half lanes a DECIMAL sum (seg_sums);
# dec_rank's 100,000 suppliers take the sorted group-by and its window
# the CPU engine (no kernel); dec_ds_window runs q98's joins, cse_q15
# q15's
PATH_KERNELS.update({"dec_q1": ("seg_sums",), "dec_wrap": ("seg_sums",),
                     "dec_rank": (), "dec_ds_window": UNIQUE_JOIN,
                     "cse_q15": UNIQUE_JOIN})
# the joins phase: the dense cases' tiers vary by mode, so compaction is
# what each must launch, but q19's and m2m's joins feed aggregations
# (no compaction under the defaults); bloom_q3 runs q3's path, and
# bloom_sel's sub-partitioned buckets table the unique orders keys;
# ck_str2 and ck_str_int group by 15- and 49-bucket domains (seg_sums)
# around their multi-lane joins; the hash cases group by q1's 6 buckets
PATH_KERNELS.update({
    **{f"dense_{q}_{m}": () if q in ("q19", "m2m") else (
        "compaction_order",) for q in (
        "q3", "q4", "q19", "q22", "m2m", "outer", "semi")
       for m in ("auto", "off")},
    **{f"bloom_{q}_{m}": UNIQUE_JOIN for q in ("q3", "sel")
       for m in ("on", "off")},
    "ck_str2": ("compaction_order", "seg_sums"),
    "ck_str_int": ("compaction_order", "seg_sums"),
    "ck_wide": ("compaction_order",),
    "hash_murmur3": ("seg_sums",), "hash_xxhash64": ("seg_sums",),
    **{f"tz_{z}": () for z in ("UTC", "America/Los_Angeles",
                               "Australia/Lord_Howe")}})
# the nested phase (chip_smoke_nested.py): pct_q1's filter compacts
# before its sort-segment percentiles; the approx cases and collect_sf10
# scan straight into their sorted aggregations (no kernel); collect_q3
# and the explodes run q3's joins (their output concatenates into the
# collect, which compacts it), and explode_q3 then counts by the 7 ship
# modes, a dictionary domain (seg_sums); posexplode_q3's pos has no
# bounded range (the sorted group-by)
PATH_KERNELS.update({"pct_q1": ("compaction_order",), "approx_q1": (),
                     "approx_global": (), "collect_q3": UNIQUE_JOIN,
                     "explode_q3": UNIQUE_JOIN + ("seg_sums",),
                     "posexplode_q3": UNIQUE_JOIN, "collect_sf10": ()})
# the structs phase (chip_smoke_structs.py): struct_q1 and struct_group
# aggregate over dictionary domains (seg_sums), struct_q3 is q3 over the
# shattered orders and rlike_q9 / rlike_q13 are q9 / q13 (their LIKE
# forms' kernels); map_sf10's filter feeds a global aggregation (a mask,
# no compaction), the passthrough, json_supp and mono_id only project
PATH_KERNELS.update({"struct_q1": ("seg_sums",), "struct_q3": UNIQUE_JOIN,
                     "struct_group": ("seg_sums",), "map_sf10": (),
                     "map_passthrough": (), "rlike_q9": JOIN_AGG,
                     "rlike_q13": UNIQUE_JOIN, "json_supp": (),
                     "mono_id": ()})
# the udf phase (chip_smoke_udf.py): udf_q1 is q1 (seg_sums), tpuudf_q3
# and hive_q3 run q3's joins; hive_supp's build side comes from a CPU
# island, whose keys no statistic proves unique (the counted probe and
# the pair expansion); pyudf_part's key comes from a CPU island too (no
# scan range: the sorted group-by); the wire and the pandas execs reach
# no kernel of their own
PATH_KERNELS.update({"udf_q1": ("seg_sums",), "tpuudf_q3": UNIQUE_JOIN,
                     "hive_q3": UNIQUE_JOIN,
                     "hive_supp": ("build_table", "probe_counts",
                                   "expand_pairs"),
                     "pyudf_part": (), "worker_wire": (),
                     **{n: () for n in (
                         "map_pd_orders", "scalar_pd_orders",
                         "apply_pd_priority", "agg_pd_nation",
                         "window_pd_supp", "cogroup_pd_nation")}})
Q3_DATE = (pydt.date(1995, 3, 15) - pydt.date(1970, 1, 1)).days
# the device launches of one build_layout call, by kernel name: this
# tree's two passes, and (for an A B B A against an older tree) its
# three passes and the fill of the slot buffer
BUILD_KERNELS = ("layout_final_kernel", "layout_slots_kernel",
                 "tile_max_kernel", "carry_kernel", "layout_kernel",
                 "FillFunctor<c10::complex<double>")


def log(msg: str) -> None:
    print(msg, flush=True)


def check(ok, msg: str) -> None:
    """Fail the run (exit code 1, message on stderr) unless `ok`."""
    if not ok:
        raise SystemExit(f"chip_smoke FAILED: {msg}")


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def bound(nbytes: int, ops: int):
    """(ms, "bytes" or "operations"): the larger of bytes over the HBM
    rate and operations over the scalar peak."""
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = ops / SCALAR_OPS_PER_S * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else \
        (by_ops, "operations")


_FLUSH = []


def flush_l2() -> None:
    """Evict the card's 50 MB L2 with one 256 MiB memset."""
    if not _FLUSH:
        _FLUSH.append(torch.empty(256 << 20, dtype=torch.uint8,
                                  device="cuda"))
    _FLUSH[0].zero_()


_WINDOW = "chip_smoke_counted_calls"
_PAD = 2


def _on_device(e) -> bool:
    from torch.autograd import DeviceType
    return e.device_type == DeviceType.CUDA


def _whole(records, calls: int) -> bool:
    """Every kernel's count of device records is a positive multiple of
    the calls: no record of the trace was lost (each call launches each
    of its kernels a whole number of times; a trace that lost half of
    every call's records can still hold a multiple of the calls in all:
    10 of build_table's 20 records once read as 1 launch a call)."""
    per = collections.Counter(e.name for e in records)
    return bool(per) and all(v % calls == 0 for v in per.values())


def profiled_ms(fn, fragment=None, reps: int = 10, by_name=None,
                cold: bool = False):
    """(device ms a call of the kernels whose names hold `fragment` (a
    string, or a tuple of which any one) -- of every device launch of
    the call when `fragment` is None --, device launches a call of every
    kind) over `reps` warm calls of `fn`, from torch.profiler; with
    `cold`, the L2 is flushed before each call (as a query's other work
    leaves it for the next batch; the flush is counted among the
    launches, not in the time of a named kernel).  `by_name`, a dict,
    receives the device ms a call of each kernel name.

    The profiler can drop a device record at either end of a trace, so
    the counted calls run in a marked window between _PAD calls before
    and after, each side set apart by a synchronize and a pause, and
    only the device records that start inside the window count.  Where
    the window's count of launches is not a positive multiple of the
    calls for some kernel (a record lost inside it: `_whole`), the trace
    is counted over all its calls if that count is whole, else taken
    again, up to five traces;
    fails the run if the profiler saw no launch of such a kernel."""
    from torch.profiler import ProfilerActivity, profile, record_function
    frags = (fragment,) if isinstance(fragment, str) else fragment
    fn()
    torch.cuda.synchronize()

    def calls(n):
        for _ in range(n):
            if cold:
                flush_l2()
            fn()
        torch.cuda.synchronize()

    for attempt in range(1, 6):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            calls(_PAD)
            time.sleep(0.002)
            with record_function(_WINDOW):
                calls(reps)
            time.sleep(0.002)
            calls(_PAD)
        events = list(prof.events())
        window = [e.time_range for e in events
                  if e.name == _WINDOW and not _on_device(e)]
        device = [e for e in events
                  if _on_device(e) and not e.is_user_annotation]
        counted = [e for e in device if window
                   and window[0].start <= e.time_range.start
                   <= window[0].end]
        n = reps
        if not _whole(counted, reps):
            counted, n = device, reps + 2 * _PAD
        if _whole(counted, n) or attempt == 5:
            break
        # every call makes a whole number of launches, so a count that
        # is not a multiple of the calls lost records
        log(f"[kernels] torch.profiler traced {len(device)} device "
            f"launches over {reps + 2 * _PAD} calls of "
            f"{fragment or 'a call'}; tracing it again")
    us, own = 0.0, 0
    for e in counted:
        if frags is None or any(f in e.name for f in frags):
            us += e.time_range.elapsed_us()
            own += 1
            if by_name is not None:
                key = e.name[:80]
                by_name[key] = by_name.get(key, 0.0) \
                    + e.time_range.elapsed_us() / 1e3 / n
    check(own > 0, f"torch.profiler saw no {fragment or 'device'} launch "
          "(no device activity traced)")
    return us / 1e3 / n, len(counted) / n


def cuda_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    """Median device ms of `fn` over `reps` runs, CUDA events each."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


# ---------------------------------------------------------------------------
# Phase 4: kernels against their plain versions
# ---------------------------------------------------------------------------

def q1_kernel_shape():
    """(domain, Ki) that q1's partial aggregation gives seg_sums: the
    packed domain of l_returnflag x l_linestatus (dictionary sizes 3 and
    2, plus a null slot each) and the integer lanes the glue queues."""
    from spark_rapids_tpu_torch import tpch
    from spark_rapids_tpu_torch.config import TpuConf
    from spark_rapids_tpu_torch.exec.aggregate import HashAggregate
    from spark_rapids_tpu_torch.ops import groupby as G
    from spark_rapids_tpu_torch.session import TpuSession
    tiny = tpch.gen_tables(0.0001, tables=("lineitem",))
    plan = tpch.q1(TpuSession(device="cpu"), tiny).physical().root.child
    agg = HashAggregate(plan.key_exprs, plan.key_names, plan.aggs,
                        TpuConf())
    lanes = {("all",)}                      # the bucket occupancy
    for si, s in enumerate(agg.update_specs):
        if s.kind in (G.COUNT, G.COUNT_ALL, G.SUM):
            lanes.add(G.sum_lane_key(s, si))
        if s.kind not in (G.COUNT, G.COUNT_ALL):
            lanes.add(("vc", s.input_idx))
    domain = (3 + 1) * (2 + 1)
    return domain, len(lanes)


def q1_buckets(li, cap: int, dev):
    """The bucket ids q1 gives seg_sums on the first lineitem batch: the
    packed (l_returnflag, l_linestatus) slot (0 = null, so a value's slot
    is its code + 1) where q1's shipdate filter holds, else the domain."""
    cutoff = _days(pydt.date(1998, 12, 1)) - 90
    rf = _col(li, "l_returnflag").data[:cap].astype(np.int32)
    ls = _col(li, "l_linestatus").data[:cap].astype(np.int32)
    seg = (rf + 1) * 3 + (ls + 1)
    seg[_col(li, "l_shipdate").data[:cap] > cutoff] = (3 + 1) * (2 + 1)
    return torch.from_numpy(np.ascontiguousarray(seg)).to(dev)


def kernels_phase(dev, tables):
    from spark_rapids_tpu_torch.ops.hopper import segagg as S
    cap = Q1_CAPACITY
    domain, ki = q1_kernel_shape()
    kf = 1
    g = torch.Generator(device=dev).manual_seed(7)
    seg = torch.randint(0, domain, (cap,), generator=g, device=dev,
                        dtype=torch.int32)
    dead = torch.rand(cap, generator=g, device=dev) < 0.02
    seg = torch.where(dead, torch.full_like(seg, domain), seg)
    ints = [torch.randint(0, 11_000_000_000, (cap,), generator=g,
                          device=dev, dtype=torch.int64) for _ in range(ki)]
    f64s = [torch.rand(cap, generator=g, device=dev, dtype=torch.float64)
            for _ in range(kf)]
    live_rows = int((~dead).sum())

    def check_sums(seg_, ints_, f64s_, d, what):
        ci, cf = S.seg_sums(seg_, ints_, f64s_, d)
        pi, pf = S.seg_sums_plain(seg_, ints_, f64s_, d)
        torch.cuda.synchronize()
        check(torch.equal(ci, pi), f"seg_sums int lanes differ ({what})")
        check(torch.allclose(cf, pf, rtol=1e-12, atol=0.0),
              f"seg_sums f64 lanes differ beyond rtol 1e-12 ({what})")
        err = (ci - pi).abs().max().item() if ci.numel() else 0
        if cf.numel():
            err = max(err, (cf - pf).abs().max().item())
        return err

    err_sums = check_sums(seg, ints, f64s, domain, "q1 shapes")
    # int64 wraparound near +-2^63 in one bucket
    wseg = torch.zeros(4096, dtype=torch.int32, device=dev)
    wrap = torch.full((4096,), 2 ** 63 - 1, dtype=torch.int64, device=dev)
    wrap[1::2] = -2 ** 63
    wrap[::7] = 2 ** 62
    check_sums(wseg, [wrap, -wrap], [], 3, "int64 wraparound")
    # all rows dead
    check_sums(torch.full((cap,), domain, dtype=torch.int32, device=dev),
               ints[:2], f64s, domain, "all dead")

    def check_reduce(seg_, lane, d, is_min, ident, what):
        c = S.seg_reduce(seg_, lane, d, is_min, ident)
        p = S.seg_reduce_plain(seg_, lane, d, is_min, ident)
        torch.cuda.synchronize()
        if c.dtype.is_floating_point:
            same = torch.equal(c.view(torch.int64), p.view(torch.int64))
            diff = c - p
        else:
            same = torch.equal(c, p)
            diff = c.to(torch.int64) - p.to(torch.int64)
        check(same, f"seg_reduce differs ({what}, min={is_min})")
        # equal bit patterns are checked above: inf - inf and nan - nan
        # count as 0
        diff = torch.nan_to_num(diff.abs(), nan=0.0) if \
            diff.dtype.is_floating_point else diff.abs()
        return diff.max().item() if diff.numel() else 0

    lanes = {
        "int32": torch.randint(-2 ** 31, 2 ** 31 - 1, (cap,), generator=g,
                               device=dev, dtype=torch.int32),
        "int64": ints[0] - 5_000_000_000,
        "float64": torch.randn(cap, generator=g, device=dev,
                               dtype=torch.float64),
        "int8": torch.randint(-128, 127, (cap,), generator=g, device=dev,
                              dtype=torch.int8),
    }
    err_reduce = 0
    for name, lane in lanes.items():
        for is_min in (True, False):
            if lane.dtype.is_floating_point:
                ident = float("inf") if is_min else float("-inf")
            else:
                info = torch.iinfo(lane.dtype)
                ident = info.max if is_min else info.min
            err_reduce = max(err_reduce, check_reduce(
                seg, lane, domain, is_min, ident, name))
            check_reduce(torch.full_like(seg, domain), lane, domain, is_min,
                         ident, f"{name} all dead")
    zseg = torch.tensor([0, 0, 0, 1, 1, 1, 1], dtype=torch.int32, device=dev)
    zlane = torch.tensor([0.0, -0.0, 0.0, float("inf"), -0.0,
                          float("-inf"), 0.0], dtype=torch.float64,
                         device=dev)
    for is_min in (True, False):
        ident = float("inf") if is_min else float("-inf")
        check_reduce(zseg, zlane, 2, is_min, ident, "+-0.0 and +-inf")
        got = S.seg_reduce(zseg, zlane, 2, is_min, ident).cpu()
        want0 = -0.0 if is_min else 0.0
        check(np.signbit(got[0].item()) == np.signbit(want0)
              and got[0].item() == 0.0,
              "±0.0 tie not in Double.compare order")
        check(got[1].item() == (float("-inf") if is_min else float("inf")),
              "±inf bucket reduced wrongly")
    log("[kernels] seg_sums and seg_reduce match their plain versions "
        f"(cap={cap}, domain={domain}, Ki={ki}, Kf={kf}; int exact, "
        "f64 rtol 1e-12; wraparound, all-dead, ±0.0/±inf edge cases)")

    # ---- timings
    idx = torch.where(seg < domain, seg.to(torch.int64),
                      torch.full_like(seg, domain, dtype=torch.int64))
    stacked_i = torch.stack(ints, dim=1)
    stacked_f = torch.stack(f64s, dim=1)

    def library_sums():
        oi = torch.zeros((domain + 1, ki), dtype=torch.int64, device=dev)
        of = torch.zeros((domain + 1, kf), dtype=torch.float64, device=dev)
        oi.index_add_(0, idx, stacked_i)
        of.index_add_(0, idx, stacked_f)

    sums_ms = cuda_ms(lambda: S.seg_sums(seg, ints, f64s, domain))
    sums_plain_ms = cuda_ms(lambda: S.seg_sums_plain(seg, ints, f64s,
                                                     domain))
    sums_lib_ms = cuda_ms(library_sums)
    sums_bytes = cap * 4 + live_rows * 8 * (ki + kf) + domain * 8 * (ki + kf)
    sums_bound = bound(sums_bytes, live_rows * (ki + kf))
    reduce_rows = {}
    for name, lane in lanes.items():
        info = torch.iinfo(lane.dtype) if not lane.dtype.is_floating_point \
            else None
        ident = float("inf") if info is None else info.max
        k_ms = cuda_ms(lambda: S.seg_reduce(seg, lane, domain, True, ident))
        p_ms = cuda_ms(lambda: S.seg_reduce_plain(seg, lane, domain, True,
                                                  ident))
        work = lane.to(torch.int32) if lane.dtype == torch.int8 else lane

        def library_reduce(work=work):
            out = torch.empty(domain + 1, dtype=work.dtype, device=dev)
            out.scatter_reduce_(0, idx, work, "amin", include_self=False)

        l_ms = cuda_ms(library_reduce)
        nbytes = cap * 4 + live_rows * lane.element_size() + \
            domain * lane.element_size()
        reduce_rows[name] = (k_ms, p_ms, l_ms, bound(nbytes, live_rows))
        log(f"[kernels] seg_reduce {name}: kernel {k_ms:.4f} ms, plain "
            f"{p_ms:.4f} ms, scatter_reduce_ {l_ms:.4f} ms, bound "
            f"{reduce_rows[name][3][0]:.4f} ms")
    log(f"[kernels] seg_sums: kernel {sums_ms:.4f} ms, plain "
        f"{sums_plain_ms:.4f} ms, index_add_ {sums_lib_ms:.4f} ms, bound "
        f"{sums_bound[0]:.4f} ms")
    k_ms, p_ms, l_ms, red_bound = reduce_rows["int64"]
    sums_kernel_ms, _n = profiled_ms(
        lambda: S.seg_sums(seg, ints, f64s, domain), "seg_sums_kernel")
    red_kernel_ms, _n = profiled_ms(
        lambda: S.seg_reduce(seg, lanes["int64"], domain, True,
                             torch.iinfo(torch.int64).max),
        "seg_reduce_kernel")
    # one device launch a seg_reduce call, narrow lanes included
    for name in ("int64", "float64", "int8"):
        lane = lanes[name]
        ident = float("inf") if lane.dtype.is_floating_point else \
            torch.iinfo(lane.dtype).max
        _ms, per_call = profiled_ms(
            lambda: S.seg_reduce(seg, lane, domain, True, ident),
            "seg_reduce_kernel", reps=5)
        check(per_call == 1, f"seg_reduce {name} made {per_call} device "
              "launches a call, not 1")
    log(f"[kernels] kernel-only device time (torch.profiler): seg_sums "
        f"{sums_kernel_ms} ms, seg_reduce int64 {red_kernel_ms} ms; "
        "seg_reduce is one device launch a call (int64, float64, int8)")
    dists = skew_phase(dev, tables, S, check_sums, check_reduce, seg, ints,
                       f64s, lanes["int64"], domain, ki, kf, g)
    return {
        "seg_sums": dict(max_abs_err=err_sums, ms=sums_ms,
                         plain_ms=sums_plain_ms, bound_ms=sums_bound[0],
                         bound_by=sums_bound[1], library_ms=sums_lib_ms,
                         kernel_ms=sums_kernel_ms,
                         distributions=dists["seg_sums"],
                         shape=f"cap={cap} D={domain} Ki={ki} Kf={kf}"),
        "seg_reduce": dict(max_abs_err=err_reduce, ms=k_ms, plain_ms=p_ms,
                           bound_ms=red_bound[0], bound_by=red_bound[1],
                           library_ms=l_ms, kernel_ms=red_kernel_ms,
                           distributions=dists["seg_reduce"],
                           shape=f"cap={cap} D={domain} int64 lane"),
    }


def skew_phase(dev, tables, S, check_sums, check_reduce, uniform, ints,
               f64s, lane, domain, ki, kf, g):
    """seg_sums (q1's lanes) and seg_reduce (the int64 lane) held against
    their plain versions and timed at q1's real bucket distribution, with
    every live row in one bucket, at domain 1024, and with the `uniform`
    buckets' last 60 % of rows dead (a join's output batch is live only up
    to its pair total): event ms, kernel-only device ms (profiler) and the
    bound, per distribution."""
    cap = lane.numel()
    real = q1_buckets(tables["lineitem"], cap, dev)
    live = real < domain
    one = torch.where(live, torch.full_like(real, 7), real)
    wide = torch.randint(0, 1024, (cap,), generator=g, device=dev,
                         dtype=torch.int32)
    wide = torch.where(live, wide, torch.full_like(wide, 1024))
    tail = uniform.clone()
    tail[int(cap * 0.4):] = domain
    out = {"seg_sums": {}, "seg_reduce": {}}
    imax = torch.iinfo(torch.int64).max
    for name, seg, d in (("q1 real", real, domain), ("one bucket", one,
                                                      domain),
                         ("D=1024", wide, 1024), ("tail dead", tail,
                                                  domain)):
        check_sums(seg, ints, f64s, d, name)
        for is_min in (True, False):
            check_reduce(seg, lane, d, is_min, imax if is_min else -imax - 1,
                         name)
        rows = int((seg < d).sum())
        shares = torch.bincount(seg.to(torch.int64), minlength=d + 1)[:d]
        top = float(shares.max()) / max(rows, 1)
        s_ms = cuda_ms(lambda: S.seg_sums(seg, ints, f64s, d))
        s_kern, _n = profiled_ms(lambda: S.seg_sums(seg, ints, f64s, d),
                                 "seg_sums_kernel")
        s_bound = bound(cap * 4 + rows * 8 * (ki + kf) + d * 8 * (ki + kf),
                        rows * (ki + kf))
        r_ms = cuda_ms(lambda: S.seg_reduce(seg, lane, d, True, imax))
        r_kern, _n = profiled_ms(lambda: S.seg_reduce(seg, lane, d, True,
                                                      imax),
                                 "seg_reduce_kernel")
        r_bound = bound(cap * 4 + rows * 8 + d * 8, rows)
        out["seg_sums"][name] = dict(ms=s_ms, kernel_ms=s_kern,
                                     bound_ms=s_bound[0], live_rows=rows,
                                     top_bucket_share=top, domain=d)
        out["seg_reduce"][name] = dict(ms=r_ms, kernel_ms=r_kern,
                                       bound_ms=r_bound[0], live_rows=rows,
                                       top_bucket_share=top, domain=d)
        log(f"[kernels] {name} (D={d}, {rows} live rows, largest bucket "
            f"{100 * top:.1f} %): seg_sums event {s_ms:.4f} ms, kernel "
            f"{s_kern} ms, bound {s_bound[0]:.4f} ms; seg_reduce int64 "
            f"event {r_ms:.4f} ms, kernel {r_kern} ms, bound "
            f"{r_bound[0]:.4f} ms; both equal their plain versions")
    return out


def _exact(got, want, what: str) -> int:
    """Fail unless equal; returns the largest absolute difference."""
    torch.cuda.synchronize()
    check(torch.equal(got, want), f"{what} differs from its plain version")
    if not got.numel():
        return 0
    return int((got.to(torch.int64) - want.to(torch.int64)).abs().max())


def q3_join_inputs(tables, dev):
    """The shapes q3's second join gives the kernels: the first join's
    output keys (orders of BUILDING customers before the cut-off date,
    concatenated tightly into their bucket capacity) as the build lane,
    and the first lineitem batch as the probe lane with the shipdate
    filter as its validity."""
    from spark_rapids_tpu_torch.columnar.device import bucket_capacity
    cust, orders, li = (tables[n] for n in ("customer", "orders",
                                            "lineitem"))
    seg = _col(cust, "c_mktsegment")
    building = _col(cust, "c_custkey").data[
        seg.data == list(seg.dictionary).index("BUILDING")]
    omask = (_col(orders, "o_orderdate").data < Q3_DATE) & \
        np.isin(_col(orders, "o_custkey").data, building)
    keys = _col(orders, "o_orderkey").data[omask]
    bcap = bucket_capacity(len(keys))
    lane = torch.zeros(bcap, dtype=torch.int64, device=dev)
    lane[:len(keys)] = torch.from_numpy(keys).to(dev)
    valid = torch.arange(bcap, device=dev) < len(keys)
    pcap = Q1_CAPACITY
    probe = torch.from_numpy(np.ascontiguousarray(
        _col(li, "l_orderkey").data[:pcap])).to(dev)
    pvalid = torch.from_numpy(
        _col(li, "l_shipdate").data[:pcap] > Q3_DATE).to(dev)
    return lane, valid, probe, pvalid


def semi_join_inputs(tables, dev):
    """The shapes semi's join gives probe_first: partsupp's (part,
    supplier) pairs folded into one lane by the port's own
    `range_pack_spec` and `packed_lane` (4,000,000 keys, the build at its
    bucket capacity), probed by the first lineitem batch's packed lane,
    every row valid."""
    from types import SimpleNamespace
    from spark_rapids_tpu_torch import tpch
    from spark_rapids_tpu_torch.columnar.device import bucket_capacity
    from spark_rapids_tpu_torch.exec import join as XJ
    from spark_rapids_tpu_torch.session import TpuSession
    node = tpch.semi(TpuSession(device="cpu"), tables).physical().root
    while not hasattr(node, "left_keys"):
        node = node.children[0]
    spec, _span = XJ.range_pack_spec(
        [e.bind(node.left.output_schema) for e in node.left_keys],
        [e.bind(node.right.output_schema) for e in node.right_keys],
        node.left, node.right)

    def packed(hb, names, rows):
        return XJ.packed_lane([SimpleNamespace(data=torch.from_numpy(
            np.ascontiguousarray(_col(hb, n).data[:rows])).to(dev))
            for n in names], spec)

    ps = tables["partsupp"]
    keys = packed(ps, ("ps_partkey", "ps_suppkey"), ps.num_rows)
    bcap = bucket_capacity(ps.num_rows)
    lane = torch.zeros(bcap, dtype=torch.int64, device=dev)
    lane[:ps.num_rows] = keys
    valid = torch.arange(bcap, device=dev) < ps.num_rows
    probe = packed(tables["lineitem"], ("l_partkey", "l_suppkey"),
                   Q1_CAPACITY)
    return lane, valid, probe, torch.ones_like(probe, dtype=torch.bool)


def layout_cases(lane, valid, g):
    """The build lanes, beside q3's, at which build_table is held and
    timed: q3's lane with 1 % of its rows valid (chosen among its keys),
    2,000 valid rows of its first 2,097,152 (the shape of q17's filtered
    part at SF10), one of its keys on 10,000 of its rows (a pushed run
    across slot chunks), and every row dead."""
    nkeys = int(valid.sum())
    dev = lane.device
    sparse = valid & (torch.rand(lane.numel(), generator=g, device=dev) <
                      0.01 * lane.numel() / nkeys)
    cut = min(2_097_152, lane.numel())
    few = torch.zeros(cut, dtype=torch.bool, device=dev)
    few[:2000] = True
    hot = lane.clone()
    hot[torch.randperm(nkeys, generator=g, device=dev)[:10_000]] = lane[0]
    return {"1 % valid": (lane, sparse),
            "2,000 valid of 2,097,152": (lane[:cut].contiguous(), few),
            "a key on 10,000 rows": (hot, valid),
            "all dead": (lane, torch.zeros_like(valid))}


def probe_bound(pcap: int, nvalid: int):
    """probe_first's bound: it reads every flag and writes row and flag;
    only a valid row needs its key and at least its home slot (a key
    and a row, 12 bytes), the least its walk reads."""
    return bound(pcap * (1 + 4 + 1) + nvalid * (8 + 12), nvalid)


def join_kernels_phase(dev, tables):
    from spark_rapids_tpu_torch.ops.hopper import compact as C
    from spark_rapids_tpu_torch.ops.hopper import hashjoin as HJ
    lane, valid, probe, pvalid = q3_join_inputs(tables, dev)
    bcap, pcap = lane.numel(), probe.numel()
    nbits, span = HJ.table_geometry(bcap)

    # ---- build_table: the layout kernel against its plain version
    err = {"build_table": 0, "probe_first": 0, "compaction_order": 0}

    def note(kernel, e):
        err[kernel] = max(err[kernel], e)

    def check_build(lane_, valid_, what):
        """The table against the plain layout: all 16 bytes of every
        slot, dead rows' and empty slots' included."""
        table = HJ.build_table(lane_, valid_)
        ideal, lane_s, rid = HJ.hash_order(lane_, valid_, table.nbits)
        note("build_table", _exact(
            table.slots, HJ.build_layout_plain(ideal, lane_s, rid,
                                               table.span),
            f"build_table slot buffer ({what})"))
        return table

    table = check_build(lane, valid, "q3 first-join keys")
    g = torch.Generator(device=dev).manual_seed(11)
    dup = torch.randint(0, 1000, (bcap,), generator=g, device=dev)
    check_build(dup, valid, "duplicate-heavy")
    build_cases = layout_cases(lane, valid, g)
    for name, (lane_, valid_) in build_cases.items():
        check_build(lane_, valid_, name)
    edge = torch.randint(-2 ** 63, 2 ** 63 - 1, (1 << 16,), generator=g,
                         device=dev, dtype=torch.int64)
    edge[:4] = torch.tensor([-2 ** 63, 2 ** 63 - 1, -1, 0])
    edge_table = check_build(edge, torch.ones_like(edge, dtype=torch.bool),
                             "±2^63 keys")

    # ---- probe_first: the first lineitem batch against that table
    def check_probe(table_, lane_, valid_, what):
        row, ok = HJ.probe_first(table_, lane_, valid_)
        prow, pok = HJ.probe_first_plain(table_, lane_, valid_)
        note("probe_first", _exact(row, prow, f"probe_first rows ({what})"))
        note("probe_first", _exact(ok, pok,
                                   f"probe_first found flags ({what})"))
        return ok

    ok = check_probe(table, probe, pvalid, "q3 lineitem batch")
    check_probe(edge_table, edge.flip(0), torch.rand(
        edge.numel(), generator=g, device=dev) > 0.1, "±2^63 keys")
    matched = int(ok.sum())
    check_probe(table, probe[1:], pvalid[1:], "validity misaligned by one")
    check_probe(table, probe, torch.ones_like(pvalid), "every row valid")
    check_probe(table, probe, torch.zeros_like(pvalid), "no row valid")
    check_probe(table, probe[:3_000_017].contiguous(),
                pvalid[:3_000_017].contiguous(), "capacity 3,000,017")
    s_lane, s_valid, s_probe, s_pvalid = semi_join_inputs(tables, dev)
    s_table = check_build(s_lane, s_valid, "semi's packed partsupp keys")
    s_matched = int(check_probe(s_table, s_probe, s_pvalid,
                                "semi lineitem batch").sum())

    # ---- compaction_order: keep = q3's second-join match mask
    def check_compact(keep, what):
        order, count = C.compaction_order(keep)
        porder, pcount = C.compaction_order_plain(keep)
        note("compaction_order", _exact(order, porder,
                                        f"compaction_order ({what})"))
        note("compaction_order", _exact(count, pcount,
                                        f"compaction count ({what})"))

    keep = ok & pvalid
    check_compact(keep, "q3 second join")
    check_compact(torch.zeros_like(keep), "0 %")
    check_compact(torch.ones_like(keep), "100 %")
    odd = torch.rand(3_000_017, generator=g, device=dev) < 0.3
    check_compact(odd, "capacity 3,000,017")
    check_compact(odd[:300], "capacity 300")
    check_compact(keep[1:], "misaligned by one row")
    sparse = torch.rand(pcap, generator=g, device=dev) < 0.01
    half = torch.rand(pcap, generator=g, device=dev) < 0.5
    dense = torch.rand(pcap, generator=g, device=dev) < 0.99
    check_compact(sparse, "1 %")
    check_compact(half, "50 %")
    check_compact(dense, "99 %")
    log(f"[kernels] build_table, probe_first and compaction_order equal "
        f"their plain versions (build capacity {bcap}, span {span}, "
        f"{int(valid.sum())} keys; probe {pcap} rows, {matched} matched; "
        f"semi's {int(s_valid.sum())} packed keys, {s_matched} of {pcap} "
        "probes matched; builds: duplicate-heavy, ±2^63, "
        f"{', '.join(build_cases)}; masks: 0 %, 1 %, 50 %, 99 %, 100 %, "
        "capacities 3,000,017 and 300, misaligned by one row)")

    # ---- timings
    # build_layout: event and kernel-only time (every launch of a call),
    # its launches a call, and the kernel-only time with the L2 flushed
    # before each call, at q3's lane and the four layout cases; it reads
    # ideal, key and row id once and writes the whole table once
    def time_build(lane_, valid_):
        nbits_, span_ = HJ.table_geometry(lane_.numel())
        args = HJ.hash_order(lane_, valid_, nbits_)
        parts = {}
        kern, calls = profiled_ms(lambda: HJ.build_layout(*args, span_),
                                  by_name=parts)
        return dict(
            ms=cuda_ms(lambda: HJ.build_layout(*args, span_)),
            kernel_ms=kern, launches_per_call=calls, kernel_parts=parts,
            cold_kernel_ms=profiled_ms(
                lambda: HJ.build_layout(*args, span_), BUILD_KERNELS,
                cold=True)[0],
            bound_ms=bound(lane_.numel() * (4 + 8 + 4) + span_ * (8 + 4),
                           lane_.numel())[0],
            valid=int(valid_.sum()), cap=lane_.numel(), span=span_)

    build_dists = {"q3": time_build(lane, valid)}
    for name, (lane_, valid_) in build_cases.items():
        build_dists[name] = time_build(lane_, valid_)
    ideal, lane_s, rid = HJ.hash_order(lane, valid, nbits)
    build_plain = cuda_ms(lambda: HJ.build_layout_plain(ideal, lane_s, rid,
                                                        span), reps=5)
    sort_ms = cuda_ms(lambda: HJ.hash_order(lane, valid, nbits), reps=5)
    build_bound = bound(bcap * (4 + 8 + 4) + span * (8 + 4), bcap)
    # probe_first at q3's and semi's shapes, each beside the sorted
    # tier's probe as its yardstick: a searchsorted of the probe lane in
    # the stably sorted build lane (dead rows last) and the gather of the
    # build row
    def time_probe(table_, lane_, valid_, probe_, pvalid_):
        key = torch.where(valid_, lane_, torch.full_like(lane_, 2 ** 63 - 1))
        svals, sperm = torch.sort(key, stable=True)

        def library_probe():
            pos = torch.clamp(torch.searchsorted(svals, probe_),
                              max=lane_.numel() - 1)
            return sperm[pos], svals[pos] == probe_

        nvalid_ = int(pvalid_.sum())
        kern, calls = profiled_ms(lambda: HJ.probe_first(table_, probe_,
                                                         pvalid_))
        return dict(
            ms=cuda_ms(lambda: HJ.probe_first(table_, probe_, pvalid_)),
            kernel_ms=kern, launches_per_call=calls,
            cold_kernel_ms=profiled_ms(
                lambda: HJ.probe_first(table_, probe_, pvalid_),
                "probe_first_kernel", cold=True)[0],
            plain_ms=cuda_ms(lambda: HJ.probe_first_plain(
                table_, probe_, pvalid_), reps=5),
            library_ms=cuda_ms(library_probe),
            bound_ms=probe_bound(probe_.numel(), nvalid_)[0], valid=nvalid_,
            keys=int(valid_.sum()), span=table_.span)

    probe_dists = {"q3": time_probe(table, lane, valid, probe, pvalid),
                   "semi": time_probe(s_table, s_lane, s_valid, s_probe,
                                      s_pvalid)}
    nvalid = probe_dists["q3"]["valid"]
    sort_key = torch.where(valid, lane, torch.full_like(lane, 2 ** 63 - 1))
    build_lib = cuda_ms(lambda: torch.sort(sort_key, stable=True))
    compact_ms = cuda_ms(lambda: C.compaction_order(keep))
    compact_plain = cuda_ms(lambda: C.compaction_order_plain(keep))
    inv = (~keep).to(torch.int8)
    compact_lib = cuda_ms(lambda: torch.argsort(inv, stable=True))
    compact_bound = bound(pcap * (1 + 4) + 4, pcap)
    # kernel-only: the device time of every launch a call makes
    compact_parts = {}
    compact_kern, compact_calls = profiled_ms(
        lambda: C.compaction_order(keep), by_name=compact_parts)
    compact_dists = {}
    for name, m in (("1 %", sparse), ("q3 second join", keep),
                    ("50 %", half), ("99 %", dense)):
        compact_dists[name] = dict(
            kept=int(m.sum()), ms=cuda_ms(lambda: C.compaction_order(m)),
            kernel_ms=profiled_ms(lambda: C.compaction_order(m))[0])
        log(f"[kernels] compaction_order at {name} "
            f"({compact_dists[name]['kept']} of {pcap} kept): event "
            f"{compact_dists[name]['ms']:.4f} ms, kernel "
            f"{compact_dists[name]['kernel_ms']:.4f} ms")
    for name, d in build_dists.items():
        log(f"[kernels] build_table layout at {name} ({d['valid']} of "
            f"{d['cap']} rows valid, span {d['span']}): event "
            f"{d['ms']:.4f} ms, kernel {d['kernel_ms']:.4f} ms in "
            f"{d['launches_per_call']:g} device launches a call "
            f"{d['kernel_parts']} (L2 flushed before each call "
            f"{d['cold_kernel_ms']:.4f} ms), bound {d['bound_ms']:.4f} ms")
    log(f"[kernels] build_table layout at q3's: plain {build_plain:.4f} ms, "
        f"stable sort {build_lib:.4f} ms; its PyTorch hash-order sort "
        f"{sort_ms:.4f} ms")
    for name, d in probe_dists.items():
        log(f"[kernels] probe_first at {name}'s shapes ({d['keys']} keys, "
            f"span {d['span']}; {d['valid']} of {pcap} probes valid): event "
            f"{d['ms']:.4f} ms, kernel {d['kernel_ms']:.4f} ms in "
            f"{d['launches_per_call']:g} device launches a call (L2 "
            f"flushed before each call {d['cold_kernel_ms']:.4f} ms), "
            f"plain {d['plain_ms']:.4f} ms, searchsorted + gather "
            f"{d['library_ms']:.4f} ms, bound {d['bound_ms']:.4f} ms")
    log(f"[kernels] compaction_order: event {compact_ms:.4f} ms, kernel "
        f"{compact_kern:.4f} ms in {compact_calls:g} device launches a "
        f"call {compact_parts}, plain {compact_plain:.4f} ms, stable "
        f"argsort {compact_lib:.4f} ms, bound {compact_bound[0]:.4f} ms")
    return {
        "compaction_order": dict(
            max_abs_err=err["compaction_order"], ms=compact_ms, plain_ms=compact_plain,
            bound_ms=compact_bound[0], bound_by=compact_bound[1],
            library_ms=compact_lib, kernel_ms=compact_kern,
            launches_per_call=compact_calls, kernel_parts=compact_parts,
            distributions=compact_dists,
            shape=f"cap={pcap} kept={int(keep.sum())}"),
        "build_table": dict(
            max_abs_err=err["build_table"], plain_ms=build_plain,
            bound_ms=build_bound[0], bound_by=build_bound[1],
            library_ms=build_lib, hash_sort_ms=sort_ms,
            **{k: build_dists["q3"][k] for k in (
                "ms", "kernel_ms", "cold_kernel_ms", "launches_per_call",
                "kernel_parts")},
            distributions=build_dists,
            shape=f"cap={bcap} keys={int(valid.sum())} span={span}"),
        "probe_first": dict(
            max_abs_err=err["probe_first"],
            **{k: probe_dists["q3"][k] for k in (
                "ms", "plain_ms", "bound_ms", "library_ms", "kernel_ms",
                "cold_kernel_ms", "launches_per_call")},
            bound_by=probe_bound(pcap, nvalid)[1],
            distributions=probe_dists,
            shape=f"probe={pcap} valid={nvalid} span={span}"),
    }


M2M_DATES = (pydt.date(1994, 1, 1), pydt.date(1995, 1, 1))
OUTER_DATES = (pydt.date(1995, 3, 1), pydt.date(1995, 3, 8))


def _in_dates(li, dates):
    ship = _col(li, "l_shipdate").data
    return (ship >= _days(dates[0])) & (ship < _days(dates[1]))


def m2m_join_inputs(tables, dev):
    """The shapes m2m's join gives the counted probe: partsupp's part
    keys as the build lane at their bucket capacity, the first lineitem
    batch as the probe lane with the 1994 filter as its validity."""
    from spark_rapids_tpu_torch.columnar.device import bucket_capacity
    keys = _col(tables["partsupp"], "ps_partkey").data
    bcap = bucket_capacity(len(keys))
    lane = torch.zeros(bcap, dtype=torch.int64, device=dev)
    lane[:len(keys)] = torch.from_numpy(keys).to(dev)
    valid = torch.arange(bcap, device=dev) < len(keys)
    li = tables["lineitem"]
    pcap = Q1_CAPACITY
    probe = torch.from_numpy(np.ascontiguousarray(
        _col(li, "l_partkey").data[:pcap])).to(dev)
    pvalid = torch.from_numpy(np.ascontiguousarray(
        _in_dates(li, M2M_DATES)[:pcap])).to(dev)
    return lane, valid, probe, pvalid


def counted_join_kernels_phase(dev, tables):
    from spark_rapids_tpu_torch.columnar.device import bucket_capacity
    from spark_rapids_tpu_torch.ops.hopper import hashjoin as HJ
    lane, valid, probe, pvalid = m2m_join_inputs(tables, dev)
    bcap, pcap = lane.numel(), probe.numel()
    table = HJ.build_table(lane, valid)
    err = {"probe_counts": 0, "expand_pairs": 0}

    def note(kernel, e):
        err[kernel] = max(err[kernel], e)

    def check_counted(table_, lane_, valid_, what):
        """probe_counts and the full expansion against their plain
        versions; returns (first, counts, cum, total, out_cap)."""
        first, counts, cum = HJ.probe_counts(table_, lane_, valid_)
        pfirst, pcounts = HJ.probe_counts_plain(table_, lane_, valid_)
        note("probe_counts", _exact(first, pfirst,
                                    f"probe_counts first ({what})"))
        note("probe_counts", _exact(counts, pcounts,
                                    f"probe_counts counts ({what})"))
        note("probe_counts", _exact(cum, HJ.inclusive_cumsum(pcounts),
                                    f"probe_counts cum ({what})"))
        total = int(cum[-1])
        out_cap = bucket_capacity(max(total, 1))
        got = HJ.expand_pairs(table_, first, counts, cum, out_cap, total)
        want = HJ.expand_pairs_plain(table_, first, counts, cum, out_cap,
                                     total)
        for g, w, part in zip(got, want, ("probe rows", "build rows",
                                          "live flags")):
            note("expand_pairs", _exact(g, w, f"expand_pairs {part} "
                                              f"({what})"))
        return first, counts, cum, total, out_cap

    first, counts, cum, total, out_cap = check_counted(
        table, probe, pvalid, "m2m first lineitem batch")
    g = torch.Generator(device=dev).manual_seed(13)
    # one key 10,000 times in a build of 2^20 rows
    dup = torch.randint(0, 1 << 40, (1 << 20,), generator=g, device=dev)
    dup[:10_000] = 42
    dup_probe = dup[torch.randint(10_000, 1 << 20, (1 << 20,), generator=g,
                                  device=dev)]
    dup_probe[:100] = 42                   # 100 probes of 10,000 pairs
    ones = torch.ones(1 << 20, dtype=torch.bool, device=dev)
    dup_table = HJ.build_table(dup, ones)
    dup_case = check_counted(dup_table, dup_probe, ones,
                             "a key 10,000 times")
    dup_total = dup_case[3]
    check(dup_total >= 100 * 10_000, "the duplicate-heavy case expanded "
          f"only {dup_total} pairs")
    # a total of 0: every probe key misses; all-dead probes
    miss = torch.full((1 << 20,), -7, dtype=torch.int64, device=dev)
    check(check_counted(dup_table, miss, ones, "total 0")[3] == 0,
          "the all-miss probe found pairs")
    check(check_counted(table, probe, torch.zeros_like(pvalid),
                        "all-dead probes")[3] == 0,
          "the all-dead probe found pairs")
    # ±2^63 keys, and a probe capacity that is not a power of two
    edge = torch.randint(-2 ** 63, 2 ** 63 - 1, (1 << 16,), generator=g,
                         device=dev, dtype=torch.int64)
    edge[:4] = torch.tensor([-2 ** 63, 2 ** 63 - 1, -1, 0])
    edge = torch.cat([edge, edge[:4]])                 # repeated edges
    edge_table = HJ.build_table(edge, torch.ones_like(edge,
                                                      dtype=torch.bool))
    check_counted(edge_table, edge.flip(0), torch.rand(
        edge.numel(), generator=g, device=dev) > 0.1, "±2^63 keys")
    odd = 3_000_017
    check_counted(table, probe[:odd].contiguous(),
                  pvalid[:odd].contiguous(), "probe capacity 3,000,017")
    check_counted(table, probe[1:], pvalid[1:], "validity misaligned by one")
    # m2m's batch with its first 3,000,000 rows owning no pairs
    late = pvalid.clone()
    late[:3_000_000] = False
    late_case = check_counted(table, probe, late, "3,000,000 leading rows "
                              "own no pairs")
    nvalid = int(pvalid.sum())
    log(f"[kernels] probe_counts and expand_pairs equal their plain "
        f"versions (partsupp build capacity {bcap}, span {table.span}; "
        f"probe {pcap} rows, {nvalid} valid, {total} pairs at output "
        f"capacity {out_cap}; a key 10,000 times ({dup_total} pairs), "
        "total 0, all-dead probes, ±2^63 keys, probe capacity 3,000,017, "
        "validity misaligned by one row, 3,000,000 leading rows without "
        f"pairs ({late_case[3]} pairs))")

    # ---- timings, at m2m's shapes
    k_counts = cuda_ms(lambda: HJ.probe_counts(table, probe, pvalid))

    def plain_counts():
        _f, c = HJ.probe_counts_plain(table, probe, pvalid)
        return HJ.inclusive_cumsum(c)

    p_counts = cuda_ms(plain_counts, reps=5)
    # yardstick: the same function on the sorted representation, two
    # searchsorted calls of the probe lane into the sorted build lane
    sort_key = torch.where(valid, lane, torch.full_like(lane, 2 ** 63 - 1))
    svals = torch.sort(sort_key, stable=True).values

    def library_counts():
        lo = torch.searchsorted(svals, probe)
        hi = torch.searchsorted(svals, probe, right=True)
        c = torch.where(pvalid, hi - lo, torch.zeros_like(lo))
        return lo, torch.cumsum(c, 0, dtype=torch.int32)

    l_counts = cuda_ms(library_counts)
    # reads every flag and writes first, count and cum (13 bytes a row);
    # only a valid row needs its key, its run and the slot past it
    walked = int((counts.to(torch.int64) + 1)[pvalid].sum())
    counts_bound = bound(pcap * (1 + 12) + nvalid * 8 + walked * 12,
                         pcap + walked)
    # kernel-only: the device time of every launch a call makes (the
    # probe with its scan of the counts)
    counts_parts = {}
    kern_counts, counts_calls = profiled_ms(
        lambda: HJ.probe_counts(table, probe, pvalid), by_name=counts_parts)
    cold_counts = profiled_ms(lambda: HJ.probe_counts(table, probe, pvalid),
                              "probe_counts_kernel", cold=True)[0]

    def time_expand(table_, case):
        """expand_pairs' times at one case of check_counted, beside the
        one-call yardstick: repeat_interleave of the probe rows by their
        counts, then the gather of the build rows."""
        first_, counts_, cum_, total_, out_cap_ = case
        pcap_ = first_.numel()
        ar = torch.arange(pcap_, device=dev)
        jt = torch.arange(total_, device=dev)
        first64 = first_.to(torch.int64)
        start64 = (cum_ - counts_).to(torch.int64)
        counts64 = counts_.to(torch.int64)

        def library_expand():
            p = torch.repeat_interleave(ar, counts64, output_size=total_)
            return p, table_.rows[first64[p] + (jt - start64[p])]

        def run():
            return HJ.expand_pairs(table_, first_, counts_, cum_, out_cap_,
                                   total_)

        kern, calls = profiled_ms(run)
        # writes 9 bytes an output slot and reads one table row a pair;
        # cum once (a run starts where the previous row's cum ends) and
        # first at the rows that own pairs; a merge step per slot and
        # per probe row
        owners = int((counts_ > 0).sum())
        b = bound(out_cap_ * 9 + total_ * 4 + pcap_ * 4 + owners * 4,
                  total_ + pcap_)
        return dict(ms=cuda_ms(run), kernel_ms=kern, launches_per_call=calls,
                    cold_kernel_ms=profiled_ms(run, "expand_pairs_kernel",
                                               cold=True)[0],
                    plain_ms=cuda_ms(lambda: HJ.expand_pairs_plain(
                        table_, first_, counts_, cum_, out_cap_, total_),
                        reps=5),
                    library_ms=cuda_ms(library_expand), bound_ms=b[0],
                    bound_by=b[1], pairs=total_, out_cap=out_cap_,
                    owners=owners, probe=pcap_)

    expand_dists = {
        "m2m": time_expand(table, (first, counts, cum, total, out_cap)),
        "a key 10,000 times": time_expand(dup_table, dup_case),
        "3,000,000 leading rows own no pairs": time_expand(table,
                                                           late_case)}
    log(f"[kernels] probe_counts (first, counts and cum): event "
        f"{k_counts:.4f} ms, kernel {kern_counts:.4f} ms in "
        f"{counts_calls:g} device launches a call {counts_parts} (L2 "
        f"flushed before each call {cold_counts:.4f} ms), plain "
        f"{p_counts:.4f} ms, two searchsorted {l_counts:.4f} ms, bound "
        f"{counts_bound[0]:.4f} ms ({walked} table slots walked)")
    for name, d in expand_dists.items():
        log(f"[kernels] expand_pairs at {name} ({d['pairs']} pairs at "
            f"output capacity {d['out_cap']}, {d['owners']} of {d['probe']} "
            f"probe rows own pairs): event {d['ms']:.4f} ms, kernel "
            f"{d['kernel_ms']:.4f} ms in {d['launches_per_call']:g} device "
            f"launches a call (L2 flushed before each call "
            f"{d['cold_kernel_ms']:.4f} ms), plain {d['plain_ms']:.4f} ms, "
            f"repeat_interleave + gather {d['library_ms']:.4f} ms, bound "
            f"{d['bound_ms']:.4f} ms")
    return {
        "probe_counts": dict(
            max_abs_err=err["probe_counts"], ms=k_counts, plain_ms=p_counts,
            bound_ms=counts_bound[0], bound_by=counts_bound[1],
            library_ms=l_counts, kernel_ms=kern_counts,
            cold_kernel_ms=cold_counts,
            launches_per_call=counts_calls, kernel_parts=counts_parts,
            shape=f"probe={pcap} valid={nvalid} span={table.span} "
                  f"build={bcap}"),
        "expand_pairs": dict(
            max_abs_err=err["expand_pairs"],
            **{k: expand_dists["m2m"][k] for k in (
                "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                "kernel_ms", "cold_kernel_ms", "launches_per_call")},
            distributions=expand_dists,
            shape=f"probe={pcap} pairs={total} out_cap={out_cap}"),
    }


# ---------------------------------------------------------------------------
# Phase 5: the main path against independent numpy computations
# ---------------------------------------------------------------------------

def _days(d: pydt.date) -> int:
    return (d - pydt.date(1970, 1, 1)).days


def _half_up_div(num: int, den: int) -> int:
    mag = (abs(num) + den // 2) // den
    return -mag if num < 0 else mag


def _groups(codes: np.ndarray):
    """Stable argsort of group codes + the run starts (reduceat offsets)."""
    order = np.argsort(codes, kind="stable")
    sc = codes[order]
    starts = np.flatnonzero(np.r_[True, sc[1:] != sc[:-1]])
    return order, sc[starts], starts


def _col(hb, name):
    return hb.column_by_name(name)


def expected_q1(li):
    cutoff = _days(pydt.date(1998, 12, 1)) - 90
    ship = _col(li, "l_shipdate").data
    mask = ship <= cutoff
    rf, ls = _col(li, "l_returnflag"), _col(li, "l_linestatus")
    key = rf.data[mask].astype(np.int64) * len(ls.dictionary) + \
        ls.data[mask]
    qty = _col(li, "l_quantity").data[mask]
    price = _col(li, "l_extendedprice").data[mask]
    disc = _col(li, "l_discount").data[mask]
    tax = _col(li, "l_tax").data[mask]
    disc_price = price * (100 - disc)                # scale 4
    charge = disc_price * (100 + tax)                # scale 6
    order, gkeys, starts = _groups(key)
    sums = {n: np.add.reduceat(v[order], starts) for n, v in (
        ("sum_qty", qty), ("sum_base_price", price),
        ("sum_disc_price", disc_price), ("sum_charge", charge),
        ("sum_disc", disc))}
    counts = np.diff(np.r_[starts, len(key)])
    out = {"l_returnflag": [rf.dictionary[k // len(ls.dictionary)]
                            for k in gkeys],
           "l_linestatus": [ls.dictionary[k % len(ls.dictionary)]
                            for k in gkeys],
           "sum_qty": sums["sum_qty"].tolist(),
           "sum_base_price": sums["sum_base_price"].tolist(),
           "sum_disc_price": sums["sum_disc_price"].tolist(),
           "sum_charge": sums["sum_charge"].tolist(),
           # avg(decimal(12,2)) -> decimal(16,6): shift 4, HALF_UP
           "avg_qty": [_half_up_div(int(s) * 10 ** 4, int(c)) for s, c in
                       zip(sums["sum_qty"], counts)],
           "avg_price": [_half_up_div(int(s) * 10 ** 4, int(c)) for s, c in
                         zip(sums["sum_base_price"], counts)],
           "avg_disc": [_half_up_div(int(s) * 10 ** 4, int(c)) for s, c in
                        zip(sums["sum_disc"], counts)],
           "count_order": counts.tolist()}
    return out


def expected_q6(li):
    ship = _col(li, "l_shipdate").data
    disc = _col(li, "l_discount").data
    qty = _col(li, "l_quantity").data
    mask = (ship >= _days(pydt.date(1994, 1, 1))) & \
        (ship < _days(pydt.date(1995, 1, 1))) & (disc >= 5) & \
        (disc <= 7) & (qty < 2400)
    price = _col(li, "l_extendedprice").data
    return {"revenue": [int(np.sum(price[mask] * disc[mask]))]}


def minmax_query(s, tables):
    from spark_rapids_tpu_torch import types as T
    from spark_rapids_tpu_torch.plan import expressions as E
    from spark_rapids_tpu_torch.plan.aggregates import First, Last, Max, Min
    from spark_rapids_tpu_torch.session import col
    li = s.from_host(tables["lineitem"])
    return (li.group_by("l_returnflag", "l_linestatus")
            .agg((Min(col("l_extendedprice")), "min_price"),
                 (Max(col("l_extendedprice")), "max_price"),
                 (Min(col("l_shipdate")), "min_ship"),
                 (Max(col("l_shipdate")), "max_ship"),
                 (Min(E.Cast(col("l_discount"), T.DOUBLE)), "min_disc"),
                 (Max(E.Cast(col("l_tax"), T.DOUBLE)), "max_tax"),
                 (First(col("l_orderkey")), "first_order"),
                 (Last(col("l_orderkey")), "last_order"))
            .sort("l_returnflag", "l_linestatus"))


def expected_minmax(li):
    rf, ls = _col(li, "l_returnflag"), _col(li, "l_linestatus")
    key = rf.data.astype(np.int64) * len(ls.dictionary) + ls.data
    order, gkeys, starts = _groups(key)
    ends = np.r_[starts[1:], len(key)] - 1
    out = {"l_returnflag": [rf.dictionary[k // len(ls.dictionary)]
                            for k in gkeys],
           "l_linestatus": [ls.dictionary[k % len(ls.dictionary)]
                            for k in gkeys]}
    for name, cname, fn in (("min_price", "l_extendedprice", np.minimum),
                            ("max_price", "l_extendedprice", np.maximum),
                            ("min_ship", "l_shipdate", np.minimum),
                            ("max_ship", "l_shipdate", np.maximum)):
        out[name] = fn.reduceat(_col(li, cname).data[order], starts).tolist()
    out["min_disc"] = np.minimum.reduceat(
        _col(li, "l_discount").data[order] / 100.0, starts).tolist()
    out["max_tax"] = np.maximum.reduceat(
        _col(li, "l_tax").data[order] / 100.0, starts).tolist()
    okey = _col(li, "l_orderkey").data
    # the stable argsort keeps row order inside each group: its first and
    # last entries are the group's first and last rows
    out["first_order"] = okey[order[starts]].tolist()
    out["last_order"] = okey[order[ends]].tolist()
    return out


def expected_q3(tables):
    """q3 in numpy: np.isin for the customer join, searchsorted over the
    filtered order keys for the lineitem join, a stable argsort group-by
    with exact int64 sums, then revenue desc, orderdate asc and (the
    group order the engine gives ties) orderkey asc, top 10.  Also
    returns every row tied with the 10th on (revenue, orderdate)."""
    cust, orders, li = (tables[n] for n in ("customer", "orders",
                                            "lineitem"))
    seg = _col(cust, "c_mktsegment")
    building = _col(cust, "c_custkey").data[
        seg.data == list(seg.dictionary).index("BUILDING")]
    omask = (_col(orders, "o_orderdate").data < Q3_DATE) & \
        np.isin(_col(orders, "o_custkey").data, building)
    okey = _col(orders, "o_orderkey").data[omask]
    odate = _col(orders, "o_orderdate").data[omask]
    oprio = _col(orders, "o_shippriority").data[omask]
    by_key = np.argsort(okey, kind="stable")
    okey, odate, oprio = okey[by_key], odate[by_key], oprio[by_key]
    lkey = _col(li, "l_orderkey").data
    pos = np.clip(np.searchsorted(okey, lkey), 0, max(len(okey) - 1, 0))
    lmask = (_col(li, "l_shipdate").data > Q3_DATE) & \
        (okey[pos] == lkey) if len(okey) else np.zeros(len(lkey), bool)
    rev = _col(li, "l_extendedprice").data[lmask] * \
        (100 - _col(li, "l_discount").data[lmask])          # scale 4
    order, gpos, starts = _groups(pos[lmask])
    sums = np.add.reduceat(rev[order], starts)
    g_key, g_date, g_prio = okey[gpos], odate[gpos], oprio[gpos]
    rank = np.lexsort((g_key, g_date, -sums))
    cols = {"o_orderkey": g_key, "o_orderdate": g_date,
            "o_shippriority": g_prio, "revenue": sums}
    top = {n: v[rank[:10]].tolist() for n, v in cols.items()}
    tied = []
    if len(rank) >= 10:
        tenth = rank[9]
        tie = (sums == sums[tenth]) & (g_date == g_date[tenth])
        tied = sorted(zip(*(v[tie].tolist() for v in cols.values())))
    return top, tied


def check_top(name: str, lanes, want) -> None:
    """Rows equal; a tie on the sort keys at the top-N's last row may
    order its tied rows otherwise, so those rows need only come from the
    tied set."""
    top, tied = want
    if lanes == top:
        return
    got = list(zip(*(lanes[n] for n in top)))
    exp = list(zip(*top.values()))
    check(len(got) == len(exp) and tied, f"{name} differs from the numpy "
          f"reference:\n{lanes}\n{top}")
    head = [r for r in exp if r not in tied]
    check(got[:len(head)] == head and set(got[len(head):]) <= set(tied),
          f"{name} differs from the numpy reference beyond the tie at its "
          f"last row:\n{lanes}\n{top}\ntied: {tied}")


def _pairs(build_keys, probe_keys):
    """Equi-join pairs in numpy: (probe row, build row) for every equal
    key, probe-major with build rows ascending, from a stable argsort of
    the build keys, two searchsorted calls and np.repeat.  The probe keys
    are searched in sorted order, which keeps the searches in cache."""
    order = np.argsort(build_keys, kind="stable")
    skeys = build_keys[order]
    qorder = np.argsort(probe_keys)
    sprobe = probe_keys[qorder]
    lo = np.empty(len(probe_keys), np.int64)
    cnt = np.empty(len(probe_keys), np.int64)
    lo[qorder] = np.searchsorted(skeys, sprobe, side="left")
    cnt[qorder] = np.searchsorted(skeys, sprobe, side="right") - lo[qorder]
    probe_rows = np.repeat(np.arange(len(probe_keys)), cnt)
    offset = np.arange(len(probe_rows)) - np.repeat(np.cumsum(cnt) - cnt,
                                                    cnt)
    return probe_rows, order[np.repeat(lo, cnt) + offset], cnt


def expected_m2m(tables):
    """m2m: 1994's lineitem ⋈ partsupp on the part key, per ship mode the
    exact int64 sum of supplycost x quantity (scale 4) and the pairs."""
    li, ps = tables["lineitem"], tables["partsupp"]
    rows = np.flatnonzero(_in_dates(li, M2M_DATES))
    lrow, prow, _cnt = _pairs(_col(ps, "ps_partkey").data,
                              _col(li, "l_partkey").data[rows])
    lrow = rows[lrow]
    cost = _col(ps, "ps_supplycost").data[prow] * \
        _col(li, "l_quantity").data[lrow]
    mode = _col(li, "l_shipmode")
    order, gmodes, starts = _groups(mode.data[lrow])
    # the dictionary is sorted, so ascending codes are ascending names
    return {"l_shipmode": [str(mode.dictionary[m]) for m in gmodes],
            "cost": np.add.reduceat(cost[order], starts).tolist(),
            "n": np.diff(np.r_[starts, len(lrow)]).tolist()}


def expected_outer(tables):
    """outer: per partsupp row its matches among one week of lineitem
    (0 for none), then how many rows have each count, n desc, count
    desc."""
    li, ps = tables["lineitem"], tables["partsupp"]
    week = _col(li, "l_partkey").data[_in_dates(li, OUTER_DATES)]
    _p, _b, per_row = _pairs(week, _col(ps, "ps_partkey").data)
    values, n = np.unique(per_row, return_counts=True)
    rank = np.lexsort((-values, -n))
    return {"c_count": values[rank].tolist(), "n": n[rank].tolist()}


def expected_semi(tables):
    """semi: the lineitem rows whose (part, supplier) pair partsupp has,
    their count and the exact sum of their quantities."""
    li, ps = tables["lineitem"], tables["partsupp"]
    width = int(_col(ps, "ps_suppkey").data.max()) + 1
    pair = _col(ps, "ps_partkey").data * width + _col(ps, "ps_suppkey").data
    lsk = _col(li, "l_suppkey").data
    _p, _b, cnt = _pairs(pair, _col(li, "l_partkey").data * width + lsk)
    keep = (cnt > 0) & (lsk < width)
    return {"n": [int(keep.sum())],
            "qty": [int(_col(li, "l_quantity").data[keep].sum())]}


# ---------------------------------------------------------------------------
# The eleven later TPC-H queries in numpy.  gen_tables makes every
# primary key 0..n-1, so a join on one is an index (`_pk` checks it);
# decimal sums are exact int64 (unscaled), DOUBLE results follow the
# engine's casts (unscaled / 10^scale) and compare within rtol 1e-12.
# ---------------------------------------------------------------------------

#: queries run below --scale, with the scale they run at: none.  The
#: seven whose join builds exceed 2 x sql.batchSizeRows at SF10 (q7, q8,
#: q9, q12 and q21 build on orders, q22 on o_custkey, q4 on its late
#: lineitem) sub-partition those joins (exec/join.py)
CUT_SCALES: dict = {}
#: the queries that sub-partition a join at SF10
SUB_PARTITIONED = ("q4", "q7", "q8", "q9", "q12", "q21", "q22")
#: the queries of the strings and COUNT(DISTINCT) slice, and q20 for
#: UNITED STATES (`q20_us`): the reference's CANADA keeps no supplier at
#: SF10.  Each but q20 must carry rows on the card
STRING_QUERIES = ("q2", "q9", "q13", "q14", "q16", "q20", "q20_us", "q21",
                  "q22")
LATER_QUERIES = ("q4", "q5", "q7", "q8", "q10", "q11", "q11_spec", "q12",
                 "q15", "q17", "q18", "q18_300", "q19") + STRING_QUERIES
#: the DOUBLE result columns, held to numpy within rtol 1e-12
DOUBLE_COLUMNS = {"q8": ("mkt_share",), "q11": ("value",),
                  "q11_spec": ("value",), "q15": ("total_revenue",),
                  "q17": ("avg_yearly",), "q14": ("promo_revenue",),
                  "q22": ("totacctbal",)}


def later_query(name: str, scale: float):
    """The port's query function of a later query: tpch.QUERIES' text,
    q18 also at TPC-H's validation bound 300 and q11 also at TPC-H's
    fraction 0.0001 / SF."""
    import functools
    from spark_rapids_tpu_torch import tpch
    if name == "q18_300":
        return functools.partial(tpch.q18, bound=300.0)
    if name == "q11_spec":
        return functools.partial(tpch.q11, fraction=0.0001 / scale)
    if name == "q20_us":
        return functools.partial(tpch.q20, nation="UNITED STATES")
    return tpch.QUERIES[name]


def _pk(hb, name) -> None:
    keys = _col(hb, name).data
    check(np.array_equal(keys, np.arange(len(keys))),
          f"{name} is not 0..n-1: the numpy joins index by it")


def _code(c, value: str) -> int:
    """A string's code in a column's dictionary, -1 if it is absent."""
    hits = np.flatnonzero(c.dictionary == value)
    return int(hits[0]) if len(hits) else -1


def _names(c) -> np.ndarray:
    """A string column's values, per row."""
    return c.dictionary[c.data]


def _year(days: np.ndarray) -> np.ndarray:
    return days.astype("datetime64[D]").astype("datetime64[Y]").astype(
        np.int64) + 1970


def _double(unscaled: np.ndarray, scale: int = 2) -> np.ndarray:
    return unscaled.astype(np.float64) / float(10 ** scale)


def _between(values, lo: pydt.date, hi: pydt.date, closed: bool = False):
    top = values <= _days(hi) if closed else values < _days(hi)
    return (values >= _days(lo)) & top


def _revenue(li, rows):
    """extendedprice x (1 - discount) at scale 4, exact."""
    return _col(li, "l_extendedprice").data[rows] * \
        (100 - _col(li, "l_discount").data[rows])


def expected_q4(t):
    orders, li = t["orders"], t["lineitem"]
    _pk(orders, "o_orderkey")
    late = np.zeros(orders.num_rows, bool)
    late[_col(li, "l_orderkey").data[_col(li, "l_commitdate").data <
                                     _col(li, "l_receiptdate").data]] = True
    keep = _between(_col(orders, "o_orderdate").data, pydt.date(1993, 7, 1),
                    pydt.date(1993, 10, 1)) & late
    prio = _col(orders, "o_orderpriority")
    n = np.bincount(prio.data[keep], minlength=len(prio.dictionary))
    used = np.flatnonzero(n)
    return {"o_orderpriority": [str(prio.dictionary[i]) for i in used],
            "order_count": n[used].tolist()}


def expected_q5(t):
    region, nation, cust, supp, orders, li = (t[n] for n in (
        "region", "nation", "customer", "supplier", "orders", "lineitem"))
    for hb, key in ((nation, "n_nationkey"), (cust, "c_custkey"),
                    (supp, "s_suppkey"), (orders, "o_orderkey")):
        _pk(hb, key)
    asia = _col(region, "r_regionkey").data[
        _names(_col(region, "r_name")) == "ASIA"]
    in_asia = np.isin(_col(nation, "n_regionkey").data, asia)
    o = _col(li, "l_orderkey").data
    cn = _col(cust, "c_nationkey").data[_col(orders, "o_custkey").data[o]]
    sn = _col(supp, "s_nationkey").data[_col(li, "l_suppkey").data]
    rows = np.flatnonzero(
        _between(_col(orders, "o_orderdate").data[o], pydt.date(1994, 1, 1),
                 pydt.date(1995, 1, 1)) & in_asia[cn] & (sn == cn))
    order, gnation, starts = _groups(cn[rows])
    sums = np.add.reduceat(_revenue(li, rows)[order], starts)
    rank = np.argsort(-sums, kind="stable")
    names = _names(_col(nation, "n_name"))
    return {"n_name": [str(names[k]) for k in gnation[rank]],
            "revenue": sums[rank].tolist()}


def expected_q7(t):
    nation, supp, orders, cust, li = (t[n] for n in (
        "nation", "supplier", "orders", "customer", "lineitem"))
    for hb, key in ((nation, "n_nationkey"), (cust, "c_custkey"),
                    (supp, "s_suppkey"), (orders, "o_orderkey")):
        _pk(hb, key)
    name = _col(nation, "n_name")
    both = np.isin(_names(name), ["FRANCE", "GERMANY"])
    ship = _col(li, "l_shipdate").data
    rows = np.flatnonzero(_between(ship, pydt.date(1995, 1, 1),
                                   pydt.date(1996, 12, 31), closed=True))
    sn = _col(supp, "s_nationkey").data[_col(li, "l_suppkey").data[rows]]
    cn = _col(cust, "c_nationkey").data[_col(orders, "o_custkey").data[
        _col(li, "l_orderkey").data[rows]]]
    keep = both[sn] & both[cn] & (name.data[sn] != name.data[cn])
    rows, sn, cn = rows[keep], sn[keep], cn[keep]
    year = _year(ship[rows])
    # the sorted dictionary's codes order the names
    key = (name.data[sn].astype(np.int64) * 64 + name.data[cn]) * 10_000 + \
        year
    order, gkeys, starts = _groups(key)
    return {"supp_nation": [str(name.dictionary[k // 640_000])
                            for k in gkeys],
            "cust_nation": [str(name.dictionary[k // 10_000 % 64])
                            for k in gkeys],
            "l_year": (gkeys % 10_000).tolist(),
            "revenue": np.add.reduceat(_revenue(li, rows)[order],
                                       starts).tolist()}


def expected_q8(t):
    part, supp, orders, cust, nation, region, li = (t[n] for n in (
        "part", "supplier", "orders", "customer", "nation", "region",
        "lineitem"))
    for hb, key in ((part, "p_partkey"), (nation, "n_nationkey"),
                    (cust, "c_custkey"), (supp, "s_suppkey"),
                    (orders, "o_orderkey")):
        _pk(hb, key)
    steel = _names(_col(part, "p_type")) == "ECONOMY ANODIZED STEEL"
    odate = _col(orders, "o_orderdate").data
    in_time = _between(odate, pydt.date(1995, 1, 1), pydt.date(1996, 12, 31),
                       closed=True)
    america = _col(region, "r_regionkey").data[
        _names(_col(region, "r_name")) == "AMERICA"]
    in_america = np.isin(_col(nation, "n_regionkey").data, america)
    o = _col(li, "l_orderkey").data
    rows = np.flatnonzero(
        steel[_col(li, "l_partkey").data] & in_time[o] &
        in_america[_col(cust, "c_nationkey").data[
            _col(orders, "o_custkey").data[o]]])
    brazil = _names(_col(nation, "n_name"))[_col(supp, "s_nationkey").data[
        _col(li, "l_suppkey").data[rows]]] == "BRAZIL"
    volume = _double(_col(li, "l_extendedprice").data[rows]) * \
        (1.0 - _double(_col(li, "l_discount").data[rows]))
    order, years, starts = _groups(_year(odate[o[rows]]))
    total = np.add.reduceat(volume[order], starts)
    braz = np.add.reduceat(np.where(brazil, volume, 0.0)[order], starts)
    return {"o_year": years.tolist(), "mkt_share": (braz / total).tolist()}


def expected_q10(t):
    cust, orders, nation, li = (t[n] for n in (
        "customer", "orders", "nation", "lineitem"))
    for hb, key in ((nation, "n_nationkey"), (cust, "c_custkey"),
                    (orders, "o_orderkey")):
        _pk(hb, key)
    flag = _col(li, "l_returnflag")
    o = _col(li, "l_orderkey").data
    rows = np.flatnonzero(
        (flag.data == _code(flag, "R")) &
        _between(_col(orders, "o_orderdate").data[o],
                 pydt.date(1993, 10, 1), pydt.date(1994, 1, 1)))
    order, ckeys, starts = _groups(_col(orders, "o_custkey").data[o[rows]])
    sums = np.add.reduceat(_revenue(li, rows)[order], starts)
    top = np.lexsort((ckeys, -sums))[:20]
    names = _names(_col(nation, "n_name"))
    return {"c_custkey": ckeys[top].tolist(),
            "n_name": [str(names[k]) for k in _col(
                cust, "c_nationkey").data[ckeys[top]]],
            "revenue": sums[top].tolist()}


def expected_q11(t, fraction: float = 0.0001):
    nation, supp, ps = t["nation"], t["supplier"], t["partsupp"]
    for hb, key in ((nation, "n_nationkey"), (supp, "s_suppkey")):
        _pk(hb, key)
    germany = _names(_col(nation, "n_name")) == "GERMANY"
    rows = np.flatnonzero(germany[_col(supp, "s_nationkey").data[
        _col(ps, "ps_suppkey").data]])
    value = _double(_col(ps, "ps_supplycost").data[rows]) * \
        _col(ps, "ps_availqty").data[rows].astype(np.float64)
    order, parts, starts = _groups(_col(ps, "ps_partkey").data[rows])
    sums = np.add.reduceat(value[order], starts) if len(rows) \
        else np.zeros(0)
    keep = np.flatnonzero(sums > value.sum() * fraction)
    rank = keep[np.lexsort((parts[keep], -sums[keep]))]
    return {"ps_partkey": parts[rank].tolist(), "value": sums[rank].tolist()}


def expected_q12(t):
    orders, li = t["orders"], t["lineitem"]
    _pk(orders, "o_orderkey")
    mode = _col(li, "l_shipmode")
    commit = _col(li, "l_commitdate").data
    receipt = _col(li, "l_receiptdate").data
    rows = np.flatnonzero(
        np.isin(_names(mode), ["MAIL", "SHIP"]) & (commit < receipt) &
        (_col(li, "l_shipdate").data < commit) &
        _between(receipt, pydt.date(1994, 1, 1), pydt.date(1995, 1, 1)))
    prio = _col(orders, "o_orderpriority")
    high = np.isin(_names(prio)[_col(li, "l_orderkey").data[rows]],
                   ["1-URGENT", "2-HIGH"])
    order, modes, starts = _groups(mode.data[rows])
    n_high = np.add.reduceat(high[order].astype(np.int64), starts)
    return {"l_shipmode": [str(mode.dictionary[m]) for m in modes],
            "high_line_count": n_high.tolist(),
            "low_line_count": (np.diff(np.r_[starts, len(rows)]) -
                               n_high).tolist()}


def expected_q15(t):
    supp, li = t["supplier"], t["lineitem"]
    _pk(supp, "s_suppkey")
    rows = np.flatnonzero(_between(_col(li, "l_shipdate").data,
                                   pydt.date(1996, 1, 1),
                                   pydt.date(1996, 4, 1)))
    revenue = _double(_col(li, "l_extendedprice").data[rows]) * \
        (1.0 - _double(_col(li, "l_discount").data[rows]))
    order, keys, starts = _groups(_col(li, "l_suppkey").data[rows])
    sums = np.add.reduceat(revenue[order], starts)
    best = np.flatnonzero(sums == sums.max())
    out = {"s_suppkey": keys[best].tolist()}
    for name in ("s_name", "s_address", "s_phone"):
        out[name] = [str(v) for v in _names(_col(supp, name))[keys[best]]]
    out["total_revenue"] = sums[best].tolist()
    return out


def expected_q17(t):
    part, li = t["part"], t["lineitem"]
    _pk(part, "p_partkey")
    lpart = _col(li, "l_partkey").data
    qty = _col(li, "l_quantity").data
    n = np.bincount(lpart, minlength=part.num_rows)
    total = np.bincount(lpart, weights=qty, minlength=part.num_rows) \
        .astype(np.int64)           # at most 50.00 a row: exact in f64
    # avg(decimal(12, 2)) is decimal(16, 6), HALF_UP; then a DOUBLE
    avg = (total * 10 ** 4 + n // 2) // np.maximum(n, 1)
    limit = 0.2 * _double(avg, 6)
    promo = _names(_col(part, "p_type")) == "PROMO BURNISHED NICKEL"
    rows = promo[lpart] & (_double(qty) < limit[lpart])
    s = int(_col(li, "l_extendedprice").data[rows].sum())
    return {"avg_yearly": [float(np.float64(s) / 100.0 / 7.0)]}


def expected_q18(t, bound: float = 7200.0):
    """q18 in numpy, and (as q3's) every row tied with the 100th on
    (totalprice, orderdate)."""
    orders, cust, li = t["orders"], t["customer"], t["lineitem"]
    for hb, key in ((orders, "o_orderkey"), (cust, "c_custkey")):
        _pk(hb, key)
    qty = np.bincount(_col(li, "l_orderkey").data,
                      weights=_col(li, "l_quantity").data,
                      minlength=orders.num_rows).astype(np.int64)
    big = np.flatnonzero(_double(qty) > bound)
    price = _col(orders, "o_totalprice").data[big]
    date = _col(orders, "o_orderdate").data[big]
    cols = {"c_custkey": _col(orders, "o_custkey").data[big],
            "o_orderkey": big, "o_orderdate": date, "o_totalprice": price,
            "total_qty": qty[big]}
    rank = np.lexsort((date, -price))
    top = {n: v[rank[:100]].tolist() for n, v in cols.items()}
    tied = []
    if len(rank) >= 100:
        last = rank[99]
        tie = (price == price[last]) & (date == date[last])
        tied = sorted(zip(*(v[tie].tolist() for v in cols.values())))
    return top, tied


def expected_q19(t):
    part, li = t["part"], t["lineitem"]
    _pk(part, "p_partkey")
    flag = _col(li, "l_returnflag")
    rows = np.flatnonzero(
        np.isin(_names(_col(li, "l_shipmode")), ["AIR", "REG AIR"]) &
        (flag.data == _code(flag, "N")))
    p = _col(li, "l_partkey").data[rows]
    brand = _names(_col(part, "p_brand"))[p]
    box = _names(_col(part, "p_container"))[p]
    size = _col(part, "p_size").data[p]
    qty = _col(li, "l_quantity").data[rows]

    def branch(b, boxes, lo, hi, most):
        return (brand == b) & np.isin(box, boxes) & (qty >= lo * 100) & \
            (qty <= hi * 100) & (size <= most)
    keep = branch("Brand#12", ["SM CASE", "SM BOX"], 1, 11, 5) | \
        branch("Brand#23", ["MED BAG", "MED BOX"], 10, 20, 10) | \
        branch("Brand#34", ["LG CASE", "LG BOX", "JUMBO PKG"], 20, 30, 15)
    check(keep.any(), "q19 keeps no row: its numpy result would be null")
    return {"revenue": [int(_revenue(li, rows[keep]).sum())]}


def _entries(c, test) -> np.ndarray:
    """A per-row bool of a string column from a test over its
    dictionary's entries (np.char)."""
    return test(c.dictionary)[c.data]


def _in_region(t, region: str) -> np.ndarray:
    """Per nation key: the nation lies in `region`."""
    keys = _col(t["region"], "r_regionkey").data[
        _names(_col(t["region"], "r_name")) == region]
    return np.isin(_col(t["nation"], "n_regionkey").data, keys)


def _strs(c, rows) -> list:
    return [str(v) for v in c.dictionary[c.data[rows]]]


def expected_q2(t):
    part, supp, ps, nation = (t[n] for n in (
        "part", "supplier", "partsupp", "nation"))
    for hb, key in ((part, "p_partkey"), (supp, "s_suppkey"),
                    (nation, "n_nationkey")):
        _pk(hb, key)
    brass = _entries(_col(part, "p_type"),
                     lambda d: np.char.endswith(d, "BRASS")) & \
        (_col(part, "p_size").data == 15)
    snation = _col(supp, "s_nationkey").data
    pk, sk = _col(ps, "ps_partkey").data, _col(ps, "ps_suppkey").data
    rows = np.flatnonzero(brass[pk] & _in_region(t, "EUROPE")[snation[sk]])
    cost = _col(ps, "ps_supplycost").data[rows]
    least = np.full(part.num_rows, np.iinfo(np.int64).max)
    np.minimum.at(least, pk[rows], cost)
    rows = rows[cost == least[pk[rows]]]
    p, s_ = pk[rows], sk[rows]
    acct = _col(supp, "s_acctbal").data[s_]
    nname, sname = _col(nation, "n_name"), _col(supp, "s_name")
    # the sorted dictionaries' codes order the names
    top = np.lexsort((p, sname.data[s_], nname.data[snation[s_]],
                      -acct))[:100]
    p, s_ = p[top], s_[top]
    return {"s_acctbal": acct[top].tolist(), "s_name": _strs(sname, s_),
            "n_name": _strs(nname, snation[s_]), "p_partkey": p.tolist(),
            "p_mfgr": _strs(_col(part, "p_mfgr"), p),
            "s_address": _strs(_col(supp, "s_address"), s_),
            "s_phone": _strs(_col(supp, "s_phone"), s_)}


def _ps_rows(t, parts, supps):
    """partsupp's row of each (part, supplier) pair, and whether it has
    one, by argsort and searchsorted over the packed pair."""
    ps, n_supp = t["partsupp"], t["supplier"].num_rows
    packed = _col(ps, "ps_partkey").data * n_supp + \
        _col(ps, "ps_suppkey").data
    order = np.argsort(packed, kind="stable")
    key = parts * n_supp + supps
    at = np.clip(np.searchsorted(packed[order], key), 0, len(order) - 1)
    return order[at], packed[order][at] == key


def expected_q9(t):
    part, supp, orders, nation, li = (t[n] for n in (
        "part", "supplier", "orders", "nation", "lineitem"))
    for hb, key in ((part, "p_partkey"), (supp, "s_suppkey"),
                    (orders, "o_orderkey"), (nation, "n_nationkey")):
        _pk(hb, key)
    green = _entries(_col(part, "p_name"),
                     lambda d: np.char.find(d, "green") >= 0)
    lp, ls = _col(li, "l_partkey").data, _col(li, "l_suppkey").data
    rows = np.flatnonzero(green[lp])
    ps_row, hit = _ps_rows(t, lp[rows], ls[rows])
    rows, ps_row = rows[hit], ps_row[hit]
    amount = _revenue(li, rows) - \
        _col(t["partsupp"], "ps_supplycost").data[ps_row] * \
        _col(li, "l_quantity").data[rows]
    nname = _col(nation, "n_name")
    code = nname.data[_col(supp, "s_nationkey").data[ls[rows]]]
    year = _year(_col(orders, "o_orderdate").data[
        _col(li, "l_orderkey").data[rows]])
    order, keys, starts = _groups(code.astype(np.int64) * 10_000 + year)
    sums = np.add.reduceat(amount[order], starts)
    rank = np.lexsort((-(keys % 10_000), keys // 10_000))
    return {"n_name": [str(nname.dictionary[k]) for k in
                       keys[rank] // 10_000],
            "o_year": (keys[rank] % 10_000).tolist(),
            "sum_profit": sums[rank].tolist()}


def expected_q13(t):
    orders, cust = t["orders"], t["customer"]
    _pk(cust, "c_custkey")
    keep = ~_entries(_col(orders, "o_comment"), lambda d: (
        np.char.find(d, "special") >= 0) & (np.char.find(d, "requests") >= 0))
    per_cust = np.bincount(_col(orders, "o_custkey").data[keep],
                           minlength=cust.num_rows)
    hist = np.bincount(per_cust)
    counts = np.flatnonzero(hist)
    rank = np.lexsort((-counts, -hist[counts]))
    return {"c_count": counts[rank].tolist(),
            "custdist": hist[counts][rank].tolist()}


def expected_q14(t):
    part, li = t["part"], t["lineitem"]
    _pk(part, "p_partkey")
    rows = np.flatnonzero(_between(_col(li, "l_shipdate").data,
                                   pydt.date(1995, 9, 1),
                                   pydt.date(1995, 10, 1)))
    promo = _entries(_col(part, "p_type"), lambda d: np.char.startswith(
        d, "PROMO"))[_col(li, "l_partkey").data[rows]]
    revenue = _revenue(li, rows)
    # both sums are below 2^53: their DOUBLE casts are one rounding each
    return {"promo_revenue": [100.0 * (float(revenue[promo].sum()) / 1e4) /
                              (float(revenue.sum()) / 1e4)]}


def expected_q16(t):
    supp, part, ps = t["supplier"], t["part"], t["partsupp"]
    for hb, key in ((part, "p_partkey"), (supp, "s_suppkey")):
        _pk(hb, key)
    bad = _entries(_col(supp, "s_comment"), lambda d: (
        np.char.find(d, "Customer") >= 0) &
        (np.char.find(d, "Complaints") >= 0))
    brand, ptype = _col(part, "p_brand"), _col(part, "p_type")
    size = _col(part, "p_size").data
    keep = (_names(brand) != "Brand#45") & ~_entries(
        ptype, lambda d: np.char.startswith(d, "MEDIUM POLISHED")) & \
        np.isin(size, [49, 14, 23, 45, 19, 3, 36, 9])
    pk, sk = _col(ps, "ps_partkey").data, _col(ps, "ps_suppkey").data
    rows = np.flatnonzero(~bad[sk] & keep[pk])
    p = pk[rows]
    n_type, n_supp = len(ptype.dictionary), supp.num_rows
    group = (brand.data[p].astype(np.int64) * n_type + ptype.data[p]) * 64 \
        + size[p]
    # COUNT(DISTINCT supplier): unique (group, supplier) pairs per group
    pairs = np.unique(group * n_supp + sk[rows])
    keys, counts = np.unique(pairs // n_supp, return_counts=True)
    b, ty, sz = keys // 64 // n_type, keys // 64 % n_type, keys % 64
    rank = np.lexsort((sz, ty, b, -counts))
    return {"p_brand": [str(v) for v in brand.dictionary[b[rank]]],
            "p_type": [str(v) for v in ptype.dictionary[ty[rank]]],
            "p_size": sz[rank].tolist(), "supplier_cnt": counts[rank].tolist()}


def expected_q20(t, nation: str = "CANADA"):
    part, supp, ps, li = (t[n] for n in (
        "part", "supplier", "partsupp", "lineitem"))
    for hb, key in ((part, "p_partkey"), (supp, "s_suppkey"),
                    (t["nation"], "n_nationkey")):
        _pk(hb, key)
    green = _entries(_col(part, "p_name"),
                     lambda d: np.char.startswith(d, "green"))
    rows = np.flatnonzero(_between(_col(li, "l_shipdate").data,
                                   pydt.date(1994, 1, 1),
                                   pydt.date(1995, 1, 1)))
    n_supp = supp.num_rows
    order, keys, starts = _groups(
        _col(li, "l_partkey").data[rows] * n_supp +
        _col(li, "l_suppkey").data[rows])
    half = 0.5 * _double(np.add.reduceat(
        _col(li, "l_quantity").data[rows][order], starts))
    pk, sk = _col(ps, "ps_partkey").data, _col(ps, "ps_suppkey").data
    at = np.clip(np.searchsorted(keys, pk * n_supp + sk), 0, len(keys) - 1)
    ok = (keys[at] == pk * n_supp + sk) & green[pk] & \
        (_col(ps, "ps_availqty").data.astype(np.float64) > half[at])
    home = _names(_col(t["nation"], "n_name")) == nation
    chosen = np.flatnonzero(home[_col(supp, "s_nationkey").data] &
                            np.isin(np.arange(n_supp), sk[ok]))
    name = _col(supp, "s_name")
    chosen = chosen[np.argsort(name.data[chosen], kind="stable")]
    return {"s_name": _strs(name, chosen),
            "s_address": _strs(_col(supp, "s_address"), chosen)}


def sorted_distinct(values: np.ndarray) -> np.ndarray:
    """np.unique(values) by a sort: numpy 2.3's np.unique hashes integer
    lanes, which takes minutes over every lineitem row."""
    v = np.sort(values)
    return v[np.r_[True, v[1:] != v[:-1]]] if len(v) else v


def distinct_suppliers(li, n_orders: int, n_supp: int, mask=None):
    """Per order, its distinct suppliers: the distinct values of the
    packed (order, supplier) lane of the rows in `mask`."""
    o, s_ = _col(li, "l_orderkey").data, _col(li, "l_suppkey").data
    if mask is not None:
        o, s_ = o[mask], s_[mask]
    pairs = sorted_distinct(o * n_supp + s_)
    return np.bincount(pairs // n_supp, minlength=n_orders)


def q21_late(li) -> np.ndarray:
    return _col(li, "l_receiptdate").data > _col(li, "l_commitdate").data


def q21_distinct(t, late: bool) -> np.ndarray:
    """Each order's distinct suppliers over all its lineitems, or over
    its late ones."""
    li = t["lineitem"]
    return distinct_suppliers(li, t["orders"].num_rows,
                              t["supplier"].num_rows,
                              q21_late(li) if late else None)


def expected_q21(t, nation: str = "SAUDI ARABIA", n_all=None,
                 n_late=None):
    """q21's result; `n_all` and `n_late` are `q21_distinct(t, False)`
    and `q21_distinct(t, True)` where they were computed apart."""
    supp, orders, li = t["supplier"], t["orders"], t["lineitem"]
    for hb, key in ((supp, "s_suppkey"), (orders, "o_orderkey"),
                    (t["nation"], "n_nationkey")):
        _pk(hb, key)
    n_supp = supp.num_rows
    late = q21_late(li)
    if n_all is None:
        n_all = q21_distinct(t, late=False)
    if n_late is None:
        n_late = q21_distinct(t, late=True)
    status = _col(orders, "o_orderstatus")
    failed = status.data == _code(status, "F")
    home = (_names(_col(t["nation"], "n_name")) == nation)[
        _col(supp, "s_nationkey").data]
    o, s_ = _col(li, "l_orderkey").data, _col(li, "l_suppkey").data
    rows = np.flatnonzero(late & home[s_] & failed[o] & (n_all[o] > 1) &
                          (n_late[o] == 1))
    waits = np.bincount(s_[rows], minlength=n_supp)
    sups = np.flatnonzero(waits)
    name = _col(supp, "s_name")
    top = sups[np.lexsort((name.data[sups], -waits[sups]))][:100]
    return {"s_name": _strs(name, top), "numwait": waits[top].tolist()}


def expected_q22(t):
    cust, orders = t["customer"], t["orders"]
    _pk(cust, "c_custkey")
    phone = _col(cust, "c_phone")
    code = phone.dictionary.astype("<U2")[phone.data]
    chosen = np.isin(code, ["13", "31", "23", "29", "30", "18", "17"])
    bal = _double(_col(cust, "c_acctbal").data)
    avg = bal[chosen & (bal > 0.0)].mean()
    ordered = np.zeros(cust.num_rows, bool)
    ordered[_col(orders, "o_custkey").data] = True
    rows = np.flatnonzero(chosen & (bal > avg) & ~ordered)
    order, codes, starts = _groups(code[rows])
    return {"cntrycode": [str(c) for c in codes],
            "numcust": np.diff(np.r_[starts, len(rows)]).tolist(),
            "totacctbal": np.add.reduceat(bal[rows][order], starts).tolist()}


def expected_later(name: str, tables, scale: float):
    if name == "q18_300":
        return expected_q18(tables, 300.0)
    if name == "q11_spec":
        return expected_q11(tables, 0.0001 / scale)
    if name == "q20_us":
        return expected_q20(tables, "UNITED STATES")
    return globals()[f"expected_{name}"](tables)


def check_later(name: str, lanes, want) -> None:
    """Equal to the numpy result: DOUBLE columns within rtol 1e-12, the
    rest exactly; q18's top 100 as q3's top 10."""
    if name.startswith("q18"):
        check_top(name, lanes, want)
        return
    doubles = DOUBLE_COLUMNS.get(name, ())
    check(list(lanes) == list(want), f"{name} has columns {list(lanes)}, "
          f"not {list(want)}")
    for k in want:
        got, exp = lanes[k], want[k]
        same = got == exp if k not in doubles else len(got) == len(exp) \
            and np.allclose(got, exp, rtol=1e-12, atol=0.0)
        at = next((i for i, (a, b) in enumerate(zip(got, exp)) if a != b),
                  min(len(got), len(exp)))
        check(same, f"{name}.{k} differs from the numpy reference "
              f"({len(got)} rows, numpy {len(exp)}; from row {at}: "
              f"{got[at:at + 5]} against {exp[at:at + 5]})")


def lanes_of(hb):
    """Column -> python list of its storage values (strings decoded,
    decimals as unscaled ints, a high word included), failing on
    nulls."""
    out = {}
    for name, c in zip(hb.names, hb.columns):
        check(c.validity is None or c.validity.all(), f"{name} has nulls")
        if c.dictionary is not None:
            out[name] = [str(v) for v in c.dictionary[c.data]]
        elif c.hi is not None:
            out[name] = c.unscaled().tolist()
        else:
            out[name] = c.data.tolist()
    return out


def data_phase(scale: float, seed: int, reference: bool = True):
    """Every TPC-H table at SF `scale`; with `reference`, also the numpy
    results (`numpy_results`).  -> (the tables, the numpy results,
    {later query: (its scale, its tables)})."""
    from spark_rapids_tpu_torch import tpch
    t0 = time.perf_counter()
    tables = tpch.gen_tables(scale, seed)
    log(f"[data] gen_tables(scale={scale}): " + ", ".join(
        f"{n} {hb.num_rows} rows" for n, hb in tables.items()) +
        f" in {time.perf_counter() - t0:.1f} s")
    if not reference:
        return tables, None, {}
    later = {q: (scale, tables) for q in LATER_QUERIES}
    return tables, numpy_results(tables, scale), later


def numpy_results(tables, scale: float) -> dict:
    """The numpy result of every query, one forked process a query, the
    slowest first: q21's two distinct counts over lineitem, each in a
    process of its own (the one over every row also serves the strings
    phase), whose counts q21's result then takes here.  They finish
    before the card is used: run beside the kernel phases, they cost the
    profiler some of its records of the card's launches.  The children
    read the parent's tables and return only the results."""
    global _WANT_TABLES
    t0 = time.perf_counter()
    import chip_smoke_joins as J
    import chip_smoke_nested as N
    import chip_smoke_structs as ST
    names = [Q21_DISTINCT, Q21_LATE_DISTINCT] + list(ST.WANTS) + list(
        N.WANTS) + list(
        SCALAR_WANTS) + list(J.WANTS) + list(STRING_WANTS) + [
        n for n in FIRST_PATHS + LATER_QUERIES if n != "q21"]
    workers = min(len(names), os.cpu_count() or 1)
    _WANT_TABLES = (tables, scale)
    with concurrent.futures.ProcessPoolExecutor(
            max_workers=workers,
            mp_context=multiprocessing.get_context("fork")) as pool:
        done = dict(zip(names, pool.map(_want, names)))
    _WANT_TABLES = None
    want = {n: r for n, (r, _s) in done.items()}
    want["q21"] = expected_q21(tables, n_all=want[Q21_DISTINCT],
                               n_late=want.pop(Q21_LATE_DISTINCT))
    slowest = sorted(done, key=lambda n: -done[n][1])[:3]
    log(f"[data] {len(names)} numpy results in {workers} processes, "
        f"then q21's: {time.perf_counter() - t0:.1f} s; slowest " +
        ", ".join(f"{n} {done[n][1]:.1f} s" for n in slowest))
    return want


#: the first seven paths (each result from lineitem, or from the tables)
FIRST_PATHS = ("q1", "q6", "minmax", "q3", "m2m", "outer", "semi")
#: the scalars phase's numpy results over lineitem (scalars_q1 in three
#: parts, a process each)
SCALAR_WANTS = ("moments_q1", "scalars_q1:0/3", "scalars_q1:1/3",
                "scalars_q1:2/3")
#: the strings phase's numpy results over the TPC-H tables
STRING_WANTS = ("strings_groupby",)
#: each order's distinct suppliers (q21's and the strings phase's), and
#: over its late lineitems (q21's)
Q21_DISTINCT = "q21 distinct suppliers"
Q21_LATE_DISTINCT = "q21 late distinct suppliers"
_WANT_TABLES = None


def _want(name: str):
    """The numpy result of one query over the tables numpy_results set,
    and the seconds it took."""
    tables, scale = _WANT_TABLES
    t0 = time.perf_counter()
    if name in (Q21_DISTINCT, Q21_LATE_DISTINCT):
        got = q21_distinct(tables, late=name == Q21_LATE_DISTINCT)
    elif name in SCALAR_WANTS:
        import chip_smoke_scalars as S
        got = S.expected(name, tables)
    elif name in STRING_WANTS:
        import chip_smoke_strings as S
        got = S.expected(name, tables)
    elif name.startswith(("bloom_", "ck_", "hash_", "tz_")):
        import chip_smoke_joins as J
        got = J.expected(name, tables)
    elif name.startswith("nested "):
        import chip_smoke_nested as N
        got = N.expected(name, tables)
    elif name.startswith("structs "):
        import chip_smoke_structs as ST
        got = ST.expected(name, tables)
    elif name in ("q1", "q6", "minmax"):
        got = globals()[f"expected_{name}"](tables["lineitem"])
    elif name in FIRST_PATHS:
        got = globals()[f"expected_{name}"](tables)
    else:
        got = expected_later(name, tables, scale)
    return got, time.perf_counter() - t0


def upload_rate(dev) -> float:
    """GB/s of host-to-device copies from pageable memory, as the scan's
    upload makes them: 16 copies of a 32 MiB array (one 4M-row int64
    column of a batch)."""
    host = np.arange(4 << 20, dtype=np.int64)
    torch.from_numpy(host).to(dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(16):
        torch.from_numpy(host).to(dev)
    torch.cuda.synchronize()
    return 16 * host.nbytes / (time.perf_counter() - t0) / 1e9


def run_query(s, build, tables):
    """One collect through the session's plan, with its ExecContext
    (the out-of-core counters and the budget's spill metrics)."""
    from spark_rapids_tpu_torch.exec.plan import ExecContext
    q = build(s, tables).physical()
    ctx = ExecContext(q.conf, q.device)
    return q.collect(ctx), ctx


def ooc_counts(ctx) -> str:
    m = ctx.metrics
    return (f"{m.get('join_subpartition_fallbacks', 0)} sub-partitioned "
            f"joins (k {m.get('ooc.join_partitions', 0)} in all, "
            f"{m.get('ooc.join_passes', 0)} bucket joins), "
            f"{m.get('ooc.agg_elections', 0)} out-of-core aggregations "
            f"({m.get('ooc.agg_passes', 0)} buckets)")


def path_phase(tables, want, later, scale: float):
    from spark_rapids_tpu_torch import tpch
    from spark_rapids_tpu_torch.ops.hopper import LAUNCHES, \
        reset_launch_counts
    from spark_rapids_tpu_torch.session import TpuSession
    s = TpuSession()
    check(s.device.type == "cuda", "TpuSession() is not on cuda")
    # name -> (query function, its tables, its scale)
    queries = {name: (build, tables, scale) for name, build in (
        ("q1", tpch.q1), ("q6", tpch.q6), ("minmax", minmax_query),
        ("q3", tpch.q3), *tpch.JOIN_QUERIES.items())}
    for name, (sc, tabs) in later.items():
        queries[name] = (later_query(name, sc), tabs, sc)
    cold, launches, warm = {}, {}, {}
    for name, (build, tabs, sc) in queries.items():
        reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        got, ctx = run_query(s, build, tabs)
        torch.cuda.synchronize()
        cold[name] = (time.perf_counter() - t0) * 1e3
        launches[name] = dict(LAUNCHES)
        lanes = lanes_of(got)
        log(f"[path] {name} (SF{sc:g}) peak device memory "
            f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB; "
            f"{ooc_counts(ctx)}")
        if name == "q3":
            check_top(name, lanes, want[name])
        elif name in later:
            check_later(name, lanes, want[name])
        else:
            check(lanes == want[name], f"{name} differs from the numpy "
                  f"reference:\n{lanes}\n{want[name]}")
        if name in STRING_QUERIES and name != "q20":
            check(got.num_rows > 0, f"{name} returned no row at SF{sc:g}")
        if name in SUB_PARTITIONED:
            check(ctx.metrics.get("join_subpartition_fallbacks", 0) > 0,
                  f"{name} sub-partitioned no join at SF{sc:g}")
        log(f"[path] {name} (SF{sc:g}): {got.num_rows} rows equal the numpy "
            f"reference; kernel launches {launches[name]}")
        for k in PATH_KERNELS[name]:
            check(launches[name][k] > 0,
                  f"kernel {k} was not launched on the {name} path")
    log(f"[path] launches per query: {launches}")
    for name, (build, tabs, sc) in queries.items():
        runs = []
        for _ in range(3):
            t0 = time.perf_counter()
            build(s, tabs).collect()
            torch.cuda.synchronize()
            runs.append((time.perf_counter() - t0) * 1e3)
        warm[name] = statistics.median(runs)
        log(f"[path] {name} wall: cold {cold[name]:.1f} ms, warm median "
            f"{warm[name]:.1f} ms (SF{sc:g}, lineitem rows "
            f"{tabs['lineitem'].num_rows})")
    return launches, cold, warm


#: the out-of-core phase: a device budget and a host spill store small
#: enough that the sub-partitioned joins' buckets and the adaptive
#: stages spill to the host and on to disk, and that q18's group-by
#: (over 15,000,000 orders at SF10) runs out of core.  q18 runs at
#: TPC-H's validation bound 300 (the reference's 7200 keeps no order)
OOC_CONF = {"spark.rapids.tpu.memory.tpu.budgetBytes": str(1 << 30),
            "spark.rapids.tpu.memory.host.spillStorageSize": str(1 << 29)}
OOC_QUERIES = ("q4", "q18_300", "q21")


def ooc_phase(tables, want, scale: float, cold, warm) -> None:
    """Each query once (cold) under OOC_CONF, its wall beside the same
    query's cold and warm unbudgeted walls of the path phase."""
    from spark_rapids_tpu_torch.session import TpuSession
    s = TpuSession(OOC_CONF)
    totals = {"spilled_batches": 0, "disk_batches": 0}
    for name in OOC_QUERIES:
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        got, ctx = run_query(s, later_query(name, scale), tables)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        check_later(name, lanes_of(got), want[name])
        bm = ctx.budget.metrics
        for k in totals:
            totals[k] += bm[k]
        if name.startswith("q18"):
            check(ctx.metrics.get("ooc.agg_elections", 0) > 0,
                  f"{name}'s group-by did not run out of core")
        log(f"[ooc] {name} (SF{scale:g}) under a {ctx.budget.limit}-byte "
            f"budget and a {ctx.budget.host_limit}-byte host store: "
            f"{got.num_rows} rows equal the numpy reference; cold wall "
            f"{wall:.1f} ms, {wall / cold[name]:.2f} x the unbudgeted cold "
            f"wall {cold[name]:.1f} ms (unbudgeted warm median "
            f"{warm[name]:.1f} ms); "
            f"{bm['spilled_batches']} batches ({bm['spilled_bytes']} bytes) "
            f"spilled to the host, {bm['disk_batches']} "
            f"({bm['disk_bytes']} bytes) on to disk, spill and disk "
            f"{bm['spill_ms']:.1f} ms; budget peak {bm['peak_bytes']} "
            f"bytes, device peak "
            f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB; "
            f"{ooc_counts(ctx)}")
    check(totals["spilled_batches"] > 0, "nothing spilled to the host")
    check(totals["disk_batches"] > 0, "nothing spilled to disk")


def _host_ms(fn, reps: int = 3) -> float:
    """Median host-clock ms of `fn` over `reps` runs, each ending in a
    device synchronize (for work with host steps: uploads, fetches)."""
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def dictionary_phase(dev, tables, later, want) -> None:
    """The dictionary work of the strings slice at the main path's sizes,
    each result held to numpy: p_name's and c_phone's byte tensors (the
    code points' upload and the device encoding), Contains over p_name
    (q9's), Substring over c_phone (q22's), and q21's COUNT(DISTINCT)
    supplier per order over its lineitem."""
    from spark_rapids_tpu_torch.columnar.device import to_device
    from spark_rapids_tpu_torch.ops import strings as S
    from spark_rapids_tpu_torch.ops.distinct import distinct_count_trace
    byte_tensors = {}
    for table, name in (("part", "p_name"), ("customer", "c_phone")):
        d = _col(tables[table], name).dictionary
        byte_tensors[name] = S.dict_byte_tensors(d, dev)
        offsets, bytes_ = byte_tensors[name]
        check(bytes(bytes_.cpu().numpy()) == "".join(d.tolist()).encode(
            "utf-8"), f"{name}'s UTF-8 bytes differ from Python's encoding")
        ms = _host_ms(lambda: S.dict_byte_tensors(d, dev))
        log(f"[dictionary] {name} byte tensors ({len(d)} entries, "
            f"{int(offsets[-1])} bytes): {ms:.2f} ms (host clock: the "
            "code points' upload and the device encoding)")
    d = _col(tables["part"], "p_name").dictionary
    offsets, bytes_ = byte_tensors["p_name"]
    mask = S.match_contains(offsets, bytes_, b"green")
    check(np.array_equal(mask.cpu().numpy(), np.char.find(d, "green") >= 0),
          "Contains(p_name, 'green') differs from np.char.find")
    ms = cuda_ms(lambda: S.match_contains(offsets, bytes_, b"green"))
    log(f"[dictionary] Contains over p_name: {ms:.4f} ms device "
        f"({int(mask.sum())} of {len(d)} entries)")
    d = _col(tables["customer"], "c_phone").dictionary
    tensors = byte_tensors["c_phone"]
    out, remap = S.transform_dict_device(d, "substr", (1, 2), dev,
                                         byte_tensors=tensors)
    prefixes = d.astype("<U2")
    check(np.array_equal(out, np.unique(prefixes)) and np.array_equal(
        out[remap.cpu().numpy()], prefixes), "Substring(c_phone, 1, 2) "
        "differs from numpy's two-character prefixes")
    ms = cuda_ms(lambda: S.transform_dict_device(
        d, "substr", (1, 2), dev, byte_tensors=tensors), reps=5, warmup=1)
    log(f"[dictionary] Substring(c_phone, 1, 2) over {len(d)} entries: "
        f"{ms:.4f} ms (events; its host fetch included) -> {len(out)} "
        "sorted unique entries")
    sc, t21 = later["q21"]
    li = t21["lineitem"].select(["l_orderkey", "l_suppkey"])
    db = to_device(li, device=dev)
    okey, skey = db.column(0), db.column(1)
    n_orders, n_supp = t21["orders"].num_rows, t21["supplier"].num_rows
    fn = distinct_count_trace(
        [(okey.dtype, True, okey.data.dtype)], db.capacity, db.capacity,
        pack_spec=[(0, n_orders + 1)], val_range=(0, n_supp - 1))
    live = db.row_mask()
    _keys, (cnt, _ok), groups = fn([okey.data], [okey.validity], skey, live)
    per_order = want[Q21_DISTINCT]
    check(np.array_equal(cnt[:int(groups)].cpu().numpy(),
                         per_order[per_order > 0]),
          "q21's distinct suppliers per order differ from np.unique")
    ms = cuda_ms(lambda: fn([okey.data], [okey.validity], skey, live),
                 reps=3, warmup=1)
    log(f"[dictionary] q21 COUNT(DISTINCT l_suppkey) by l_orderkey over "
        f"{li.num_rows} rows (SF{sc:g}, one packed sort lane): {ms:.2f} ms "
        "device (events)")


# device kernel name fragment -> the part it counts toward (first match)
PROFILE_PARTS = (
    ("HtoD", "upload (memcpy HtoD)"), ("DtoH", "fetch (memcpy DtoH)"),
    ("seg_sums_kernel", "seg_sums"), ("seg_reduce_kernel", "seg_reduce"),
    ("compact_order_kernel", "compaction_order"),
    ("compact_tail_kernel", "compaction_order"),
    ("layout_final_kernel", "build_table"),
    ("layout_slots_kernel", "build_table"),
    ("probe_first_kernel", "probe_first"),
    ("probe_counts_kernel", "probe_counts"),
    ("expand_pairs_kernel", "expand_pairs"))


def profile_query(name, build, tables):
    """Where one warm run spends its device time (torch.profiler over
    CUPTI): host->device upload copies, each kernel (its helper passes
    included), the other PyTorch ops, the result fetch; and the
    device-busy share of the wall."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from spark_rapids_tpu_torch.session import TpuSession
    s = TpuSession()
    build(s, tables).collect()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        build(s, tables).collect()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    parts = {part: 0.0 for _frag, part in PROFILE_PARTS}
    parts["other PyTorch kernels"] = 0.0
    names = []
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        us = e.self_device_time_total
        names.append((us, e.key, e.count))
        part = next((p for frag, p in PROFILE_PARTS if frag in e.key),
                    "other PyTorch kernels")
        parts[part] += us
    busy = sum(parts.values()) / 1e3
    if busy == 0:
        log(f"[profile] {name}: device time not measured (the profiler saw "
            "no CUDA activity)")
        return
    log(f"[profile] {name} warm wall {wall:.1f} ms; device busy {busy:.1f} "
        f"ms ({100 * busy / wall:.1f}% of wall, idle "
        f"{100 - 100 * busy / wall:.1f}%)")
    for k, us in parts.items():
        if us:
            log(f"[profile]   {k}: {us / 1e3:.2f} ms")
    for us, key, count in sorted(names, reverse=True)[:8]:
        log(f"[profile]   top: {us / 1e3:.2f} ms x{count} {key[:90]}")


def profile_phase(tables, scale: float):
    from spark_rapids_tpu_torch import tpch
    profile_query("q1", tpch.q1, tables)
    profile_query("q3", tpch.q3, tables)
    profile_query("m2m", tpch.m2m, tables)
    profile_query("q5", tpch.q5, tables)
    profile_query("q18_300", later_query("q18_300", scale), tables)


#: the rollup, channel and window queries must run their operators
DS_OPERATORS = {"ExpandExec": ("q27", "q36", "q70", "q86"),
                "UnionExec": ("q33", "q56", "q60", "q76"),
                "WindowExec": ("q12", "q20", "q36", "q70", "q86", "q98")}
DS_SCALE = 10.0
DS_SEED = 20250804
#: the window phase's CPU comparison runs over this many rows
WINDOW_CPU_ROWS = 1_000_000
#: the window phase's numpy result is computed in this many pieces (item
#: key ranges), one forked process each
WINDOW_PARTS = 4
_DS_TABLES = None


def _ds_want(name: str):
    """A TPC-DS query's numpy result (or the window phase's) over the
    tables tpcds_data set, and the seconds it took."""
    import chip_smoke_tpcds as D
    t0 = time.perf_counter()
    if name.startswith("window"):
        got = D.window_part_digests(_DS_TABLES["store_sales"],
                                    int(name[len("window"):]), WINDOW_PARTS)
    elif name == "dense_sf10":
        import chip_smoke_scalars as S
        got = S.expected(name, _DS_TABLES)
    else:
        got = D.expected(name, _DS_TABLES)
    return got, time.perf_counter() - t0


def tpcds_data():
    """TPC-DS at SF10 from the port's gen_tables, and the numpy result of
    every query and of the window phase, one forked process each, the
    slowest first; they finish before this phase's card work starts."""
    global _DS_TABLES
    import chip_smoke_tpcds as D
    from spark_rapids_tpu_torch import tpcds
    t0 = time.perf_counter()
    tables = tpcds.gen_tables(DS_SCALE, DS_SEED)
    log(f"[tpcds] gen_tables(scale={DS_SCALE:g}): " + ", ".join(
        f"{n} {hb.num_rows} rows" for n, hb in tables.items()) +
        f" in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    names = [f"window{p}" for p in range(WINDOW_PARTS)] + ["dense_sf10"] + [
        f"q{q}" for q in sorted(int(n[1:]) for n in DS_QUERIES)]
    workers = min(len(names), os.cpu_count() or 1)
    _DS_TABLES = tables
    with concurrent.futures.ProcessPoolExecutor(
            max_workers=workers,
            mp_context=multiprocessing.get_context("fork")) as pool:
        done = dict(zip(names, pool.map(_ds_want, names)))
    _DS_TABLES = None
    slowest = sorted(done, key=lambda n: -done[n][1])[:3]
    log(f"[tpcds] {len(names)} numpy results in {workers} processes: "
        f"{time.perf_counter() - t0:.1f} s; slowest " +
        ", ".join(f"{n} {done[n][1]:.1f} s" for n in slowest))
    want = {n: r for n, (r, _s) in done.items()
            if not n.startswith("window")}
    want["window"] = D.add_digests(r for n, (r, _s) in done.items()
                                   if n.startswith("window"))
    return tables, want


def _operators(root) -> dict:
    """Expand, Union and Window operators in a physical plan, by name."""
    seen = {k: 0 for k in DS_OPERATORS}
    stack = [root]
    while stack:
        node = stack.pop()
        name = type(node).__name__
        if name in seen:
            seen[name] += 1
        stack.extend(node.children)
    return seen


def tpcds_phase(tables, want):
    """The 23 TPC-DS queries at SF10 through TpuSession() on cuda: each
    equal to its numpy result, launching the kernels of its path
    (PATH_KERNELS ds_*), the rollup / channel / window queries running
    Expand / Union / Window; cold and warm walls and the peak device
    memory of each.  -> {ds_<q>: launches}."""
    import chip_smoke_tpcds as D
    from spark_rapids_tpu_torch import tpcds
    from spark_rapids_tpu_torch.ops.hopper import LAUNCHES, \
        reset_launch_counts
    s = _cuda_session()
    launches = {}
    for q in DS_QUERIES:
        build = tpcds.QUERIES[q]
        ops = _operators(build(s, tables).physical().root)
        for op, queries in DS_OPERATORS.items():
            if q in queries:
                check(ops[op] > 0, f"TPC-DS {q} runs no {op}")
        reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        got, ctx = run_query(s, build, tables)
        torch.cuda.synchronize()
        cold = (time.perf_counter() - t0) * 1e3
        launches[f"ds_{q}"] = dict(LAUNCHES)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        msg = D.compare(q, D.result_columns(got), want[q])
        check(not msg, f"TPC-DS {q} differs from the numpy reference: {msg}")
        check(got.num_rows > 0, f"TPC-DS {q} returned no row")
        for k in PATH_KERNELS[f"ds_{q}"]:
            check(launches[f"ds_{q}"][k] > 0,
                  f"kernel {k} was not launched on the TPC-DS {q} path")
        runs = []
        for _ in range(3):
            t0 = time.perf_counter()
            build(s, tables).collect()
            torch.cuda.synchronize()
            runs.append((time.perf_counter() - t0) * 1e3)
        log(f"[tpcds] {q} (SF{DS_SCALE:g}): {got.num_rows} rows equal the "
            f"numpy reference; cold {cold:.1f} ms, warm median "
            f"{statistics.median(runs):.1f} ms; peak device memory "
            f"{peak:.2f} GiB; operators {ops}; {ooc_counts(ctx)}; kernel "
            f"launches {launches[f'ds_{q}']}")
    return launches


def _cuda_session():
    from spark_rapids_tpu_torch.session import TpuSession
    s = TpuSession()
    check(s.device.type == "cuda", "TpuSession() is not on cuda")
    return s


def window_phase(tables, want) -> None:
    """One WindowExec over all of store_sales (partitioned by item,
    ordered by sale date; every function and frame of plan/window.py)
    held against numpy, and over its first WINDOW_CPU_ROWS rows against
    the port's own CPU path."""
    import chip_smoke_tpcds as D
    from spark_rapids_tpu_torch.exec.plan import ExecContext
    from spark_rapids_tpu_torch.session import TpuSession
    ss = tables["store_sales"]
    s = _cuda_session()
    q = D.window_frame(s, ss).physical()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    got = q.collect(ExecContext(q.conf, q.device))
    torch.cuda.synchronize()
    cold = (time.perf_counter() - t0) * 1e3
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    bad = D.window_digests_equal(got, want["window"])
    if bad:
        # locate the difference: the numpy lanes, here, in full
        try:
            D.compare_window(got, D.expected_window(ss))
        except AssertionError as e:
            check(False, str(e))
        check(False, f"window outputs {bad} differ from numpy's digests")
    del got
    runs = []
    for _ in range(3):
        ctx = ExecContext(q.conf, q.device)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _db in q.root.execute(ctx):
            pass
        torch.cuda.synchronize()
        runs.append((time.perf_counter() - t0) * 1e3)
    log(f"[window] {len(D.WINDOW_SPECS)} functions over {ss.num_rows} "
        f"store_sales rows (partition ss_item_sk, order ss_sold_date_sk) "
        f"equal numpy (digests of all {len(want['window'])} outputs, "
        f"bit for bit); collect cold "
        f"{cold:.1f} ms; operator (scan upload included, no fetch) warm "
        f"median {statistics.median(runs):.1f} ms; peak device memory "
        f"{peak:.2f} GiB")
    head = ss.slice(0, min(WINDOW_CPU_ROWS, ss.num_rows))
    card = D.window_frame(s, head).collect()
    cpu = D.window_frame(TpuSession(device="cpu"), head).collect()
    for name, _make in D.WINDOW_SPECS:
        a, b = card.column_by_name(name), cpu.column_by_name(name)
        check(np.array_equal(a.data, b.data) and
              np.array_equal(a.valid_mask(), b.valid_mask()),
              f"window {name} on the card differs from the port's CPU path "
              f"over the first {head.num_rows} rows")
    log(f"[window] the card equals the port's CPU path over the first "
        f"{head.num_rows} rows, every output")


def _timed(s, build, *args, reps: int = 3):
    """(result, ExecContext, cold ms, warm median ms, peak GiB, launches)
    of one query: launch counts zeroed just before its first run and
    read just after it."""
    from spark_rapids_tpu_torch.exec.plan import ExecContext
    from spark_rapids_tpu_torch.ops.hopper import LAUNCHES, \
        reset_launch_counts
    reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    q = build(s, *args).physical()
    ctx = ExecContext(q.conf, q.device)
    got = q.collect(ctx)
    torch.cuda.synchronize()
    cold = (time.perf_counter() - t0) * 1e3
    launches = dict(LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    runs = []
    for _ in range(reps):
        t0 = time.perf_counter()
        build(s, *args).collect()
        torch.cuda.synchronize()
        runs.append((time.perf_counter() - t0) * 1e3)
    return got, ctx, cold, statistics.median(runs) if runs else None, peak, \
        launches


def _check_launches(name: str, launches: dict) -> None:
    for k in PATH_KERNELS[name]:
        check(launches[k] > 0, f"kernel {k} was not launched on the {name} "
              "path")


def _query_log(name, rows, cold, warm, peak, launches, extra="",
               tag="scalars", equal="numpy"):
    warm = "no warm run" if warm is None else f"warm median {warm:.1f} ms"
    log(f"[{tag}] {name}: {rows} rows equal {equal}{extra}; cold "
        f"{cold:.1f} ms, {warm}; peak device memory {peak:.2f} GiB; kernel "
        f"launches {launches}")


def scalars_phase(tables, want) -> dict:
    """The statistical aggregates (moments_q1), every new scalar family
    grouped into SUM / MIN / MAX (scalars_q1), range + sample
    (range_sample) and every new expression over NaN, ±inf, -0.0, nulls
    and Long.MIN_VALUE, fetched (edge_values), through TpuSession() on
    cuda at SF10, each equal to numpy at chip_smoke_scalars' tolerances.
    -> {query: launches}."""
    import chip_smoke_scalars as S
    from spark_rapids_tpu_torch.exec.aggregate import GROUPBY_TIERS, \
        reset_groupby_tiers
    s = _cuda_session()
    launches = {}
    li = tables["lineitem"]
    # the numpy results of range_sample and edge_values (seconds of
    # ufuncs, which release the GIL) overlap the card's lineitem queries
    numpy_pool = concurrent.futures.ThreadPoolExecutor(max_workers=2)
    want_range = numpy_pool.submit(S.expected_range_sample)
    want_edge = numpy_pool.submit(S.expected_edge)
    numpy_pool.shutdown(wait=False)

    def keys_of(got):
        rf = got.column_by_name("l_returnflag")
        ls = got.column_by_name("l_linestatus")
        return [str(a) + str(b) for a, b in zip(rf.dictionary[rf.data],
                                                ls.dictionary[ls.data])]

    def numpy_keys(codes):
        rf = li.column_by_name("l_returnflag").dictionary
        ls = li.column_by_name("l_linestatus").dictionary
        return [str(rf[c // 2]) + str(ls[c % 2]) for c in codes]

    reset_groupby_tiers()
    got, _ctx, cold, warm, peak, launches["moments_q1"] = _timed(
        s, S.moments_q1, tables)
    want_m = want["moments_q1"]
    check(keys_of(got) == numpy_keys(want_m["_codes"]),
          "moments_q1 groups differ from numpy's")
    check(GROUPBY_TIERS["segagg"] > 0, "moments_q1 did not run segagg")
    for name, _fn, _cols in S.MOMENTS:
        c = got.column_by_name(name)
        check(c.valid_mask().all(), f"moments_q1.{name} has nulls")
        try:
            S.close(f"moments_q1.{name}", c.data, want_m[name],
                    scale=want_m[name + ":scale"])
        except AssertionError as e:
            check(False, str(e))
    check(np.array_equal(got.column_by_name("n").data, want_m["n"]),
          "moments_q1.n differs from numpy's")
    _check_launches("moments_q1", launches["moments_q1"])
    _query_log("moments_q1", got.num_rows, cold, warm, peak,
                launches["moments_q1"], f" (rtol {S.RTOL}; {li.num_rows} "
                "lineitem rows)")

    got, _ctx, cold, warm, peak, launches["scalars_q1"] = _timed(
        s, S.scalars_q1, tables)
    want_s = {}
    for part in (n for n in SCALAR_WANTS if n.startswith("scalars_q1")):
        want_s.update(want[part])
    check(keys_of(got) == numpy_keys(want_s["_codes"]),
          "scalars_q1 groups differ from numpy's")
    kinds = {n: k for n, (k, _e) in S._scalar_exprs().items()}
    worst = 0.0
    for name in got.names[2:]:
        agg, proj = name.split("_", 1)
        c = got.column_by_name(name)
        w = want_s[name]
        kind = kinds[proj]
        try:
            if agg == "sum" and kind in ("exact", "ulp"):
                S.close(f"scalars_q1.{name}", c.data, w)
            else:
                worst = max(worst, S.check_lane(
                    f"scalars_q1.{name}", "ulp" if kind == "ulp" else
                    "exact" if kind == "exact" else "int",
                    (c.data, c.valid_mask()), (w, np.ones(len(w), bool))))
        except AssertionError as e:
            check(False, str(e))
    _check_launches("scalars_q1", launches["scalars_q1"])
    _query_log("scalars_q1", got.num_rows, cold, warm, peak,
                launches["scalars_q1"], f" ({len(got.names) - 2} aggregates"
                f" of {len(kinds)} projections; transcendental MIN/MAX at "
                f"most {worst:.0f} ulps from numpy's, bound {S.ULPS})")

    want_r = want_range.result()
    got, _ctx, cold, warm, peak, launches["range_sample"] = _timed(
        s, lambda sess: S.range_sample(sess))
    lanes = {n: got.column_by_name(n).data for n in ("m", "n", "s")}
    for n in ("m", "n", "s"):
        check(np.array_equal(lanes[n], want_r[n]),
              f"range_sample.{n} differs from numpy's")
    count = S.range_sample_count(s)
    check(count == want_r["count"], f"range_sample count() {count}, numpy "
          f"{want_r['count']}")
    _check_launches("range_sample", launches["range_sample"])
    _query_log("range_sample", got.num_rows, cold, warm, peak,
                launches["range_sample"], f" ({S.RANGE_ROWS} ids, "
                f"{want_r['count']} kept; count() equal)")

    got, _ctx, cold, warm, peak, launches["edge_values"] = _timed(
        s, lambda sess: S.edge_values(sess), reps=1)
    want_e = want_edge.result()
    kinds = {n: k for n, (k, _e) in S._edge_exprs().items()}
    worst = {}
    for name, c in zip(got.names, got.columns):
        try:
            worst[name] = S.check_lane(
                f"edge_values.{name}", kinds[name],
                (c.data, c.valid_mask()), want_e[name])
        except AssertionError as e:
            check(False, str(e))
    try:
        S.raise_error_query(s).collect()
        check(False, "raise_error over live rows did not raise on the card")
    except RuntimeError as e:
        check(str(e) == "edge", f"raise_error raised {e!r}")
    ulp_max = max(worst.values())
    _query_log("edge_values", got.num_rows, cold, warm, peak,
                launches["edge_values"], f" ({len(got.names)} columns, "
                f"elementwise; transcendental at most {ulp_max:.0f} ulps "
                f"({max(worst, key=worst.get)}), bound {S.ULPS}; "
                "raise_error raised)")
    return launches


def dense_phase(ds_tables, ds_want) -> dict:
    """The dense group-by tier on the card: TPC-DS q7, q26, q56 and q60 at
    scale 0.1 (i_item_id's 1,800 values: between segagg's maxDomain and
    denseDomainMax) equal to their numpy results, and at SF10
    store_sales ⋈ item grouped by (i_category, i_class, i_color) equal to
    numpy (integers and decimals exactly, the average bit for bit, the
    standard deviation within rtol).  Each must run the dense tier.
    -> {query: launches}."""
    import chip_smoke_scalars as S
    import chip_smoke_tpcds as D
    from spark_rapids_tpu_torch import tpcds
    from spark_rapids_tpu_torch.exec.aggregate import GROUPBY_TIERS, \
        reset_groupby_tiers
    s = _cuda_session()
    launches = {}
    small = tpcds.gen_tables(DENSE_SCALE, DS_SEED)
    for q in DENSE_QUERIES:
        want = D.expected(q, small)
        reset_groupby_tiers()
        got, _ctx, cold, warm, peak, launches[f"dense_{q}"] = _timed(
            s, tpcds.QUERIES[q], small)
        check(GROUPBY_TIERS["dense"] > 0, f"dense_{q} ran no dense group-by")
        msg = D.compare(q, D.result_columns(got), want)
        check(not msg, f"dense_{q} differs from the numpy reference: {msg}")
        _check_launches(f"dense_{q}", launches[f"dense_{q}"])
        _query_log(f"dense_{q}", got.num_rows, cold, warm, peak,
                    launches[f"dense_{q}"], f" (TPC-DS scale {DENSE_SCALE};"
                    f" group-by tiers {dict(GROUPBY_TIERS)})")
    reset_groupby_tiers()
    got, _ctx, cold, warm, peak, launches["dense_sf10"] = _timed(
        s, S.dense_sf10, ds_tables)
    check(GROUPBY_TIERS["dense"] > 0, "dense_sf10 ran no dense group-by")
    want = ds_want["dense_sf10"]
    item = ds_tables["item"]
    cols = {n: got.column_by_name(n) for n in got.names}
    dicts = [item.column_by_name(k).dictionary for k in S.DENSE_KEYS]
    check(got.num_rows == len(want), f"dense_sf10 has {got.num_rows} groups,"
          f" numpy {len(want)}")

    def key_of(codes):
        return tuple(None if c < 0 else str(d[c])
                     for c, d in zip(codes, dicts))
    want = {key_of(k): v for k, v in want.items()}
    for r in range(got.num_rows):
        key = tuple(str(cols[k].dictionary[cols[k].data[r]])
                    if cols[k].valid_mask()[r] else None
                    for k in S.DENSE_KEYS)
        check(key in want, f"dense_sf10 group {key} not in numpy's")
        w = want[key]
        vals = [cols[n].data[r] if cols[n].valid_mask()[r] else None
                for n in ("sum_net_paid", "n", "avg_qty", "min_price",
                          "max_price", "sd_price")]
        check(vals[:5] == list(w[:5]), f"dense_sf10 {key}: {vals[:5]} "
              f"against numpy's {list(w[:5])}")
        check((vals[5] is None) == (w[5] is None) and (
            w[5] is None or abs(vals[5] - w[5]) <= S.RTOL * abs(w[5])),
            f"dense_sf10 {key} stddev {vals[5]} against {w[5]}")
    _check_launches("dense_sf10", launches["dense_sf10"])
    _query_log("dense_sf10", got.num_rows, cold, warm, peak,
                launches["dense_sf10"], f" ({ds_tables['store_sales'].num_rows}"
                f" store_sales rows; group-by tiers {dict(GROUPBY_TIERS)})")
    return launches


def strings_phase(dev, tables, want) -> dict:
    """The device string functions on the card over the TPC-H tables:
    the six LIKE forms (each equal to phase 5's numpy result of its
    Contains / StartsWith form), strings_groupby (equal to numpy, through
    segagg), the device dictionary transforms over c_name and p_name
    (equal to np.char) beside lpad's host loop, and every new class and
    cast over the edge rows (equal to the port's CPU path).
    -> {query: launches}."""
    import chip_smoke_strings as S
    from spark_rapids_tpu_torch.config import TpuConf
    from spark_rapids_tpu_torch.exec.aggregate import GROUPBY_TIERS, \
        reset_groupby_tiers
    from spark_rapids_tpu_torch.ops import strings as PS
    from spark_rapids_tpu_torch.ops.hopper import LAUNCHES, \
        reset_launch_counts
    from spark_rapids_tpu_torch.plan.strings import Lpad
    from spark_rapids_tpu_torch.session import col
    s = _cuda_session()
    launches = {}
    # string_edges on the CPU path: a spawned process, beside the card's
    # queries (its host loops over the edge entries take seconds)
    cpu_pool = concurrent.futures.ProcessPoolExecutor(
        max_workers=1, mp_context=multiprocessing.get_context("spawn"))
    cpu_edges = cpu_pool.submit(S.cpu_edge_digests, S.EDGE_ROWS,
                                S.EDGE_ENTRIES)
    cpu_pool.shutdown(wait=False)
    for name, base in S.LIKE_OF.items():
        got, _ctx, cold, warm, peak, launches[name] = _timed(
            s, S.like_query(name), tables)
        check_later(base, lanes_of(got), want[base])
        check(got.num_rows > 0, f"{name} returned no row")
        _check_launches(name, launches[name])
        _query_log(name, got.num_rows, cold, warm, peak, launches[name],
                   tag="strings", equal=f"{base}'s numpy result")

    reset_groupby_tiers()
    got, _ctx, cold, warm, peak, launches["strings_groupby"] = _timed(
        s, S.strings_groupby, tables)
    lanes = lanes_of(got)
    check(lanes == want["strings_groupby"], "strings_groupby differs from "
          f"numpy:\n{lanes}\n{want['strings_groupby']}")
    check(GROUPBY_TIERS["segagg"] > 0, "strings_groupby did not run segagg")
    _check_launches("strings_groupby", launches["strings_groupby"])
    _query_log("strings_groupby", got.num_rows, cold, warm, peak,
               launches["strings_groupby"],
               f" (group-by tiers {dict(GROUPBY_TIERS)})", tag="strings")

    reset_launch_counts()
    for table, column in (("customer", "c_name"), ("part", "p_name")):
        d = _col(tables[table], column).dictionary
        for kind in S.DICT_TRANSFORMS:
            out, remap = PS.transform_dict_device(d, kind, (), dev)
            check(np.array_equal(out[remap.cpu().numpy()],
                                 S.expected_transform(d, kind)) and
                  bool(np.all(out[:-1] < out[1:])),
                  f"{kind}({column}) differs from np.char's")
            # one timed call: the checked call above warmed it up
            ms = cuda_ms(lambda: PS.transform_dict_device(d, kind, (), dev),
                         reps=1, warmup=0)
            log(f"[strings] string_dicts {kind}({column}) over {len(d)} "
                f"entries: {ms:.2f} ms (CUDA events; the code points' "
                f"upload and the output's fetch included) -> {len(out)} "
                "sorted unique entries, equal np.char's")
        if column == "c_name":
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            rw = Lpad(col(column), 24, "*").transformed(d, TpuConf(), dev)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            check(np.array_equal(rw.dictionary[rw.remap.cpu().numpy()],
                                 np.char.rjust(d, 24, "*")),
                  "lpad(c_name, 24, '*') differs from np.char.rjust")
            log(f"[strings] string_dicts lpad({column}, 24, '*') over "
                f"{len(d)} entries: {ms:.1f} ms (host clock, one run: the "
                "exact per-entry loop on the host and the remap's upload)")
    launches["string_dicts"] = dict(LAUNCHES)

    table = S.edge_table(S.EDGE_ROWS, S.EDGE_ENTRIES)
    # one (cold) run: the host loops over the 65,536 entries, which every
    # run repeats, dominate it
    got, _ctx, cold, warm, peak, launches["string_edges"] = _timed(
        s, lambda sess: S.edge_values(sess, table), reps=0)
    want_edges, cpu_ms = cpu_edges.result()
    bad = [n for n, c in zip(got.names, got.columns)
           if S.column_digest(c) != want_edges[n]]
    check(not bad, f"string_edges on the card differ from the CPU path: "
          f"{bad}")
    _query_log("string_edges", got.num_rows, cold, warm, peak,
               launches["string_edges"],
               f" ({len(got.names)} columns over "
               f"{len(table.column_by_name('s').dictionary)} entries; "
               f"{cpu_ms:.1f} ms there)", tag="strings",
               equal="the port's CPU path")
    return launches


def walls_phase(tables, names, scale: float) -> dict:
    """{query: [cold ms, median of 5 warm ms]} through TpuSession()."""
    s = _cuda_session()
    out = {}
    for name in names:
        build = minmax_query if name == "minmax" else later_query(name, scale)
        runs = []
        for _ in range(6):
            t0 = time.perf_counter()
            build(s, tables).collect()
            torch.cuda.synchronize()
            runs.append((time.perf_counter() - t0) * 1e3)
        out[name] = [round(runs[0], 1), round(statistics.median(runs[1:]), 1)]
        log(f"[walls] {name}: cold {runs[0]:.1f} ms, warm median "
            f"{out[name][1]:.1f} ms")
    return out


def phase(name: str, fn, *args):
    """Run one phase and log its seconds."""
    t0 = time.perf_counter()
    out = fn(*args)
    log(f"[run] {name} phase {time.perf_counter() - t0:.1f} s")
    return out


def card_phases(dev, tables, want, later, args):
    """Every phase on the card.  -> (the kernel statistics, each path's
    kernel launches, the path phase's (cold, warm) walls)."""
    stats = phase("kernels", kernels_phase, dev, tables)
    stats.update(phase("join kernels", join_kernels_phase, dev, tables))
    stats.update(phase("counted join kernels", counted_join_kernels_phase,
                       dev, tables))
    _FLUSH.clear()                # the path's peak memory is the queries'
    launches, cold, warm = {}, {}, {}
    if not args.kernels_only:
        # one look-back scan and one tail launch a compaction; the counted
        # probe scans its counts inside its one launch
        check(stats["compaction_order"]["launches_per_call"] <= 2,
              "compaction_order made more than 2 device launches a call")
        # the scan of the finals and the slot pass, no fill
        for case, d in stats["build_table"]["distributions"].items():
            check(d["launches_per_call"] == 2, f"build_table at {case} "
                  f"made {d['launches_per_call']:g} device launches a "
                  "call, not 2")
        for name in ("probe_first", "probe_counts", "expand_pairs"):
            for case, d in stats[name].get("distributions", {"": stats[
                    name]}).items():
                check(d["launches_per_call"] == 1, f"{name} {case} made "
                      f"{d['launches_per_call']:g} device launches a call, "
                      "not 1")
        launches, cold, warm = phase(
            "path", path_phase, tables, want, later, args.scale)
        log(f"[path] upload copy rate (pageable host to device, 32 MiB "
            f"copies): {upload_rate(dev):.2f} GB/s")
        phase("dictionary", dictionary_phase, dev, tables, later, want)
        phase("profile", profile_phase, tables, args.scale)
        phase("ooc", ooc_phase, tables, want, args.scale, cold, warm)
        launches.update(phase("scalars", scalars_phase, tables, want))
        launches.update(phase("strings", strings_phase, dev, tables, want))
    return stats, launches, (cold, warm)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--scale", type=float, default=10.0)
    ap.add_argument("--seed", type=int, default=20240706)
    ap.add_argument("--kernels-only", action="store_true",
                    help="run the device, build, data and kernel phases "
                    "only, and print the kernels line without the result "
                    "line: the mode that times the kernels of another "
                    "tree of the port, with this script copied to its root "
                    "(the checks of this tree's launches a call are "
                    "skipped)")
    ap.add_argument("--walls", default="",
                    help="comma-separated queries: run the device, build "
                    "and data phases, then print each query's cold wall "
                    "and the median of 5 warm walls, without the result "
                    "line (an A B B A of query walls against another tree "
                    "of the port, with this script copied to its root)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    t_run = time.perf_counter()
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from spark_rapids_tpu_torch.ops.hopper import build_libraries
    dev = torch.device("cuda")
    smi = smi_line()
    log(f"[device] {smi}")
    log(f"[device] torch.cuda.get_device_name: "
        f"{torch.cuda.get_device_name(0)}; torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")
    t0 = time.perf_counter()
    build_libraries()
    log(f"[build] nvcc sm_90a: {time.perf_counter() - t0:.1f} s")
    tables, want, later = data_phase(
        args.scale, args.seed,
        reference=not (args.kernels_only or args.walls))
    if args.walls:
        print(json.dumps({"walls": walls_phase(
            tables, args.walls.split(","), args.scale)}))
        print(smi)
        return 0
    stats, launches, path_walls = card_phases(dev, tables, want, later,
                                              args)
    if not args.kernels_only:
        import chip_smoke_capture as CAP
        import chip_smoke_chaos as CH
        import chip_smoke_decimals as DEC
        import chip_smoke_fallback as F
        import chip_smoke_joins as J
        import chip_smoke_late as LT
        import chip_smoke_nested as N
        import chip_smoke_structs as ST
        import chip_smoke_udf as U
        # the TPC-H tables go first, to bound host memory; the fallback,
        # decimals, chaos, joins, late, nested, structs and udf phases
        # keep the columns they read
        fb_tables = F.narrow(tables)
        dec_tables = DEC.narrow(tables)
        ch_tables = CH.narrow(tables)
        ch_want = {k: want[k] for k in CH.WANTS}
        jn_tables = J.narrow(tables)
        jn_want = {k: want[k] for k in J.PATH_WANTS + J.WANTS}
        lt_tables = LT.narrow(tables)
        lt_want = {k: want[k] for k in LT.CASES}
        cap_want = {k: want[k] for k in CAP.CASES}
        nt_tables = N.narrow(tables)
        nt_want = {k: want[k] for k in N.WANTS}
        st_tables = ST.narrow(tables)
        st_want = {k: want[k] for k in ST.WANTS + ST.LATER_WANTS}
        udf_tables = U.narrow(tables)
        udf_want = {k: want[k] for k in U.WANTS}
        udf_path_launches = {k: dict(launches[k]) for k in U.WANTS}
        del tables, want, later
        gc.collect()
        torch.cuda.empty_cache()
        ds_tables, ds_want = phase("tpcds data", tpcds_data)
        launches.update(phase("tpcds", tpcds_phase, ds_tables, ds_want))
        phase("window", window_phase, ds_tables, ds_want)
        launches.update(phase("scalars dense", dense_phase, ds_tables,
                              ds_want))
        launches.update(phase("decimals (TPC-DS part)", DEC.ds_window_phase,
                              sys.modules[__name__], ds_tables, ds_want))
        launches.update(phase("capture (TPC-DS part)",
                              CAP.ds_capture_phase, sys.modules[__name__],
                              ds_tables, ds_want))
        del ds_tables, ds_want
        gc.collect()
        launches.update(phase("fallback", F.fallback_phase,
                              sys.modules[__name__], fb_tables, args.seed))
        del fb_tables
        launches.update(phase("decimals", DEC.decimals_phase,
                              sys.modules[__name__], dec_tables))
        del dec_tables
        gc.collect()
        launches.update(phase("chaos", CH.chaos_phase,
                              sys.modules[__name__], ch_tables, ch_want))
        del ch_tables
        gc.collect()
        launches.update(phase("joins", J.joins_phase, sys.modules[__name__],
                              jn_tables, jn_want, path_walls))
        del jn_tables
        gc.collect()
        launches.update(phase("late", LT.late_phase, sys.modules[__name__],
                              lt_tables, lt_want, path_walls))
        launches.update(phase("capture", CAP.capture_phase,
                              sys.modules[__name__], lt_tables, cap_want))
        del lt_tables
        gc.collect()
        launches.update(phase("nested", N.nested_phase,
                              sys.modules[__name__], nt_tables, nt_want))
        del nt_tables
        gc.collect()
        launches.update(phase("structs", ST.structs_phase,
                              sys.modules[__name__], st_tables, st_want))
        del st_tables
        gc.collect()
        launches.update(phase("udf", U.udf_phase, sys.modules[__name__],
                              udf_tables, udf_want, udf_path_launches))
    rows = []
    for name in TPU_KERNELS:
        st = stats[name]
        by_query = {q: n[name] for q, n in launches.items()}
        rows.append({"name": name, "route": "cuda",
                     "source": SOURCES[name],
                     "replaces": TPU_KERNELS[name],
                     "launches": sum(by_query.values()),
                     "launches_by_query": by_query,
                     "max_abs_err": st["max_abs_err"], "ms": st["ms"],
                     "plain_ms": st["plain_ms"], "bound_ms": st["bound_ms"],
                     "bound_by": st["bound_by"],
                     "library_ms": st["library_ms"],
                     "shape": st["shape"],
                     **{k: st[k] for k in (
                         "kernel_ms", "cold_kernel_ms", "launches_per_call",
                         "kernel_parts", "distributions") if k in st}})
    print(json.dumps({"kernels": rows}))
    log(f"[run] {time.perf_counter() - t_run:.1f} s in all")
    print(smi)
    if args.kernels_only:
        return 0
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
