"""Site-addressable deterministic fault injection (the chaos harness).

Counterpart of spark_rapids_tpu/runtime/faults.py, with the same grammar,
triggers and site names, so one conf dict drives both packages.  A conf
spec (`spark.rapids.tpu.test.faults`) arms deterministic faults at named
sites:

    site:kind:trigger[;site:kind:trigger...]

    spill_read:corrupt:nth=2          # corrupt the 2nd spill block read
    reserve:oom:every=3               # OOM every 3rd budget reservation
    h2d:ioerror:p=0.1,seed=7          # 10% of uploads fail (seeded)
    execute:fatal:nth=5               # a fatal device error on batch 5

Kinds:
  oom     -> TpuRetryOOM       (the OOM retry ladder owns recovery)
  ioerror -> InjectedIOError   (OSError: runtime/retry.py retry_io owns
                                recovery)
  corrupt -> flips a payload byte in the on-disk block, so that the
             block's own crc32 check (runtime/memory.read_block) detects
             it (spill_read only)
  fatal   -> InjectedFatalError (classified FATAL_DEVICE: crash dump and
                                 FatalDeviceError, runtime/failure.py)
  error   -> InjectedQueryError (a plain query error, class QUERY)
  timeout -> deadline: a synthetic per-query deadline expiry at a
             cancellation checkpoint

Triggers fire deterministically: `nth=N` once on the Nth hit of the
site; `every=N` on every Nth hit; `p=F[,seed=N]` per hit with a
counter-seeded splitmix64; `always` on every hit.  Each firing is
appended to the injector's `log`, which crash dumps embed as
`injected_faults`.

The port fires the sites in `PORTED_SITES`.  The grammar accepts every
site of the reference; a spec that arms one the port does not fire yet
raises NotImplementedError when its injector is built (`UNFIRED_SITES`
names the ROADMAP Queue 1 item each waits for), so no rule stays
silently unarmed.  The reference's `fault_injected` tracer instant and
registry counter port with the observability slice (item 10).

The disabled path is a no-op: `get_injector(conf)` returns the shared
`NULL_INJECTOR` when the conf has no fault spec.
"""
from __future__ import annotations

import dataclasses
import os
import threading
import time
from typing import Dict, List, Optional

from ..config import TEST_FAULTS, TpuConf
from .memory import TpuRetryOOM

#: site name -> which layer it interrupts (the reference's registry, word
#: for word: the layers named there are the reference's)
SITES: Dict[str, str] = {
    "reserve": "MemoryBudget.reserve admission (runtime/memory.py)",
    "compile": "whole-plan XLA compile (exec/compiled.py) — fires on "
               "the compiling thread, including background segment "
               "compiles on the compile service "
               "(runtime/compile_service.py), whose faults re-raise on "
               "the consuming query thread",
    "execute": "per-batch physical root stream (runtime/failure.py "
               "install_fault_injection)",
    "h2d": "host->device upload transitions",
    "d2h": "device->host fetch transitions",
    "spill_write": "Spillable host->disk block write (runtime/memory.py)",
    "spill_read": "Spillable disk block read-back (runtime/memory.py)",
    "shuffle_write": "shuffle map-output write (exec/exchange.py)",
    "shuffle_fetch": "shuffle reduce-side fetch (exec/exchange.py)",
    "exchange": "mesh/multihost collective exchange (parallel/)",
    "serving": "ServingRuntime admission (serving/runtime.py) — fires "
               "per submit; kind 'timeout' raises the admission-timeout "
               "backpressure signal (TenantSession.collect retries it "
               "once, the bounded-admission recovery rung)",
    "result_cache": "serving plan+result cache read (serving/cache.py) "
                    "— kind 'corrupt' flips a byte in the cached IPC "
                    "payload so the REAL checksum verification detects "
                    "it, drops the entry and recomputes",
    "history": "performance-history store write (obs/history.py) — "
               "fires once per recorded query on the JSONL append "
               "path. Kind 'ioerror' is absorbed by the store itself: "
               "the entry is SKIPPED "
               "(tpu_history_records_total{outcome=io_error}) and the "
               "query's result is untouched — telemetry must never "
               "fail work. 'fatal' propagates through the query's "
               "crash-capture scope as a classified FATAL_DEVICE dump "
               "naming the site",
    "memattr": "memory-attribution census read (obs/memattr.py via "
               "exec/compiled.py) — fires once per profiled segment "
               "dispatch when the plane is armed "
               "(profile.segments + profile.memory). Kind 'ioerror' "
               "is absorbed at the bracket: that dispatch's HBM "
               "sample is SKIPPED (memattr_census_skipped metric) and "
               "the query result is bit-identical — sampling must "
               "never cost work. 'fatal' propagates through the "
               "query's crash-capture scope as a classified "
               "FATAL_DEVICE dump embedding the PARTIAL HBM timeline "
               "collected up to the fault",
    "ooc": "out-of-core tier boundaries (exec/ooc.py via exec/join.py "
           "hash-join spill partitioning, exec/ooc_agg.py spill-"
           "partitioned aggregation, exec/ooc_sort.py merge passes) — "
           "fires once per partition pass / merge pass with the "
           "operator, bucket and depth in the injected-fault record, "
           "AFTER the matching `ooc_state` instant hit the flight "
           "recorder.  Kind 'oom' rides the normal OOM ladder (the "
           "query replays bit-identically — the OOC context is already "
           "forced on the replay); 'fatal' surfaces as a classified "
           "FATAL_DEVICE crash dump whose flight-recorder tail embeds "
           "the OOC bucket state the pass was in",
    "worker": "serving worker-process dispatch (serving/workers.py) — "
              "fires SUPERVISOR-side, once per query dispatched to a "
              "worker process (redrives fire it again), so nth= "
              "triggers stay deterministic across the pool. Kind "
              "'kill' SIGKILLs the victim worker the moment its "
              "'started' frame confirms the query is mid-flight; "
              "'hang' wedges the victim (heartbeats and request "
              "processing stop — the health monitor detects the "
              "missed-heartbeat window and kills it); 'fatal' arms "
              "the in-worker fatal injector so the query dies with a "
              "classified FATAL_DEVICE crash dump and the worker "
              "self-terminates. All three lose only the victim's "
              "in-flight queries, which REDRIVE on a surviving worker "
              "(serving.redrive.maxAttempts) bit-identically",
    "fleet": "observability federation fold (serving/workers.py "
             "_reader_loop): fires SUPERVISOR-side once per heartbeat "
             "frame that carries telemetry (registry snapshot / flight "
             "tail). Kind 'ioerror' drops that ONE frame whole — "
             "cumulative-set federation converges on the next beat and "
             "the in-flight query stays bit-identical; 'fatal' writes "
             "a classified crash dump naming the site and drops the "
             "frame, with the supervisor (and the pool) surviving — "
             "telemetry must never take serving down",
    "deadline": "cooperative cancellation checkpoints (exec/plan.py "
                "ExecContext.checkpoint): the compiled-plan seam "
                "brackets, the per-batch result stream, out-of-core "
                "partition/merge passes, exchange rounds and spill-all "
                "sweeps. Kind 'timeout' injects a synthetic deadline "
                "expiry at the Nth checkpoint — the query cancels "
                "exactly as if serving.deadlineMs had elapsed there, "
                "and the ticket's whole device reservation is released "
                "(DeviceCensus shows zero residual)",
    "kernel": "Pallas kernel-tier dispatch (ops/pallas/) and encoded-"
              "execution dispatch (ops/encodings.py) — fires each "
              "time an operator elects a hand-written kernel or a "
              "code-space/narrow-lane path, with the kernel family / "
              "encoded site in the injected-fault record. Kind 'oom' "
              "is caught by the dispatch gate itself: the operator "
              "sheds to the sort-based portable tier (or the encoded "
              "dispatch to the decoded tier) bit-identically "
              "(tpu_kernel_fallback_total{reason=oom} / "
              "tpu_encoded_dispatch_total{outcome=oom_shed}); 'fatal' "
              "surfaces as a classified FATAL_DEVICE crash dump whose "
              "injected-fault record names the kernel",
}

#: the sites the port fires, and where
PORTED_SITES: Dict[str, str] = {
    "reserve": "runtime/memory.py MemoryBudget.reserve, once per admission",
    "execute": "runtime/failure.py install_fault_injection, once per "
               "batch the physical root emits",
    "h2d": "exec/plan.py HostScanExec and exec/host_exec.py "
           "HostToDeviceExec uploads, under retry_io",
    "d2h": "exec/plan.py PlanNode.collect and exec/host_exec.py "
           "DeviceToHostExec fetches, under retry_io",
    "spill_write": "runtime/memory.py Spillable.to_disk, under retry_io",
    "spill_read": "runtime/memory.py Spillable._read_disk, under retry_io",
    "ooc": "exec/ooc.py fire, once per out-of-core partition or merge "
           "pass",
    "kernel": "ops/hopper/__init__.py elect, once per kernel election "
              "(segagg, hash_probe_join, compact)",
    "deadline": "exec/plan.py ExecContext.checkpoint",
}

#: the reference's sites the port does not fire yet -> the ROADMAP
#: Queue 1 item that ports them
UNFIRED_SITES: Dict[str, str] = {
    "compile": "item 5", "shuffle_write": "item 9",
    "shuffle_fetch": "item 9", "exchange": "item 9", "serving": "item 10",
    "result_cache": "item 10", "history": "item 10", "memattr": "item 10",
    "worker": "item 10", "fleet": "item 10",
}

KINDS = ("oom", "ioerror", "corrupt", "fatal", "error", "timeout",
         "kill", "hang")

#: kinds the corrupt action makes sense for: it needs an on-disk block
#: path (spill_read) or an in-memory payload bytearray (result_cache)
_CORRUPT_SITES = ("spill_read", "result_cache")

#: the timeout kind models admission backpressure (serving) and
#: deadline expiry (the cancellation checkpoints)
_TIMEOUT_SITES = ("serving", "deadline")

#: process-level faults: only the supervised worker pool can SIGKILL or
#: wedge a process, so kill/hang arm only at the worker site, and the
#: worker site accepts only process-level kinds
_WORKER_KINDS = ("kill", "hang", "fatal")

#: the federation fold can lose a frame (ioerror) or dump-and-survive
#: (fatal); nothing else is meaningful for pure telemetry
_FLEET_KINDS = ("ioerror", "fatal")


class InjectedIOError(OSError):
    """Synthetic transient host-IO failure (classified 'io'; the bounded
    IO retry ladder recovers it)."""


class InjectedQueryError(RuntimeError):
    """Synthetic plain query error (classified 'query')."""


@dataclasses.dataclass
class FaultRule:
    site: str
    kind: str
    nth: Optional[int] = None        # fire once, on the Nth hit
    every: Optional[int] = None      # fire on every Nth hit
    p: Optional[float] = None        # per-hit probability (seeded)
    seed: int = 0
    always: bool = False
    hits: int = 0
    fired: int = 0

    def should_fire(self) -> bool:
        self.hits += 1
        if self.nth is not None:
            return self.hits == self.nth
        if self.every is not None:
            return self.hits % self.every == 0
        if self.p is not None:
            return _splitmix_uniform(self.seed, self.hits) < self.p
        return self.always


def _splitmix_uniform(seed: int, counter: int) -> float:
    """Deterministic per-(seed, counter) uniform in [0, 1): Python's
    `hash` is salted per process and would make p= rules
    unreproducible."""
    x = (seed * 0x9E3779B97F4A7C15 + counter * 0xBF58476D1CE4E5B9) \
        & 0xFFFFFFFFFFFFFFFF
    x ^= x >> 30
    x = (x * 0xBF58476D1CE4E5B9) & 0xFFFFFFFFFFFFFFFF
    x ^= x >> 27
    x = (x * 0x94D049BB133111EB) & 0xFFFFFFFFFFFFFFFF
    x ^= x >> 31
    return x / 2.0 ** 64


def parse_spec(spec: str) -> List[FaultRule]:
    """`site:kind:trigger[;...]` -> rules.  Raises ValueError on any
    unknown site or kind or a malformed trigger (the conf checker
    surfaces it when the key is read)."""
    rules: List[FaultRule] = []
    for part in (spec or "").split(";"):
        part = part.strip()
        if not part:
            continue
        pieces = part.split(":")
        if len(pieces) != 3:
            raise ValueError(f"fault rule {part!r}: want site:kind:trigger")
        site, kind, trigger = (p.strip() for p in pieces)
        if site not in SITES:
            raise ValueError(f"unknown fault site {site!r} "
                             f"(known: {sorted(SITES)})")
        if kind not in KINDS:
            raise ValueError(f"unknown fault kind {kind!r} "
                             f"(known: {list(KINDS)})")
        if kind == "corrupt" and site not in _CORRUPT_SITES:
            raise ValueError(f"kind 'corrupt' only applies to sites "
                             f"{list(_CORRUPT_SITES)}, got {site!r}")
        if kind == "timeout" and site not in _TIMEOUT_SITES:
            raise ValueError(f"kind 'timeout' only applies to sites "
                             f"{list(_TIMEOUT_SITES)}, got {site!r}")
        if kind in ("kill", "hang") and site != "worker":
            raise ValueError(f"kind {kind!r} only applies to site "
                             f"'worker', got {site!r}")
        if site == "worker" and kind not in _WORKER_KINDS:
            raise ValueError(f"site 'worker' only takes process-level "
                             f"kinds {list(_WORKER_KINDS)}, got {kind!r}")
        if site == "fleet" and kind not in _FLEET_KINDS:
            raise ValueError(f"site 'fleet' only takes telemetry kinds "
                             f"{list(_FLEET_KINDS)}, got {kind!r}")
        rule = FaultRule(site, kind)
        if trigger == "always":
            rule.always = True
        else:
            for kv in trigger.split(","):
                if "=" not in kv:
                    raise ValueError(f"fault trigger {trigger!r}: "
                                     f"want key=value[,key=value]")
                k, v = (x.strip() for x in kv.split("=", 1))
                try:
                    if k == "nth":
                        rule.nth = int(v)
                    elif k == "every":
                        rule.every = int(v)
                    elif k == "p":
                        rule.p = float(v)
                    elif k == "seed":
                        rule.seed = int(v)
                    else:
                        raise ValueError(f"unknown trigger key {k!r}")
                except ValueError as e:
                    raise ValueError(f"fault trigger {trigger!r}: {e}")
            if rule.nth is None and rule.every is None and rule.p is None:
                raise ValueError(f"fault trigger {trigger!r}: need one of "
                                 f"nth=/every=/p=/always")
            if (rule.nth is not None and rule.nth < 1) or \
                    (rule.every is not None and rule.every < 1):
                raise ValueError(f"fault trigger {trigger!r}: counts are "
                                 f"1-based (must be >= 1)")
            if rule.p is not None and not 0.0 <= rule.p <= 1.0:
                raise ValueError(f"fault trigger {trigger!r}: p must be "
                                 f"in [0, 1]")
        rules.append(rule)
    return rules


def check_spec(spec: str) -> Optional[str]:
    """Conf-checker form of parse_spec: error string or None."""
    try:
        parse_spec(spec)
        return None
    except ValueError as e:
        return str(e)


def check_ported(rules: List[FaultRule]) -> None:
    """NotImplementedError naming the ROADMAP item when a rule arms a
    site the port does not fire yet."""
    for r in rules:
        if r.site in UNFIRED_SITES:
            raise NotImplementedError(
                f"fault site {r.site!r} ({r.site}:{r.kind}) is not fired "
                f"by the PyTorch/CUDA port yet: it ports with ROADMAP "
                f"Queue 1 {UNFIRED_SITES[r.site]}")


class FaultInjector:
    """Armed injector for one conf's fault spec.  Thread-safe: hit
    counters are global per rule, so `nth=` means the Nth hit for this
    conf, whichever thread lands it."""

    enabled = True

    def __init__(self, spec: str):
        self.rules = parse_spec(spec)
        check_ported(self.rules)
        self._by_site: Dict[str, List[FaultRule]] = {}
        for r in self.rules:
            self._by_site.setdefault(r.site, []).append(r)
        self._lock = threading.Lock()
        self.log: List[dict] = []        # the injected-fault record

    def has_site(self, site: str) -> bool:
        return site in self._by_site

    def fire(self, site: str, **info) -> None:
        """Evaluate every rule armed at `site`; the first that triggers
        acts (raise or corrupt), after its record joins the log."""
        rules = self._by_site.get(site)
        if not rules:
            return
        with self._lock:
            fired = None
            for r in rules:
                if r.should_fire():
                    r.fired += 1
                    fired = r
                    break
            if fired is None:
                return
            rec = {"site": site, "kind": fired.kind, "hit": fired.hits,
                   "ts": time.time()}
            rec.update({k: str(v) for k, v in info.items()
                        if k != "payload"})   # bulk bytes stay out of logs
            if len(self.log) < 256:
                self.log.append(rec)
        self._act(fired, site, info)

    @staticmethod
    def _act(rule: FaultRule, site: str, info: dict) -> None:
        kind = rule.kind
        msg = (f"injected {kind} at fault site {site!r} "
               f"(hit #{rule.hits}, spark.rapids.tpu.test.faults)")
        if kind == "timeout" and site == "deadline":
            from ..exec.plan import InjectedDeadlineExceeded
            raise InjectedDeadlineExceeded(msg)
        if kind == "oom":
            raise TpuRetryOOM(msg)
        if kind == "ioerror":
            raise InjectedIOError(msg)
        if kind == "fatal":
            from .failure import InjectedFatalError
            raise InjectedFatalError(msg)
        if kind == "error":
            raise InjectedQueryError(msg)
        if kind == "corrupt":
            path = info.get("path")
            if path and os.path.exists(path):
                _corrupt_block(path)
            return
        raise AssertionError(f"unhandled fault kind {kind} at {site}")


def _corrupt_block(path: str) -> None:
    """Flip one payload byte past the block header (runtime/memory.py
    `_HEADER`), so that the block's crc32 check detects the damage: the
    chaos suite exercises detection, not a simulation of it."""
    from .memory import _HEADER
    size = os.path.getsize(path)
    off = _HEADER.size + 4 if size > _HEADER.size + 4 else max(size - 1, 0)
    with open(path, "r+b") as f:
        f.seek(off)
        b = f.read(1)
        f.seek(off)
        f.write(bytes([b[0] ^ 0xFF]) if b else b"\xff")


class NullInjector:
    """Disabled path: every call is a no-op."""

    enabled = False
    log: tuple = ()

    def has_site(self, site: str) -> bool:
        return False

    def fire(self, site: str, **info) -> None:
        return None


NULL_INJECTOR = NullInjector()


def get_injector(conf: TpuConf):
    """The injector armed for this conf (cached on the conf instance, so
    hit counters are stable for the conf's lifetime), or NULL_INJECTOR
    when no fault spec is set."""
    inj = getattr(conf, "_fault_injector", None)
    if inj is None:
        spec = str(conf.get(TEST_FAULTS) or "")
        inj = FaultInjector(spec) if spec.strip() else NULL_INJECTOR
        conf._fault_injector = inj
    return inj


# The ACTIVE injector: sites with no conf in reach report here.  Installed
# for the duration of a query's scope (plan/overrides.py PhysicalQuery.
# collect); the binding is thread-local with a single-active-scope
# process fallback, so concurrent queries cannot arm each other's rules.
_TLS_ACTIVE = threading.local()
_ACTIVE_LOCK = threading.Lock()
_ACTIVE_SET: dict = {}           # id(injector) -> injector, in scope
_FALLBACK: object = NULL_INJECTOR


def set_active(injector) -> None:
    global _FALLBACK
    prev = getattr(_TLS_ACTIVE, "injector", None)
    _TLS_ACTIVE.injector = injector
    with _ACTIVE_LOCK:
        if prev is not None and getattr(prev, "enabled", False):
            _ACTIVE_SET.pop(id(prev), None)
        if getattr(injector, "enabled", False):
            _ACTIVE_SET[id(injector)] = injector
        _FALLBACK = (next(iter(_ACTIVE_SET.values()))
                     if len(_ACTIVE_SET) == 1 else NULL_INJECTOR)


def get_active_injector():
    inj = getattr(_TLS_ACTIVE, "injector", None)
    if inj is not None and inj is not NULL_INJECTOR:
        return inj
    return _FALLBACK


def fire_active(site: str, **info) -> None:
    """Fire `site` on the active injector (conf-less call sites)."""
    get_active_injector().fire(site, **info)
