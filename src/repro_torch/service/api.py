"""Typed request/response envelopes for the batch-first cache service.

The service API replaces the one-schema, one-query-at-a-time middleware
surface with a unified :class:`QueryRequest` (exactly one of ``sql`` | ``nl``
| ``metric_id`` | pre-built ``signature``, plus tenant/scope and consistency
options) and a structured :class:`QueryResult` carrying the served table, the
resolved signature, the provenance chain of pipeline stages the request
passed through, and per-stage timings.  Every request — single or batched,
live or cache-warming — flows through the same staged pipeline
(pipeline.py), so the envelopes below are the *only* request surface.
"""
from __future__ import annotations

import dataclasses
import datetime as _dt
import threading
from typing import Any, Optional, Protocol, Sequence

from ..analysis.sanitizer import make_lock, note_acquire, note_release
from ..obs.metrics import LogHistogram
from ..core.middleware import Backend
from ..core.signature import Filter, OrderKey, Signature, TimeWindow
from ..core.table import ResultTable
from ..resilience.errors import FailureInfo

DEFAULT_TENANT = "default"


class BatchBackend(Backend, Protocol):
    """A backend that can additionally execute a group of signatures as one
    shared scan (``OlapExecutor.execute_batch``).  The miss planner routes
    multi-miss batches through this entry point when present.  The optional
    ``partition=(start_row, end_row)`` bounds the scan to that fact row
    range — ``advance_snapshot(delta=...)`` relies on it for the incremental
    delta scan, so wrappers delegating to an ``OlapExecutor`` must pass it
    through."""

    def execute_batch(
        self, sigs: Sequence[Signature],
        partition: Optional[tuple[int, int]] = None,
    ) -> list[ResultTable]: ...


@dataclasses.dataclass(frozen=True)
class QueryRequest:
    """One unit of work for :meth:`CacheService.submit_batch`.

    Exactly one of ``sql`` / ``nl`` / ``metric_id`` / ``signature`` must be
    set.  ``tenant`` selects the registered tenant (schema + backend + cache
    + policy); ``scope`` further partitions the key space *within* a tenant
    (strict isolation: scoped signatures hash to disjoint keys).  ``now``
    anchors relative-time NL phrases.  ``levels``/``filters``/``time_window``
    /``order_by``/``limit`` parameterize governed ``metric_id`` requests.

    Consistency options: ``read_only`` serves from cache or executes but
    never stores (probe semantics); ``refresh`` skips the cache read and
    re-executes, re-storing the fresh result (forced freshness).

    ``deadline_ms`` is a per-request wall-clock budget: stages check it
    before starting expensive work (the canonicalizer call, a backend
    execute) and shed the request — serving a stale cached answer with
    ``degraded:stale`` provenance when one exists, a typed ``deadline``
    error otherwise — instead of burning backend time on a request whose
    caller has already given up.
    """

    sql: Optional[str] = None
    nl: Optional[str] = None
    metric_id: Optional[str] = None
    signature: Optional[Signature] = None
    tenant: str = DEFAULT_TENANT
    scope: Optional[str] = None
    now: Optional[_dt.date] = None
    # governed metric_id expansion arguments
    levels: tuple[str, ...] = ()
    filters: tuple[Filter, ...] = ()
    time_window: Optional[TimeWindow] = None
    order_by: tuple[OrderKey, ...] = ()
    limit: Optional[int] = None
    # consistency options
    read_only: bool = False
    refresh: bool = False
    # per-request deadline budget (wall-clock milliseconds), None = unbounded
    deadline_ms: Optional[float] = None

    def __post_init__(self):
        forms = [f for f, v in (("sql", self.sql), ("nl", self.nl),
                                ("metric_id", self.metric_id),
                                ("signature", self.signature))
                 if v is not None]
        if len(forms) != 1:
            raise ValueError(
                "QueryRequest needs exactly one of sql | nl | metric_id | "
                f"signature, got {forms or 'none'}")

    @property
    def kind(self) -> str:
        if self.sql is not None:
            return "sql"
        if self.nl is not None:
            return "nl"
        if self.metric_id is not None:
            return "metric"
        return "signature"


@dataclasses.dataclass
class QueryResult:
    """Structured response for one :class:`QueryRequest`.

    ``status`` matches the middleware vocabulary ('hit_exact' | 'hit_rollup'
    | 'hit_filterdown' | 'hit_compose' | 'miss' | 'bypass'), extended by the
    resilience plane with 'degraded' (a dependency failed but a stale cached
    answer was served, explicitly tagged ``degraded:stale`` in provenance)
    and 'error' (a dependency failed and nothing was safe to serve — a typed
    :class:`FailureInfo` in ``error``, never a raw exception).  ``provenance``
    is the ordered chain of pipeline-stage outcomes the request passed
    through (e.g. ``('canonicalize:sql', 'validate:ok', 'lookup:miss',
    'execute:batched', 'store')``); ``timings_ms`` holds per-stage wall time.
    ``batched`` marks misses served by a shared ``execute_batch`` scan;
    ``deduped`` marks requests whose identical in-flight signature was
    executed once for several requesters.
    """

    status: str
    table: Optional[ResultTable]
    signature: Optional[Signature]
    origin: str  # 'sql' | 'nl' | 'metric' | 'signature'
    tenant: str = DEFAULT_TENANT
    bypass_reason: Optional[str] = None
    confidence: Optional[float] = None
    source_origin: Optional[str] = None  # origin of the serving cache entry
    source_snapshot: Optional[str] = None  # data snapshot the served table reflects
    provenance: tuple[str, ...] = ()
    timings_ms: dict[str, float] = dataclasses.field(default_factory=dict)
    batched: bool = False
    deduped: bool = False
    # typed failure record for 'degraded'/'error' (and contained store
    # failures on otherwise-successful requests)
    error: Optional[FailureInfo] = None
    # observability: set when the request was head-sampled — the id of its
    # trace and of the request's root span in it
    trace_id: Optional[str] = None
    span_id: Optional[str] = None

    @property
    def hit(self) -> bool:
        return self.status.startswith("hit")

    @property
    def ok(self) -> bool:
        """Success-or-explicitly-degraded: the availability predicate the
        chaos bench measures.  Only 'error' results are not ok."""
        return self.status != "error"

    def to_dict(self, include_table: bool = False) -> dict[str, Any]:
        d: dict[str, Any] = {
            "status": self.status,
            "tenant": self.tenant,
            "origin": self.origin,
            "signature": None if self.signature is None else self.signature.to_json(),
            "provenance": list(self.provenance),
            "timings_ms": dict(self.timings_ms),
            "batched": self.batched,
            "deduped": self.deduped,
        }
        if self.bypass_reason is not None:
            d["bypass_reason"] = self.bypass_reason
        if self.confidence is not None:
            d["confidence"] = self.confidence
        if self.source_origin is not None:
            d["source_origin"] = self.source_origin
        if self.source_snapshot is not None:
            d["source_snapshot"] = self.source_snapshot
        if self.error is not None:
            d["error"] = self.error.to_dict()
        if self.trace_id is not None:
            d["trace_id"] = self.trace_id
            d["span_id"] = self.span_id
        if include_table and self.table is not None:
            d["table"] = {n: self.table.columns[n].tolist() for n in self.table.names}
        return d


@dataclasses.dataclass
class RefreshReport:
    """Outcome of :meth:`CacheService.advance_snapshot`.

    ``refreshed`` entries were brought current by merging a delta-partition
    aggregate into their cached table (cost proportional to the delta);
    ``recomputed`` entries were non-composable and re-executed over the full
    table; ``dropped`` entries were invalidated without replacement;
    ``unaffected`` closed-window entries stayed untouched.
    ``delta_rows_scanned`` counts fact rows read by the partition-bounded
    delta scan alone; ``recompute_rows_scanned`` counts the full-table rows
    the non-composable fallbacks read (kept separate so the delta metric
    stays proportional to the delta).
    """

    tenant: str
    snapshot_id: str
    appended_rows: int = 0
    refreshed: int = 0
    recomputed: int = 0
    dropped: int = 0
    unaffected: int = 0
    updated_start: Optional[str] = None
    updated_end: Optional[str] = None
    delta_rows_scanned: int = 0
    recompute_rows_scanned: int = 0

    @property
    def affected(self) -> int:
        return self.refreshed + self.recomputed + self.dropped

    def to_dict(self) -> dict[str, Any]:
        d = dataclasses.asdict(self)
        d["affected"] = self.affected
        return d


class ReadWriteGate:
    """Many concurrent readers or one exclusive writer.

    Request threads hold the *read* side around backend executions; dataset-
    mutating lifecycle operations (``advance_snapshot(delta=...)`` appends
    rows and resyncs executor caches) hold the *write* side — a scan can
    never observe half-appended columns or a plan-memo flush mid-execution.
    Writer-preference: an arriving writer blocks new readers, so steady
    traffic cannot starve a refresh."""

    def __init__(self):
        self._cond = threading.Condition()
        self._readers = 0  # guarded-by: self._cond
        self._writer = False  # guarded-by: self._cond
        self._writers_waiting = 0  # guarded-by: self._cond
        # sanitizer pseudo-lock tokens: the gate is held *across* its body
        # (unlike _cond, which is released while waiting), so the held span
        # is reported manually per side; read tokens are per-thread
        self._san_read = threading.local()
        self._san_write = None  # guarded-by: external[only the single gate-holding writer touches it]

    def acquire_read(self) -> None:
        with self._cond:
            while self._writer or self._writers_waiting:
                self._cond.wait()
            self._readers += 1
        self._san_read.token = note_acquire("ReadWriteGate.read", shared=True)

    def release_read(self) -> None:
        note_release(getattr(self._san_read, "token", None))
        self._san_read.token = None
        with self._cond:
            self._readers -= 1
            if not self._readers:
                self._cond.notify_all()

    def acquire_write(self) -> None:
        with self._cond:
            self._writers_waiting += 1
            try:
                while self._writer or self._readers:
                    self._cond.wait()
            finally:
                self._writers_waiting -= 1
            self._writer = True
        self._san_write = note_acquire("ReadWriteGate.write")

    def release_write(self) -> None:
        note_release(self._san_write)
        self._san_write = None
        with self._cond:
            self._writer = False
            self._cond.notify_all()

    class _Side:
        __slots__ = ("_acquire", "_release")

        def __init__(self, acquire, release):
            self._acquire, self._release = acquire, release

        def __enter__(self):
            self._acquire()

        def __exit__(self, *exc):
            self._release()
            return False

    @property
    def read(self) -> "ReadWriteGate._Side":
        return self._Side(self.acquire_read, self.release_read)

    @property
    def write(self) -> "ReadWriteGate._Side":
        return self._Side(self.acquire_write, self.release_write)


@dataclasses.dataclass
class TenantStats:
    """Per-tenant service counters (cache-level counters live in
    ``SemanticCache.stats``).  A superset of the legacy ``MiddlewareStats``
    fields so middleware shims can expose it unchanged.

    ``stage_timings`` holds one log-bucketed :class:`LogHistogram` per
    pipeline stage (constant memory, never forgets old samples — it replaced
    the bounded sample deques) so ``stage_percentiles`` can report front-end
    p50/p95, and ``CacheService.metrics()`` can export the full distribution.

    Thread safety: the service runs request batches on concurrent caller
    threads (the sharded-cluster regime), so counters are bumped through
    :meth:`bump` and the latency reservoirs are guarded by an internal lock —
    plain field *reads* stay lock-free (single int loads are atomic under the
    GIL; momentarily torn cross-field views are acceptable for stats)."""

    requests: int = 0  # guarded-by: self._lock
    batches: int = 0  # guarded-by: self._lock
    bypasses: int = 0  # guarded-by: self._lock
    nl_gated: int = 0  # guarded-by: self._lock
    backend_executions: int = 0  # guarded-by: self._lock
    # misses served through a shared execute_batch scan
    batched_misses: int = 0  # guarded-by: self._lock
    # in-batch duplicates coalesced onto one execution
    deduped_misses: int = 0  # guarded-by: self._lock
    # cross-thread misses served by another's flight
    coalesced_misses: int = 0  # guarded-by: self._lock
    stores: int = 0  # guarded-by: self._lock
    # resilience counters: retry attempts spent on failing executes, requests
    # served degraded (stale-but-tagged), requests shed on deadline, requests
    # that ended in a typed error, and contained cache-store failures
    retries: int = 0  # guarded-by: self._lock
    degraded: int = 0  # guarded-by: self._lock
    shed: int = 0  # guarded-by: self._lock
    failures: int = 0  # guarded-by: self._lock
    store_errors: int = 0  # guarded-by: self._lock
    stage_timings: dict = dataclasses.field(  # guarded-by: self._lock
        default_factory=dict, repr=False, compare=False)
    _lock: threading.Lock = dataclasses.field(
        default_factory=lambda: make_lock("TenantStats._lock"),
        init=False, repr=False, compare=False)

    def bump(self, **deltas: int) -> None:
        """Atomically add to one or more counter fields.  ``x += n`` on a
        shared dataclass field is a read-modify-write race under threads;
        every pipeline/service increment goes through here instead."""
        with self._lock:
            for name, delta in deltas.items():
                setattr(self, name, getattr(self, name) + delta)

    def record_stage_timings(self, timings_ms: dict[str, float]) -> None:
        with self._lock:
            for stage, ms in timings_ms.items():
                h = self.stage_timings.get(stage)
                if h is None:
                    h = self.stage_timings[stage] = LogHistogram()
                h.observe(ms)

    def stage_percentiles(self) -> dict[str, dict[str, float]]:
        """p50/p95 per pipeline stage, from the stage histograms.  Quantiles
        use the proper zero-indexed rank ``q * (n - 1)`` (the old sorted-
        window ``int(len * 0.95)`` index overshot on small sample counts)."""
        out: dict[str, dict[str, float]] = {}
        for stage, h in self.stage_histograms().items():
            if not h.count:
                continue
            out[stage] = {
                "p50_ms": h.quantile(0.5),
                "p95_ms": h.quantile(0.95),
                "n": h.count,
            }
        return out

    def stage_histograms(self) -> dict[str, LogHistogram]:
        """Consistent snapshots of the per-stage histograms — the metrics
        registry adopts these wholesale at exposition time."""
        with self._lock:
            return {stage: h.snapshot()
                    for stage, h in self.stage_timings.items()}

    def to_dict(self) -> dict:
        # field loop instead of dataclasses.asdict: the raw sample windows
        # and the lock are implementation details (and deques are not JSON);
        # asdict would deep-copy thousands of retained samples just to drop
        # them
        d = {f.name: getattr(self, f.name) for f in dataclasses.fields(self)
             if f.name not in ("stage_timings", "_lock")}
        d["stages_ms"] = self.stage_percentiles()
        return d
