"""The staged request pipeline for SQL requests (one tenant, one batch).

Every SQL request passes through the stage sequence of the JAX package's
``repro/service/pipeline.py``:

    canonicalize -> validate -> lookup -> plan -> execute -> store

Stages operate on the whole batch at once:

* **plan** dedups identical in-flight signatures — one backend execution
  serves every requester of the same intent within the batch;
* **execute** routes the batch's unique misses through
  ``Backend.execute_batch`` (one shared scan, a single fused kernel launch
  per agg block) instead of N serial ``execute`` calls.

Statuses (``hit_exact`` | ``hit_rollup`` | ``hit_filterdown`` |
``hit_compose`` | ``miss`` | ``bypass``) and provenance strings are those of
the reference pipeline for SQL requests against a plain
:class:`SemanticCache`.  Not ported yet: NL, governed-metric and signature
requests, the sharded cluster cache with single-flight coalescing, the
resilience plane (retries, breakers, deadlines, degraded serving — a
backend failure raises here), the ``read_only``/``refresh`` request
options, tracing and stage histograms.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Optional

from ..analysis.sanitizer import make_lock
from ..core.cache import LookupResult, SemanticCache
from ..core.schema import StarSchema
from ..core.signature import Signature
from ..core.sql_canon import CanonicalizationError, SQLCanonicalizer
from ..core.sqlparse import SQLSyntaxError, UnsupportedQuery
from ..core.table import ResultTable
from ..core.validator import SignatureValidator


@dataclasses.dataclass(frozen=True)
class QueryRequest:
    """One SQL request.  ``scope`` partitions the key space within a tenant
    (scoped signatures hash to disjoint keys)."""

    sql: str
    scope: Optional[str] = None


@dataclasses.dataclass
class QueryResult:
    """Structured response for one :class:`QueryRequest`: the served table,
    the resolved signature, the ordered provenance chain of stage outcomes
    (e.g. ``('canonicalize:sql', 'validate:ok', 'lookup:miss',
    'execute:batched', 'store')``) and per-stage wall times."""

    status: str
    table: Optional[ResultTable]
    signature: Optional[Signature]
    bypass_reason: Optional[str] = None
    source_origin: Optional[str] = None
    source_snapshot: Optional[str] = None
    provenance: tuple[str, ...] = ()
    timings_ms: dict[str, float] = dataclasses.field(default_factory=dict)
    batched: bool = False
    deduped: bool = False

    @property
    def hit(self) -> bool:
        return self.status.startswith("hit")


@dataclasses.dataclass
class TenantStats:
    """Per-tenant service counters (cache-level counters live in
    ``SemanticCache.stats``), bumped atomically through :meth:`bump`."""

    requests: int = 0  # guarded-by: self._lock
    batches: int = 0  # guarded-by: self._lock
    bypasses: int = 0  # guarded-by: self._lock
    backend_executions: int = 0  # guarded-by: self._lock
    # misses served through a shared execute_batch scan
    batched_misses: int = 0  # guarded-by: self._lock
    # in-batch duplicates coalesced onto one execution
    deduped_misses: int = 0  # guarded-by: self._lock
    stores: int = 0  # guarded-by: self._lock
    _lock: threading.Lock = dataclasses.field(
        default_factory=lambda: make_lock("TenantStats._lock"),
        init=False, repr=False, compare=False)

    def bump(self, **deltas: int) -> None:
        with self._lock:
            for name, delta in deltas.items():
                setattr(self, name, getattr(self, name) + delta)


@dataclasses.dataclass
class Tenant:
    """One schema universe and its serving machinery: backend (an
    ``OlapExecutor``), semantic cache, canonicalizer and validator."""

    schema: StarSchema
    backend: object
    cache: SemanticCache
    sql_canon: SQLCanonicalizer
    validator: SignatureValidator
    # data snapshot the stored tables reflect (provenance on later hits)
    snapshot_id: str = "snap0"
    stats: TenantStats = dataclasses.field(default_factory=TenantStats)

    @classmethod
    def create(cls, schema: StarSchema, backend,
               cache: Optional[SemanticCache] = None) -> "Tenant":
        return cls(schema=schema, backend=backend,
                   cache=cache if cache is not None else SemanticCache(schema),
                   sql_canon=SQLCanonicalizer(schema),
                   validator=SignatureValidator(schema))


@dataclasses.dataclass
class RequestState:
    """Mutable per-request pipeline state threaded through the stages."""

    req: QueryRequest
    sig: Optional[Signature] = None
    status: Optional[str] = None  # None while still flowing; set when decided
    table: object = None
    bypass_reason: Optional[str] = None
    source_origin: Optional[str] = None
    source_snapshot: Optional[str] = None
    batched: bool = False
    deduped: bool = False
    provenance: list = dataclasses.field(default_factory=list)
    timings: dict = dataclasses.field(default_factory=dict)

    @property
    def pending(self) -> bool:
        return self.status is None

    def add_ms(self, stage: str, ms: float) -> None:
        self.timings[stage] = self.timings.get(stage, 0.0) + ms

    def bypass(self, reason: str) -> None:
        """Out of the cache's scope: never looked up or stored, but the raw
        SQL still runs on the backend."""
        self.status = "bypass"
        self.bypass_reason = reason
        self.provenance.append(f"bypass:{reason.split(';')[0][:60]}")


def run_pipeline(tenant: Tenant, requests: list[QueryRequest]) -> list[QueryResult]:
    """Run one batch of SQL requests through every stage, preserving order."""
    states = [RequestState(req=r) for r in requests]
    tenant.stats.bump(requests=len(states), batches=1)
    for stage in (_stage_canonicalize, _stage_validate, _stage_lookup,
                  _stage_plan_and_execute, _stage_store):
        stage(tenant, states)
    return [_finalize(tenant, s) for s in states]


def _stage_canonicalize(tenant: Tenant, states: list[RequestState]) -> None:
    for s in states:
        t0 = time.perf_counter()
        try:
            s.sig = tenant.sql_canon.canonicalize(s.req.sql, scope=s.req.scope)
        except (UnsupportedQuery, SQLSyntaxError, CanonicalizationError, KeyError) as e:
            s.add_ms("canonicalize", (time.perf_counter() - t0) * 1e3)
            s.bypass(str(e))  # raw SQL bypasses still run on the backend
            continue
        s.add_ms("canonicalize", (time.perf_counter() - t0) * 1e3)
        s.provenance.append("canonicalize:sql")


def _stage_validate(tenant: Tenant, states: list[RequestState]) -> None:
    for s in states:
        if not s.pending:
            continue
        t0 = time.perf_counter()
        v = tenant.validator.validate(s.sig)
        s.add_ms("validate", (time.perf_counter() - t0) * 1e3)
        if v:
            s.provenance.append("validate:ok")
            continue
        s.bypass("; ".join(v.reasons))


def _stage_lookup(tenant: Tenant, states: list[RequestState]) -> None:
    for s in states:
        if not s.pending:
            continue
        t0 = time.perf_counter()
        lr: LookupResult = tenant.cache.lookup(s.sig, request_origin="sql")
        s.add_ms("lookup", (time.perf_counter() - t0) * 1e3)
        s.provenance.append(f"lookup:{lr.status}")
        if lr.status != "miss":
            s.status = lr.status
            s.table = lr.table
            s.source_origin = lr.source_origin
            s.source_snapshot = lr.source_snapshot
            if lr.source_snapshot is not None:
                # audit trail: which data snapshot the served table reflects
                s.provenance.append(f"snapshot:{lr.source_snapshot}")


def _stage_plan_and_execute(tenant: Tenant, states: list[RequestState]) -> None:
    """Dedup the batch's misses by signature key and execute the unique
    ones: one shared ``execute_batch`` scan when there are several, a
    single ``execute`` otherwise.  Bypassed requests run their raw SQL."""
    misses: dict[str, list[RequestState]] = {}
    for s in states:
        if not s.pending:
            continue
        t0 = time.perf_counter()
        misses.setdefault(s.sig.key(), []).append(s)
        s.add_ms("plan", (time.perf_counter() - t0) * 1e3)
    for group in misses.values():
        if len(group) > 1:
            tenant.stats.bump(deduped_misses=len(group) - 1)
            for s in group[1:]:
                s.deduped = True
                s.provenance.append("plan:deduped")

    leaders = [group[0] for group in misses.values()]
    if len(leaders) > 1 and hasattr(tenant.backend, "execute_batch"):
        t0 = time.perf_counter()
        tables = tenant.backend.execute_batch([s.sig for s in leaders])
        batch_ms = (time.perf_counter() - t0) * 1e3
        for s, table in zip(leaders, tables):
            s.table = table
            s.batched = True
            # the scan is shared: each request is attributed the full batch
            # wall time under 'execute' (not a per-request cost)
            s.add_ms("execute", batch_ms)
            s.provenance.append("execute:batched")
        tenant.stats.bump(backend_executions=len(leaders),
                          batched_misses=len(leaders))
    else:
        for s in leaders:
            t0 = time.perf_counter()
            s.table = tenant.backend.execute(s.sig)
            s.add_ms("execute", (time.perf_counter() - t0) * 1e3)
            s.provenance.append("execute:single")
            tenant.stats.bump(backend_executions=1)
    for group in misses.values():
        lead = group[0]
        lead.status = "miss"
        for s in group[1:]:
            s.status = lead.status
            s.table = lead.table
            s.batched = lead.batched

    for s in states:
        if s.status != "bypass":
            continue
        t0 = time.perf_counter()
        s.table = tenant.backend.execute_raw(s.req.sql)
        s.add_ms("execute", (time.perf_counter() - t0) * 1e3)
        tenant.stats.bump(backend_executions=1)
        s.provenance.append("execute:bypass_raw")


def _stage_store(tenant: Tenant, states: list[RequestState]) -> None:
    stored: set[str] = set()  # one put per key per batch
    for s in states:
        if s.status != "miss" or s.table is None:
            continue
        key = s.sig.key()
        if key in stored:
            continue
        stored.add(key)
        t0 = time.perf_counter()
        tenant.cache.put(s.sig, s.table, origin="sql",
                         snapshot_id=tenant.snapshot_id,
                         # recompute-cost estimate for the cost-benefit
                         # eviction policy: what this miss paid to execute
                         cost_ms=s.timings.get("execute", 0.0))
        s.add_ms("store", (time.perf_counter() - t0) * 1e3)
        tenant.stats.bump(stores=1)
        s.provenance.append("store")


def _finalize(tenant: Tenant, s: RequestState) -> QueryResult:
    if s.status == "bypass":
        tenant.stats.bump(bypasses=1)
    return QueryResult(
        status=s.status or "bypass",
        table=s.table,
        signature=s.sig,
        bypass_reason=s.bypass_reason,
        source_origin=s.source_origin,
        source_snapshot=s.source_snapshot,
        provenance=tuple(s.provenance),
        timings_ms=dict(s.timings),
        batched=s.batched,
        deduped=s.deduped,
    )
