"""The staged request pipeline (one tenant, one batch).

Every request — SQL, NL, governed metric, or pre-built signature; live
traffic or cache warm-up — passes through the same explicit stage sequence:

    canonicalize -> validate -> gate (NL safety) -> lookup -> plan ->
    execute -> store

Stages operate on the whole batch at once, which is what makes the service
batch-first rather than a loop over the single-query path:

* **canonicalize** groups NL requests sharing a ``now`` anchor into one
  ``canonicalize_batch`` call when the canonicalizer supports it (the
  serving engine decodes the whole group in one batched prefill/decode);
* **plan** dedups identical in-flight signatures — one backend execution
  serves every requester of the same intent within the batch;
* **execute** routes multi-miss groups through ``Backend.execute_batch``
  (one shared scan, a single fused kernel launch per agg block) instead of
  N serial ``execute`` calls.

When the tenant's cache is a :class:`repro_torch.cluster.CacheCluster`, the
pipeline additionally becomes concurrency-aware:

* **lookup** runs as one scatter-gather batch (one lock acquisition per
  touched shard) and registers **single-flight** miss deduplication: a miss
  whose signature is already being computed by another thread *joins* that
  flight instead of racing the executor;
* **execute** partitions the batch's miss leaders by shard and runs each
  shard group's ``execute_batch`` concurrently (the backend's plan memos are
  idempotent, and its numpy/PyTorch kernels release the GIL);
* flight **followers** block on the owning flight after local work is done
  and fall back to executing themselves if the leader aborted — coalescing
  is an optimization, never a correctness dependency.

Each stage records its wall time per request; the outcome chain is kept in
``provenance`` so every decision is auditable from the ``QueryResult``.

**Failure containment** (the resilience plane): no dependency failure —
backend execute, canonicalizer call, storage write — escapes
:func:`run_pipeline` as a raw exception.  Failures resolve per-request to a
``status='degraded'`` result (a stale cached answer, explicitly tagged
``degraded:stale``) or a ``status='error'`` result carrying a typed
:class:`FailureInfo` — never a silent wrong answer, never a stack trace for
co-batched innocents.  The tenant's :class:`ResiliencePolicy` adds recovery
on top of containment: retry with backoff for the idempotent execute stage,
per-dependency circuit breakers with half-open probing, per-request deadline
budgets, and stale-on-error serving.  The chaos harness
(:mod:`repro_torch.resilience.faults`) injects failures at each of these
boundaries so every one of those promises is testable deterministically.
"""
from __future__ import annotations

import dataclasses
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Optional, TYPE_CHECKING

from ..core.cache import LookupResult
from ..core.nl_canon import NLResult
from ..core.safety import gate_nl, verify_hit_time_window
from ..core.signature import Signature
from ..core.sql_canon import CanonicalizationError
from ..core.sqlparse import SQLSyntaxError, UnsupportedQuery
from ..obs.trace import Phases, Trace, adopt, adopt_phases, span_ctx
from ..resilience import faults
from ..resilience.errors import FailureInfo, classify
from ..resilience.primitives import Deadline, backoff_delays
from .api import QueryRequest, QueryResult

if TYPE_CHECKING:  # pragma: no cover
    from .service import Tenant

STAGES = ("canonicalize", "validate", "gate", "lookup", "plan", "execute", "store")


@dataclasses.dataclass
class RequestState:
    """Mutable per-request pipeline state threaded through the stages."""

    req: QueryRequest
    origin: str
    sig: Optional[Signature] = None
    nl_res: Optional[NLResult] = None
    status: Optional[str] = None  # None while still flowing; set when decided
    table: object = None
    confidence: Optional[float] = None
    bypass_reason: Optional[str] = None
    source_origin: Optional[str] = None
    source_snapshot: Optional[str] = None
    store: bool = True
    # what the execute stage runs for a bypassed request: the raw SQL text,
    # the (validated) signature, or nothing
    bypass_exec: Optional[str] = None  # 'raw' | 'sig' | None
    batched: bool = False
    deduped: bool = False
    # single-flight state (cluster caches only): the registered flight for a
    # miss, and whether this request owns its computation
    flight: object = None
    flight_leader: bool = False
    stored: bool = False  # entry already put (flight leaders store early)
    # resilience state: the typed failure record (for degraded/error
    # outcomes) and the request's wall-clock budget
    error: Optional[FailureInfo] = None
    deadline: Optional[Deadline] = None
    provenance: list = dataclasses.field(default_factory=list)
    timings: dict = dataclasses.field(default_factory=dict)
    # observability: set when this request was head-sampled.  Stage spans
    # are emitted at finalize time from ``timings``, ``starts`` and
    # ``provenance`` (no second clock read per stage); ``stage_attrs``
    # collects extra span attributes stages want on their finalize-time
    # span (adoption links, resilience outcomes)
    trace: Optional[Trace] = None
    trace_wall0_ns: int = 0  # time.time_ns() at trace start: the spans' anchor
    trace_t0: float = 0.0  # perf_counter at trace start
    starts: dict = dataclasses.field(default_factory=dict)  # stage -> first perf_counter start
    stage_attrs: dict = dataclasses.field(default_factory=dict)

    @property
    def pending(self) -> bool:
        return self.status is None

    def add_ms(self, stage: str, ms: float, t0: Optional[float] = None) -> None:
        """Add ``ms`` to ``stage``; a sampled request also keeps the stage's
        first start ``t0`` (``perf_counter`` seconds)."""
        self.timings[stage] = self.timings.get(stage, 0.0) + ms
        if self.trace is not None and t0 is not None:
            self.starts.setdefault(stage, t0)

    def wall_s(self, t: float) -> float:
        """``perf_counter`` reading ``t`` of a sampled request on the Unix
        epoch (``time.time``, the profiler's clock): the trace's anchor plus
        the offset, so that the two clocks cannot drift apart within it."""
        return (self.trace_wall0_ns + round((t - self.trace_t0) * 1e9)) / 1e9

    def bypass(self, reason: str, exec_mode: Optional[str] = None) -> None:
        self.status = "bypass"
        self.bypass_reason = reason
        self.bypass_exec = exec_mode
        self.store = False
        self.provenance.append(f"bypass:{reason.split(';')[0][:60]}")


def run_pipeline(tenant: "Tenant", requests: list[QueryRequest]) -> list[QueryResult]:
    states = [RequestState(req=r, origin=r.kind) for r in requests]
    for s in states:
        if s.req.deadline_ms is not None:
            s.deadline = Deadline.after_ms(s.req.deadline_ms)
    tracer = tenant.obs.tracer
    if tracer.enabled and tracer.period:
        # head-based sampling: the keep/drop decision is made before any
        # span exists; unsampled requests then pay `s.trace is None` checks
        # and nothing else.  The tracer's countdown is decremented inline
        # (batch-at-once) because this sits on the warm-hit p50 path: the
        # common not-due case is one integer subtract + compare, and only
        # when a sample is due does the batch take the slow path below.
        c = tracer.countdown = tracer.countdown - len(states)
        if c <= 0:
            # one sample per period boundary crossed, taken from the front
            # of the batch (deterministic pacing, one trace per period);
            # the countdown carries the remainder forward
            period = tracer.period
            due = min(len(states), (-c) // period + 1)
            tracer.countdown = c + due * period
            for s in states[:due]:
                s.trace = tracer.make_trace()
                s.trace_wall0_ns = time.time_ns()
                s.trace_t0 = time.perf_counter()
    tenant.stats.bump(requests=len(states), batches=1)
    try:
        for name, stage in (("canonicalize", _stage_canonicalize),
                            ("validate", _stage_validate),
                            ("gate", _stage_gate),
                            ("lookup", _stage_lookup),
                            ("execute", _stage_plan_and_execute),
                            ("store", _stage_store)):
            try:
                stage(tenant, states)
            except Exception as e:  # noqa: BLE001 — containment boundary
                # a stage-level crash must not escape as a raw exception:
                # every still-pending request resolves to a typed error, and
                # the finally below wakes any followers this batch leads
                for s in states:
                    if s.pending:
                        _fail_state(tenant, s, name, "internal",
                                    f"{type(e).__name__}: {e}")
                break
    finally:
        # never strand a follower: if this batch dies mid-pipeline, every
        # flight it leads is failed so waiters wake up and fall back to
        # executing themselves
        fail = getattr(tenant.cache, "fail_flight", None)
        if fail is not None:
            for s in states:
                if s.flight is not None and s.flight_leader and not s.flight.done:
                    fail(s.flight,
                         RuntimeError("pipeline aborted before flight completion"))
    return [_finalize(tenant, s) for s in states]


# ------------------------------------------------------------ failure paths


def _peek_stale(tenant: "Tenant", sig: Optional[Signature]):
    """Best-effort fetch of a TTL-expired cached table for degraded serving.
    Returns None when the cache keeps no stale copy (or cannot peek) — the
    degraded path must itself never raise."""
    if sig is None:
        return None
    peek = getattr(tenant.cache, "peek_stale", None)
    if peek is None:
        return None
    try:
        return peek(sig)
    except Exception:  # noqa: BLE001 — last-resort path, swallow and miss
        return None


def _conclude_failure(tenant: "Tenant", s: RequestState, stage: str,
                      kind: str, message: str, *, retries: int = 0,
                      breaker: Optional[str] = None,
                      shed: bool = False) -> None:
    """Resolve a failed request to a structured outcome: a ``degraded``
    result serving a TTL-expired cached answer (explicitly tagged, never
    silent) when the policy allows and a stale copy exists, else a typed
    ``error`` result.  Either way the caller gets a ``QueryResult`` carrying
    a :class:`FailureInfo` — raw exceptions stop here."""
    info = FailureInfo(stage=stage, kind=kind, message=message,
                       retries=retries, breaker=breaker)
    s.store = False
    s.error = info
    extra = {"shed": 1} if shed else {}
    pol = tenant.resilience.policy
    if pol.enabled and pol.serve_stale and not s.req.refresh:
        stale = _peek_stale(tenant, s.sig)
        if stale is not None:
            info.degraded = True
            s.status = "degraded"
            s.table = stale
            s.provenance.append("degraded:stale")
            s.provenance.append(f"failure:{info.brief()}")
            tenant.stats.bump(degraded=1, **extra)
            return
    s.status = "error"
    s.table = None
    s.provenance.append(f"failure:{info.brief()}")
    tenant.stats.bump(failures=1, **extra)


# the stage-crash containment boundary uses the same conclusion logic
_fail_state = _conclude_failure


# ------------------------------------------------------------- canonicalize


def _stage_canonicalize(tenant: "Tenant", states: list[RequestState]) -> None:
    nl_states = [s for s in states if s.origin == "nl"]
    _canonicalize_nl(tenant, nl_states)
    for s in states:
        if s.origin == "nl":
            continue
        t0 = time.perf_counter()
        try:
            if s.origin == "sql":
                s.sig = tenant.sql_canon.canonicalize(s.req.sql, scope=s.req.scope)
            elif s.origin == "metric":
                if tenant.metrics is None:
                    raise CanonicalizationError("no metric layer configured")
                s.sig = tenant.metrics.expand(
                    s.req.metric_id, levels=s.req.levels, filters=s.req.filters,
                    time_window=s.req.time_window, order_by=s.req.order_by,
                    limit=s.req.limit, scope=s.req.scope)
            else:  # pre-built signature
                s.sig = s.req.signature
                if s.req.scope is not None:
                    s.sig = s.sig.replace(scope=s.req.scope)
        except (UnsupportedQuery, SQLSyntaxError, CanonicalizationError, KeyError) as e:
            s.add_ms("canonicalize", (time.perf_counter() - t0) * 1e3, t0)
            # raw-SQL bypasses still run on the backend; metric/signature
            # failures have nothing safe to execute
            s.bypass(str(e), "raw" if s.origin == "sql" else None)
            continue
        s.add_ms("canonicalize", (time.perf_counter() - t0) * 1e3, t0)
        s.provenance.append(f"canonicalize:{s.origin}")


def _canonicalize_nl(tenant: "Tenant", states: list[RequestState]) -> None:
    if not states:
        return
    if tenant.nl is None:
        for s in states:
            s.add_ms("canonicalize", 0.0)
            s.bypass("no NL canonicalizer configured")
        return
    pol = tenant.resilience.policy
    breaker = tenant.resilience.canonicalizer
    # shed requests whose deadline already expired before spending model time
    live: list[RequestState] = []
    for s in states:
        if pol.enabled and s.deadline is not None and s.deadline.expired:
            _conclude_failure(tenant, s, "canonicalize", "deadline",
                              "deadline expired before canonicalization",
                              shed=True)
        else:
            live.append(s)
    # group by the `now` anchor so each group can share one batched model call
    groups: dict[Optional[str], list[RequestState]] = {}
    for s in live:
        groups.setdefault(s.req.now.isoformat() if s.req.now else None, []).append(s)
    batch_fn = getattr(tenant.nl, "canonicalize_batch", None)
    for group in groups.values():
        now = group[0].req.now
        if pol.enabled and not breaker.allow():
            for s in group:
                s.provenance.append("breaker:open")
                _conclude_failure(tenant, s, "canonicalize", "breaker_open",
                                  "canonicalizer circuit breaker open",
                                  breaker="open")
            continue
        t0 = time.perf_counter()
        try:
            # chaos: a hung/timed-out LLM call surfaces here, before any
            # per-request result exists
            faults.fire("canonicalize.timeout")
            if batch_fn is not None and len(group) > 1:
                results = batch_fn([s.req.nl for s in group], now)
                tag = "canonicalize:nl_batched"
            else:
                results = [tenant.nl.canonicalize(s.req.nl, now) for s in group]
                tag = "canonicalize:nl"
        except Exception as e:  # noqa: BLE001 — containment boundary
            ms = (time.perf_counter() - t0) * 1e3 / len(group)
            if pol.enabled:
                breaker.record_failure()
            for s in group:
                s.add_ms("canonicalize", ms, t0)
                _conclude_failure(
                    tenant, s, "canonicalize", classify(e),
                    f"{type(e).__name__}: {e}",
                    breaker=breaker.state if pol.enabled else None)
            continue
        if pol.enabled:
            breaker.record_success()
        ms = (time.perf_counter() - t0) * 1e3 / len(group)
        for s, res in zip(group, results):
            # chaos: corrupt the model's *output* — garbage JSON loses the
            # signature (bypass, never a wrong cache key); lowconf drops the
            # confidence under the acceptance threshold (gated to bypass)
            if faults.should_fire("canonicalize.garbage"):
                res = dataclasses.replace(
                    res, signature=None, confidence=0.0,
                    error="injected fault: canonicalizer returned garbage")
            elif faults.should_fire("canonicalize.lowconf"):
                res = dataclasses.replace(res, confidence=0.01)
            s.add_ms("canonicalize", ms, t0)
            s.nl_res = res
            s.confidence = res.confidence
            sig = res.signature
            if sig is not None and s.req.scope is not None:
                sig = sig.replace(scope=s.req.scope)
            if sig is None:
                tenant.stats.bump(nl_gated=1)
                s.bypass(res.error or "canonicalization failed")
                continue
            s.sig = sig
            s.provenance.append(tag)


# ----------------------------------------------------------------- validate


def _stage_validate(tenant: "Tenant", states: list[RequestState]) -> None:
    for s in states:
        if not s.pending:
            continue
        t0 = time.perf_counter()
        v = tenant.validator.validate(s.sig)
        s.add_ms("validate", (time.perf_counter() - t0) * 1e3, t0)
        if v:
            s.provenance.append("validate:ok")
            continue
        reason = "; ".join(v.reasons)
        if s.origin == "nl":
            tenant.stats.bump(nl_gated=1)
            s.bypass(reason)  # invalid NL signature: nothing safe to execute
        else:
            # raw SQL still runs on the backend; metric/signature requests
            # have no raw form, so an invalid signature executes nothing
            s.bypass(reason, "raw" if s.origin == "sql" else None)


# --------------------------------------------------------------- NL gating


def _stage_gate(tenant: "Tenant", states: list[RequestState]) -> None:
    for s in states:
        if not s.pending:
            continue
        if s.origin == "nl":
            t0 = time.perf_counter()
            gate = gate_nl(tenant.policy, s.req.nl, s.nl_res, s.req.now)
            s.add_ms("gate", (time.perf_counter() - t0) * 1e3, t0)
            if not gate:
                tenant.stats.bump(nl_gated=1)
                # the signature is schema-valid: the bypass still executes it,
                # it just never touches the cache (§3.5)
                s.bypass("; ".join(gate.reasons), "sig")
                continue
            s.provenance.append("gate:ok")
            s.store = not tenant.policy.sql_seeded_only
        if s.req.read_only:
            s.store = False


# ------------------------------------------------------------------- lookup


def _stage_lookup(tenant: "Tenant", states: list[RequestState]) -> None:
    todo = []
    for s in states:
        if not s.pending:
            continue
        if s.req.refresh:
            # zero-duration timing so the stage still shows up in stage
            # histograms and gets its finalize-time span (the provenance
            # token proves the request passed through lookup)
            s.add_ms("lookup", 0.0)
            s.provenance.append("lookup:skipped_refresh")
            continue
        todo.append(s)
    if not todo:
        return
    batch_fn = getattr(tenant.cache, "lookup_or_flight_batch", None)
    if batch_fn is not None:
        # cluster cache: scatter-gather over shards (one lock acquisition per
        # touched shard) with atomic single-flight registration for misses
        t0 = time.perf_counter()
        triples = batch_fn([
            (s.sig, "nl" if s.origin == "nl" else "sql") for s in todo])
        ms = (time.perf_counter() - t0) * 1e3 / len(todo)
        for s, (lr, flight, leader) in zip(todo, triples):
            s.add_ms("lookup", ms, t0)
            _apply_lookup(tenant, s, lr)
            if s.pending:
                s.flight, s.flight_leader = flight, leader
                if leader and flight is not None and s.trace is not None:
                    # publish the sampled leader's trace context on the
                    # flight so followers (this batch or other threads) can
                    # link their adoption back to the leader's trace; the
                    # flight event publication orders the read
                    flight.obs_ctx = s.trace.ctx()
        return
    for s in todo:
        t0 = time.perf_counter()
        lr: LookupResult = tenant.cache.lookup(
            s.sig, request_origin="nl" if s.origin == "nl" else "sql")
        s.add_ms("lookup", (time.perf_counter() - t0) * 1e3, t0)
        _apply_lookup(tenant, s, lr)


def _apply_lookup(tenant: "Tenant", s: RequestState, lr: LookupResult) -> None:
    if lr.status != "miss" and s.origin == "nl" \
            and tenant.policy.verify_time_window and lr.source_key is not None:
        src = tenant.cache.entry(lr.source_key)
        if src is not None and not verify_hit_time_window(s.sig, src.signature):
            # fail safe: treat as miss (no flight was registered for the
            # original hit, so this executes directly in the plan stage)
            lr = LookupResult("miss", None)
    s.provenance.append(f"lookup:{lr.status}")
    if getattr(lr, "tier", None) == "cold":
        # served by a cold-tier promotion: same table, different tier
        s.provenance.append("tier:cold")
    if lr.status != "miss":
        s.status = lr.status
        s.table = lr.table
        s.source_origin = lr.source_origin
        s.source_snapshot = lr.source_snapshot
        if lr.source_snapshot is not None:
            # audit trail: which data snapshot the served table reflects
            s.provenance.append(f"snapshot:{lr.source_snapshot}")


# ---------------------------------------------------- miss planner + execute


def _stage_plan_and_execute(tenant: "Tenant", states: list[RequestState]) -> None:
    """Group the batch's cache misses, dedup identical in-flight signatures,
    and execute the unique ones through ``execute_batch`` shared scans
    (falling back to serial ``execute`` for singleton groups or plain
    backends).  With a sharded cluster cache, miss leaders are partitioned by
    shard and the per-shard groups execute *concurrently*; misses whose
    signature is already in flight on another thread become followers and
    wait for that flight instead of executing.  Bypass executions stay
    per-request — they are out-of-scope by definition and carry no shareable
    signature."""
    followers: list[RequestState] = []
    misses: dict[str, list[RequestState]] = {}
    for s in states:
        if not s.pending:
            continue
        if s.flight is not None and not s.flight_leader:
            followers.append(s)
            s.provenance.append("plan:coalesced")
            continue
        t0 = time.perf_counter()
        # sig.key() is interned: the lookup stage already computed it, so
        # this (and the store stage's re-read) is a dict probe, not a
        # second SHA-256 — the one-hash-per-request invariant is
        # regression-tested via signature.key_hash_computations()
        misses.setdefault(s.sig.key(), []).append(s)
        s.add_ms("plan", (time.perf_counter() - t0) * 1e3, t0)

    leaders = [group[0] for group in misses.values()]
    for group in misses.values():
        if len(group) > 1:
            tenant.stats.bump(deduped_misses=len(group) - 1)
            for s in group[1:]:
                s.deduped = True
                s.provenance.append("plan:deduped")

    # shard-partitioned execution only pays when several shard groups can
    # actually overlap; otherwise (one group, concurrency disabled, plain
    # cache) the single cross-family execute_batch keeps the fused shared
    # scan — one fact-table pass for the whole batch.  A partition-parallel
    # backend (OlapExecutor(partitions=N)) already saturates the device with
    # its own partition pool: splitting leaders across a second shard pool
    # would nest thread pools and break the scan plane's cross-signature
    # scan sharing, so those backends take the single execute_batch
    shard_groups: Optional[list[list[RequestState]]] = None
    shard_of = getattr(tenant.cache, "shard_index", None)
    if len(leaders) > 1 and shard_of is not None \
            and getattr(tenant.cache, "concurrent_misses", False) \
            and hasattr(tenant.backend, "execute_batch") \
            and getattr(tenant.backend, "partitions", 1) == 1:
        by_shard: dict[int, list[RequestState]] = {}
        for s in leaders:
            by_shard.setdefault(shard_of(s.sig), []).append(s)
        if len(by_shard) > 1:
            shard_groups = list(by_shard.values())
    if shard_groups is not None:
        _execute_shard_groups(tenant, shard_groups)
    elif len(leaders) > 1 and hasattr(tenant.backend, "execute_batch"):
        _execute_group_guarded(tenant, leaders)
    else:
        for s in leaders:
            _execute_group_guarded(tenant, [s])
    for group in misses.values():
        lead = group[0]
        if lead.status is None:
            lead.status = "miss"
        for s in group[1:]:
            # dedup followers adopt the leader's outcome wholesale — status,
            # table, and failure record alike (a failed leader must not leave
            # followers pending, and a degraded leader's stale table stays
            # tagged on every requester it serves)
            s.status = lead.status
            s.table = lead.table
            s.batched = lead.batched
            if lead.error is not None:
                s.error = dataclasses.replace(lead.error)
                s.store = False
                s.provenance.append(f"failure:{lead.error.brief()}")
                if lead.status == "degraded":
                    s.provenance.append("degraded:stale")
                    tenant.stats.bump(degraded=1)
                else:
                    tenant.stats.bump(failures=1)

    # resolve this batch's flights so followers (here and on other threads)
    # unblock; then serve our own followers.  Scanned over all states, not
    # just group heads — a flight-owning state can sit at group[1:] when a
    # flightless request with the same key (refresh, NL verify fail-safe)
    # preceded it in the batch, and its flight must still complete.  The
    # leader *stores before the flight deregisters*: once the flight is
    # popped, a concurrent miss on this key starts a fresh computation unless
    # the entry is already resident — and a later stage raising (a bypass
    # execution, say) must not lose the only copy of a result followers
    # adopted with store=False
    complete = getattr(tenant.cache, "complete_flight", None)
    fail = getattr(tenant.cache, "fail_flight", None)
    if complete is not None:
        for s in states:
            if s.flight is not None and s.flight_leader and not s.flight.done:
                if s.status == "miss" and s.table is not None:
                    if s.store:
                        _store_state(tenant, s)
                    complete(s.flight, s.table)
                elif fail is not None:
                    # a failed or degraded leader must not publish its result:
                    # followers adopting a stale table through the flight
                    # would serve it *untagged*.  Fail the flight so waiters
                    # fall back to executing (and tagging) for themselves
                    fail(s.flight, RuntimeError(
                        s.error.brief() if s.error is not None
                        else f"leader resolved {s.status or 'unresolved'}"))
    for s in followers:
        _resolve_follower(tenant, s)

    # bypass executions (raw SQL or a validated-but-gated NL signature); no
    # retries or breaker here — bypasses are out-of-scope by definition —
    # but failures still resolve to structured errors, not raw exceptions
    for s in states:
        if s.status != "bypass" or s.bypass_exec is None:
            continue
        t0 = time.perf_counter()
        try:
            with tenant.gate.read:
                if s.bypass_exec == "raw":
                    s.table = tenant.backend.execute_raw(s.req.sql)
                else:
                    s.table = tenant.backend.execute(s.sig)
        except Exception as e:  # noqa: BLE001 — containment boundary
            s.add_ms("execute", (time.perf_counter() - t0) * 1e3, t0)
            s.status = "error"
            s.table = None
            s.error = FailureInfo(stage="execute", kind=classify(e),
                                  message=f"{type(e).__name__}: {e}")
            s.provenance.append(f"failure:{s.error.brief()}")
            tenant.stats.bump(failures=1)
            continue
        s.add_ms("execute", (time.perf_counter() - t0) * 1e3, t0)
        tenant.stats.bump(backend_executions=1)
        s.provenance.append(f"execute:bypass_{s.bypass_exec}")


def _execute_leader_group(tenant: "Tenant", group: list[RequestState]) -> None:
    """Execute one group of miss leaders: a shared ``execute_batch`` scan
    when the group carries several intents, a single ``execute`` otherwise.
    Counter bumps stay with the callers (concurrent callers must not bump
    from pool threads mid-flight)."""
    partitioned = getattr(tenant.backend, "partitions", 1) > 1
    if len(group) > 1:
        t0 = time.perf_counter()
        with tenant.gate.read:
            tables = tenant.backend.execute_batch([s.sig for s in group])
        batch_ms = (time.perf_counter() - t0) * 1e3
        for s, table in zip(group, tables):
            s.table = table
            s.batched = True
            # the scan is shared: each request is attributed the full batch
            # wall time under 'execute' (not a per-request cost)
            s.add_ms("execute", batch_ms, t0)
            s.provenance.append("execute:batched")
            if partitioned:
                s.provenance.append("execute:partitioned")
    else:
        s = group[0]
        t0 = time.perf_counter()
        with tenant.gate.read:
            s.table = tenant.backend.execute(s.sig)
        s.add_ms("execute", (time.perf_counter() - t0) * 1e3, t0)
        s.provenance.append("execute:single")
        if partitioned:
            s.provenance.append("execute:partitioned")


def _execute_group_guarded(tenant: "Tenant",
                           group: list[RequestState]) -> bool:
    """Run one miss-leader group through the backend behind the full guard
    stack: deadline shed, breaker admission, bounded retry with deterministic
    backoff, and per-leader isolation when a shared batch fails.  Requests
    that cannot be served resolve to degraded/error via
    :func:`_conclude_failure`; returns True when every leader got a table.
    Thread-safe (shard groups call this from pool threads): all counter
    bumps go through the lock-guarded ``TenantStats.bump``."""
    pol = tenant.resilience.policy
    breaker = tenant.resilience.backend
    if pol.enabled:
        live = []
        for s in group:
            if s.deadline is not None and s.deadline.expired:
                # shed: don't spend backend time on an already-dead request
                _conclude_failure(tenant, s, "execute", "deadline",
                                  "deadline expired before execution",
                                  shed=True)
            else:
                live.append(s)
        group = live
        if not group:
            return False
        if not breaker.allow():
            for s in group:
                s.provenance.append("breaker:open")
                _conclude_failure(tenant, s, "execute", "breaker_open",
                                  "backend circuit breaker open",
                                  breaker="open")
            return False
    attempts = max(pol.execute_attempts, 1) if pol.enabled else 1
    salt = group[0].sig.key() if group[0].sig is not None else ""
    delays = backoff_delays(attempts, pol.retry_base_s, pol.retry_max_s, salt)
    err: Optional[BaseException] = None
    retries_used = 0
    # live span on the first sampled leader's trace: it publishes itself as
    # this thread's current context, so the scan plane's partition spans and
    # any write-behind spill hang under it; attrs are finalized before exit
    sampled = next((s for s in group if s.trace is not None), None)
    trace = None if sampled is None else sampled.trace
    eattrs: dict = {"leaders": len(group)}
    with span_ctx(trace, "execute.backend",
                  parent_id=trace.root_id if trace is not None else None,
                  attrs=eattrs) as backend_span:
        for attempt in range(attempts):
            try:
                lat = faults.latency_s("backend.latency")
                if lat:
                    time.sleep(lat)  # injected latency spike, not a failure
                faults.fire("backend.error")
                # the executor's phases of this attempt (obs.trace.phase)
                with adopt_phases(Phases()) as phases:
                    _execute_leader_group(tenant, group)
                _record_phases(group, phases, sampled, backend_span)
                err = None
                break
            except Exception as e:  # noqa: BLE001 — containment boundary
                err = e
                if attempt + 1 < attempts:
                    retries_used += 1
                    tenant.stats.bump(retries=1)
                    time.sleep(delays[attempt])
        eattrs["retries"] = retries_used
        eattrs["ok"] = err is None
        if err is not None:
            eattrs["error"] = f"{type(err).__name__}: {err}"
    if err is None and any(s.flight_leader for s in group) \
            and faults.should_fire("flight.leader_death"):
        # chaos: the single-flight leader dies *after* computing its result
        # but *before* publishing it.  Deliberately not retryable — the
        # point of this fault is that followers coalesced onto the flight
        # must survive via the self-execute fallback, not that the leader
        # quietly recovers.  The backend call itself succeeded, so the
        # breaker is not charged.
        for s in group:
            s.table = None
            s.batched = False
            _conclude_failure(tenant, s, "execute", "fault",
                              "injected fault: flight.leader_death")
        return False
    if err is None:
        if pol.enabled:
            breaker.record_success()
        tenant.stats.bump(backend_executions=len(group))
        if len(group) > 1:
            tenant.stats.bump(batched_misses=len(group))
        if retries_used:
            for s in group:
                s.provenance.append(f"retry:{retries_used}")
        return True
    if pol.enabled:
        breaker.record_failure()
    if len(group) > 1:
        # a shared batch scan may have died on one poisoned signature:
        # isolate and re-run each leader alone so one bad intent cannot
        # take down its co-batched innocents
        ok = True
        for s in group:
            s.provenance.append("execute:isolated_retry")
            ok = _execute_group_guarded(tenant, [s]) and ok
        return ok
    _conclude_failure(tenant, group[0], "execute", classify(err),
                      f"{type(err).__name__}: {err}", retries=retries_used,
                      breaker=breaker.state if pol.enabled else None)
    return False


def _record_phases(group: list[RequestState], phases, sampled,
                   backend_span) -> None:
    """The executor's phase sums as ``execute.<phase>`` timings of every
    request of the group (a shared scan's to each, as ``execute``), and as
    child spans of ``execute.backend`` on the sampled leader's trace."""
    sums = phases.sums()
    for s in group:
        for name, (ms, t0) in sums.items():
            s.add_ms(name, ms, t0)
    if sampled is None:
        return
    attrs = {k: phases.counts.get(k, 0) for k in ("signatures", "groups")}
    for name, (ms, t0) in sums.items():
        a = dict(attrs)
        if name == "execute.fetch":
            a["bytes"] = phases.counts.get("bytes", 0)
        sampled.trace.record(name, parent_id=backend_span,
                             start_s=sampled.wall_s(t0), dur_ms=ms, attrs=a)


def _execute_shard_groups(tenant: "Tenant",
                          groups: list[list[RequestState]]) -> None:
    """Execute per-shard miss groups concurrently (the caller guarantees >= 2
    groups and an opted-in cluster).  Safe because the OlapExecutor's plan
    memos are idempotent, its counters are lock-guarded, and its kernels
    release the GIL during numpy/PyTorch work, so shard groups overlap.  Each
    group fails *independently*: one shard's backend error resolves only
    that group's requests, never its co-batched neighbours."""
    with ThreadPoolExecutor(max_workers=len(groups),
                            thread_name_prefix="shard-miss") as pool:
        futures = [pool.submit(_execute_group_guarded, tenant, g)
                   for g in groups]
        for f, g in zip(futures, groups):
            try:
                f.result()
            except Exception as e:  # noqa: BLE001 — belt and braces: the
                # guarded runner contains failures itself; if it somehow
                # raises, fail only this group's still-pending requests
                for s in g:
                    if s.pending:
                        _conclude_failure(tenant, s, "execute", "internal",
                                          f"{type(e).__name__}: {e}")


def _resolve_follower(tenant: "Tenant", s: RequestState) -> None:
    """Wait for the flight owning this signature; on success adopt its table,
    on leader failure/timeout execute directly (through the same guard
    stack) — coalescing is opportunistic, never load-bearing."""
    timeout = getattr(tenant.cache, "flight_timeout", 30.0)
    t0 = time.perf_counter()
    ok = s.flight.wait(timeout)
    s.add_ms("plan", (time.perf_counter() - t0) * 1e3, t0)
    s.deduped = True
    lctx = getattr(s.flight, "obs_ctx", None)
    if ok and lctx is not None:
        # adoption link, both directions: the follower's plan span names
        # the leader's trace/span, and (if sampled) the leader's trace gets
        # a link span naming the follower's trace
        ltrace, lspan = lctx
        attrs = s.stage_attrs.setdefault("plan", {})
        attrs["adopted_from_trace"] = ltrace.trace_id
        attrs["adopted_from_span"] = lspan
        ltrace.record("flight.adopt", parent_id=lspan, attrs={
            "follower_trace": None if s.trace is None else s.trace.trace_id,
            "key": s.flight.key})
    if ok and s.flight.ok and s.flight.table is not None:
        s.status = "miss"
        s.table = s.flight.table
        # the leader's store is authoritative; a second identical put would
        # only inflate store counters
        s.store = False
        tenant.stats.bump(coalesced_misses=1)
        return
    s.provenance.append("execute:flight_fallback")
    _execute_group_guarded(tenant, [s])
    if s.status is None:
        s.status = "miss"


# -------------------------------------------------------------------- store


def _store_state(tenant: "Tenant", s: RequestState) -> None:
    t0 = time.perf_counter()
    try:
        # adopt the request's root span as the thread context for the put:
        # a write-behind spill enqueued inside lands its worker-side span
        # under this trace (adopt(None) is a no-op shell)
        with adopt(None if s.trace is None else s.trace.ctx()):
            tenant.cache.put(s.sig, s.table,
                             origin="nl" if s.origin == "nl" else "sql",
                             snapshot_id=tenant.snapshot_id,
                             # recompute-cost estimate for the cost-benefit
                             # eviction policy: what this entry's miss
                             # actually paid to execute
                             cost_ms=s.timings.get("execute", 0.0))
    except Exception:  # noqa: BLE001 — a failed store must not fail the
        # request: the table is already in hand, the cache just stays cold
        s.add_ms("store", (time.perf_counter() - t0) * 1e3, t0)
        s.provenance.append("store:error")
        tenant.stats.bump(store_errors=1)
        return
    s.add_ms("store", (time.perf_counter() - t0) * 1e3, t0)
    s.stored = True
    tenant.stats.bump(stores=1)
    s.provenance.append("store")


def _stage_store(tenant: "Tenant", states: list[RequestState]) -> None:
    # keys flight leaders already put at completion time count as stored:
    # one put per key per batch
    stored: set[str] = {s.sig.key() for s in states if s.stored}
    for s in states:
        if s.status != "miss" or not s.store or s.table is None or s.stored:
            continue
        key = s.sig.key()
        if key in stored:
            continue
        stored.add(key)
        _store_state(tenant, s)


# ----------------------------------------------------------------- finalize


def _emit_trace(s: RequestState) -> None:
    """Emit the sampled request's spans: one per pipeline stage it passed
    through, plus the root.  Stage spans come from the union of recorded
    ``timings`` and provenance-derived stage names (a failed execute that
    never recorded a timing still proves its passage via provenance, and
    the error's own stage is always covered), so trace completeness holds
    by construction — including under injected chaos."""
    tr = s.trace
    by_stage: dict[str, list[str]] = {}
    events: list[str] = []
    for tok in s.provenance:
        head = tok.split(":", 1)[0]
        if head in STAGES:
            by_stage.setdefault(head, []).append(tok)
        else:
            events.append(tok)  # resilience/audit tokens: retry, breaker,
            # degraded, failure, snapshot, tier, bypass
    stages = set(s.timings) | set(by_stage)
    if s.error is not None and s.error.stage in STAGES:
        stages.add(s.error.stage)
    # each stage at its first recorded start, lasting its summed timing; a
    # stage with no start (a zero-duration marker, a failure that recorded
    # no timing) at the end of the stage before it
    cursor = s.trace_t0
    for stage in STAGES:
        if stage not in stages:
            continue
        dur = s.timings.get(stage, 0.0)
        attrs: dict = {}
        if stage in by_stage:
            attrs["outcomes"] = by_stage[stage]
        extra = s.stage_attrs.get(stage)
        if extra:
            attrs.update(extra)
        if s.error is not None and s.error.stage == stage:
            attrs["failure_kind"] = s.error.kind
            attrs["failure_message"] = s.error.message
            attrs["degraded"] = s.error.degraded
            if s.error.retries:
                attrs["retries"] = s.error.retries
            if s.error.breaker is not None:
                attrs["breaker"] = s.error.breaker
        if stage == "execute":
            for tok in events:
                if tok.startswith("retry:"):
                    attrs.setdefault("retries", int(tok.split(":", 1)[1]))
        t0 = s.starts.get(stage, cursor)
        tr.record(stage, parent_id=tr.root_id, start_s=s.wall_s(t0),
                  dur_ms=dur, attrs=attrs)
        cursor = max(cursor, t0 + dur / 1e3)
    root_attrs: dict = {
        "status": s.status or "bypass",
        "origin": s.origin,
        "tenant": s.req.tenant,
        "batched": s.batched,
        "deduped": s.deduped,
    }
    if s.sig is not None:
        root_attrs["key"] = s.sig.key()
    if events:
        root_attrs["events"] = events
    tr.record("request", span_id=tr.root_id, start_s=s.wall_s(s.trace_t0),
              dur_ms=(time.perf_counter() - s.trace_t0) * 1e3,
              attrs=root_attrs)


def _finalize(tenant: "Tenant", s: RequestState) -> QueryResult:
    if s.status == "bypass":
        tenant.stats.bump(bypasses=1)
    tenant.stats.record_stage_timings(s.timings)
    if s.trace is not None:
        _emit_trace(s)
    return QueryResult(
        status=s.status or "bypass",
        table=s.table,
        signature=s.sig if s.sig is not None else (
            s.nl_res.signature if s.nl_res is not None else None),
        origin=s.origin,
        tenant=s.req.tenant,
        bypass_reason=s.bypass_reason,
        confidence=s.confidence,
        source_origin=s.source_origin,
        source_snapshot=s.source_snapshot,
        provenance=tuple(s.provenance),
        timings_ms=dict(s.timings),
        batched=s.batched,
        deduped=s.deduped,
        error=s.error,
        trace_id=None if s.trace is None else s.trace.trace_id,
        span_id=None if s.trace is None else s.trace.root_id,
    )
