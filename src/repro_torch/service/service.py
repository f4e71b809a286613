"""CacheService — the batch-first, multi-tenant semantic-caching service.

The paper's middleware is a *shared* cache serving many clients over multiple
star schemas.  ``CacheService`` hosts that sharing explicitly: a tenant
registry (schema + backend + cache + safety policy + NL canonicalizer +
governed-metric layer + stats per tenant, with strict key-space isolation),
a batch-first request surface (``submit_batch`` routes all of a dashboard
refresh's cache misses through one shared-scan ``execute_batch`` launch),
and a lifecycle API (``advance_snapshot`` / ``invalidate`` / ``warm``) that
reuses the same staged pipeline as live traffic.

    svc = CacheService()
    svc.register_tenant("analytics", schema=wl.schema,
                        backend=OlapExecutor(wl.dataset), nl=llm)
    results = svc.submit_batch([
        QueryRequest(sql=tile_sql, tenant="analytics") for tile_sql in tiles
    ])
"""
from __future__ import annotations

import dataclasses
from typing import Mapping, Optional, Sequence

from ..analysis.sanitizer import make_lock
from ..cluster import CacheCluster
from ..core.cache import SemanticCache
from ..core.metrics import MetricLayer
from ..core.nl_canon import NLCanonicalizer
from ..core.refresh import merge_tables, refreshable
from ..core.safety import SafetyPolicy
from ..core.schema import StarSchema
from ..core.sql_canon import SQLCanonicalizer
from ..core.validator import SignatureValidator
from ..obs import ObsConfig, ObsPlane
from ..resilience import faults
from ..resilience.policy import ResiliencePolicy, TenantResilience
from .api import (DEFAULT_TENANT, Backend, QueryRequest, QueryResult,
                  ReadWriteGate, RefreshReport, TenantStats)
from .pipeline import run_pipeline


def _accepts_partition(execute_batch) -> bool:
    """True when a backend's ``execute_batch`` supports the ``partition``
    kwarg of the current :class:`BatchBackend` protocol — probed *before*
    appending delta rows, because discovering a pre-partition wrapper via
    TypeError afterwards would leave the grown dataset with a stale cache."""
    if execute_batch is None:
        return False
    import inspect

    try:
        params = inspect.signature(execute_batch).parameters
    except (TypeError, ValueError):  # builtins/C callables: assume current
        return True
    return "partition" in params or any(
        p.kind is inspect.Parameter.VAR_KEYWORD for p in params.values())


@dataclasses.dataclass
class Tenant:
    """One registered tenant: its schema universe and serving machinery."""

    name: str
    schema: StarSchema
    backend: Backend
    cache: "SemanticCache | CacheCluster"
    nl: Optional[NLCanonicalizer]
    policy: SafetyPolicy
    metrics: Optional[MetricLayer]
    # mutated only by lifecycle operations while they hold the exclusive
    # write gate; request threads read it when tagging stores
    snapshot_id: str  # guarded-by: external[tenant ReadWriteGate.write]
    sql_canon: SQLCanonicalizer
    validator: SignatureValidator
    stats: TenantStats
    # read side held around backend executions; write side held while
    # advance_snapshot mutates the dataset under concurrent request threads
    gate: ReadWriteGate = dataclasses.field(default_factory=ReadWriteGate)
    # resilience plane: per-dependency circuit breakers + the tenant's
    # recovery policy (retries, deadlines, stale-on-error)
    resilience: TenantResilience = dataclasses.field(
        default_factory=TenantResilience)
    # observability plane, shared with the owning service (register_tenant
    # overwrites the default); the pipeline reads its tracer per batch
    obs: ObsPlane = dataclasses.field(default_factory=ObsPlane)


class CacheService:
    def __init__(self, obs: "Optional[ObsPlane | ObsConfig]" = None):
        # registration is rare but may race live traffic (an operator adding
        # a tenant while request threads resolve others): writes serialize
        # on _reg_lock; reads are lock-free dict probes (GIL-atomic)
        self._tenants: dict[str, Tenant] = {}  # guarded-by: self._reg_lock
        self._reg_lock = make_lock("CacheService._reg_lock")
        # warm-restart root directory (one store subdir per tenant); set by
        # open(), cleared by close(); reads are lock-free like _tenants
        self._store_path: Optional[str] = None  # guarded-by: self._reg_lock
        self._write_through = True  # guarded-by: self._reg_lock
        # one observability plane for the whole service: every tenant shares
        # its tracer / metrics registry / audit log
        if isinstance(obs, ObsConfig):
            obs = ObsPlane(obs)
        self.obs: ObsPlane = obs if obs is not None else ObsPlane()

    # ----------------------------------------------------------- tenants
    def register_tenant(
        self,
        name: str = DEFAULT_TENANT,
        *,
        schema: StarSchema,
        backend: Backend,
        cache: "Optional[SemanticCache | CacheCluster]" = None,
        nl: Optional[NLCanonicalizer] = None,
        policy: SafetyPolicy = SafetyPolicy(),
        metrics: Optional[MetricLayer] = None,
        snapshot_id: str = "snap0",
        shards: Optional[int] = None,
        resilience: "Optional[ResiliencePolicy | TenantResilience]" = None,
    ) -> Tenant:
        """Register a tenant.  Tenants are isolated structurally (each has
        its own cache instance) and by key space (request ``scope`` is part
        of the signature hash), so one tenant can never serve another's
        entries.

        ``shards=N`` serves the tenant from an N-shard
        :class:`repro_torch.cluster.CacheCluster` (family-partitioned locks,
        single-flight miss dedup, concurrent per-shard miss execution).  A
        plain ``cache=`` template passed alongside it contributes its
        configuration (capacity, derivation flags, level mapper) to every
        shard; ``shards=1`` is behavior-compatible with the unsharded path.
        A pre-built ``CacheCluster`` may also be passed directly as
        ``cache=``.

        ``resilience=`` takes a :class:`ResiliencePolicy` (or a pre-built
        :class:`TenantResilience`) controlling the tenant's recovery
        behavior — retry budgets, circuit-breaker thresholds, deadline
        shedding, stale-on-error serving.  Error *containment* (structured
        degraded/error results, never raw exceptions from the pipeline) is
        unconditional; ``ResiliencePolicy.disabled()`` turns off only the
        recovery machinery."""
        if isinstance(resilience, ResiliencePolicy):
            resilience = TenantResilience(resilience)
        if shards is not None:
            if isinstance(cache, CacheCluster):
                if cache.num_shards != shards:
                    cache.set_shards(shards)
            elif cache is not None:
                cache = CacheCluster.from_template(cache, shards)
            else:
                cache = CacheCluster(schema, shards)
        t = Tenant(
            name=name, schema=schema, backend=backend,
            cache=cache if cache is not None else SemanticCache(schema),
            nl=nl, policy=policy, metrics=metrics, snapshot_id=snapshot_id,
            sql_canon=SQLCanonicalizer(schema),
            validator=SignatureValidator(schema),
            stats=TenantStats(),
            resilience=(resilience if resilience is not None
                        else TenantResilience()),
            obs=self.obs,
        )
        if self.obs.audit is not None:
            set_audit = getattr(t.cache, "set_audit", None)
            if set_audit is not None:
                set_audit(self.obs.audit, tenant=name)
        with self._reg_lock:
            # check-then-insert must be one atomic step: two concurrent
            # registrations of the same name used to both pass the check
            # and silently overwrite each other
            if name in self._tenants:
                raise ValueError(f"tenant {name!r} already registered")
            self._tenants[name] = t
        if self._store_path is not None:
            # the service is open for warm restart: give the new tenant its
            # cold tier right away (replays any prior run's entries)
            self._attach_store(t)
        return t

    def tenant(self, name: str = DEFAULT_TENANT) -> Tenant:
        t = self._tenants.get(name)
        if t is None:
            raise KeyError(f"unknown tenant {name!r}: registered = "
                           f"{sorted(self._tenants)}")
        return t

    def tenants(self) -> list[str]:
        return sorted(self._tenants)

    # ------------------------------------------------------- warm restart
    def open(self, path: str, *, write_through: bool = True) -> dict:
        """Open the service's durable store root: every registered tenant
        (and every tenant registered later) gets a tiered cold store under
        ``<path>/<tenant>/``, replaying whatever a previous run persisted —
        the warm-restart half of the ``open``/``close`` lifecycle.  With
        ``write_through`` (default) stores/refreshes also spill write-behind,
        so a kill loses at most the in-flight spill window, not the working
        set.  Returns ``{tenant: adopted_entry_count}``."""
        import os

        with self._reg_lock:
            self._store_path = os.path.abspath(path)
            self._write_through = write_through
            tenants = list(self._tenants.values())
        return {t.name: self._attach_store(t) for t in tenants}

    def close(self) -> dict:
        """Graceful shutdown of the durable store: spill every hot entry
        (incremental — clean versions cost a metadata record), drain the
        write-behind queue, compact the manifest, and detach.  Returns
        ``{tenant: persisted_entry_count}``."""
        with self._reg_lock:
            self._store_path = None
            tenants = list(self._tenants.values())
        out = {}
        for t in tenants:
            store = getattr(t.cache, "store", None)
            if store is None:
                out[t.name] = 0
                continue
            with t.gate.write:  # exclusive: no request mid-pipeline
                out[t.name] = t.cache.persist_hot()
                t.cache.detach_store()
            store.flush()
            store.close()
        return out

    def _attach_store(self, t: Tenant) -> int:
        """Build + replay this tenant's tiered store and attach it."""
        import os

        from ..storage.engine import TieredStore

        root = self._store_path
        if root is None:
            return 0
        store = TieredStore(os.path.join(root, t.name))
        entries = store.open()
        with t.gate.write:
            return t.cache.attach_store(
                store, entries,
                write_through=getattr(self, "_write_through", True))

    # ----------------------------------------------------------- requests
    def submit(self, request: QueryRequest) -> QueryResult:
        """Single-request convenience wrapper: a one-element batch."""
        return self.submit_batch([request])[0]

    def submit_batch(self, requests: Sequence[QueryRequest]) -> list[QueryResult]:
        """Run a batch through the staged pipeline, preserving order.

        Requests are partitioned by tenant; each tenant partition flows
        through canonicalize -> validate -> gate -> lookup -> plan ->
        execute -> store as one unit, so misses sharing a dataset are
        deduped and executed by a single shared-scan ``execute_batch``
        launch per agg block.
        """
        requests = list(requests)
        by_tenant: dict[str, list[int]] = {}
        for i, r in enumerate(requests):
            by_tenant.setdefault(r.tenant, []).append(i)
        # resolve every tenant before any partition runs: an unknown tenant
        # must reject the whole batch up front, not halfway through with
        # other tenants' side effects already committed
        tenants = {name: self.tenant(name) for name in by_tenant}
        out: list[Optional[QueryResult]] = [None] * len(requests)
        for name, idxs in by_tenant.items():
            results = run_pipeline(tenants[name], [requests[i] for i in idxs])
            for i, res in zip(idxs, results):
                out[i] = res
        return out  # type: ignore[return-value]

    def warm(self, requests: Sequence[QueryRequest]) -> list[QueryResult]:
        """Prefill the cache through the very same pipeline as live traffic
        (canonicalization, validation, and safety gating all apply — warming
        can never plant an entry a live request couldn't have created).
        ``read_only`` requests are rejected since a warm-up that cannot
        store is a no-op."""
        for r in requests:
            if r.read_only:
                raise ValueError("warm() requests must allow stores "
                                 "(read_only=True is a no-op for warming)")
        return self.submit_batch(requests)

    # ---------------------------------------------------------- lifecycle
    def advance_snapshot(
        self,
        tenant: str = DEFAULT_TENANT,
        snapshot_id: str = "",
        updated_start: Optional[str] = None,
        updated_end: Optional[str] = None,
        *,
        delta: Optional[Mapping] = None,
        refresh: bool = True,
        recompute_fallbacks: bool = True,
    ) -> RefreshReport:
        """New data arrived for a tenant: ingest it and bring the cache
        current.

        Without ``delta`` this is the §6.2 drop rule: entries the update can
        affect (open-ended windows always; closed windows only when they
        intersect [updated_start, updated_end)) are invalidated.

        With ``delta`` — a mapping of fact column name to the new rows'
        values — the rows are appended to the backend dataset and affected
        entries are *refreshed in place* instead of dropped: all composable
        affected signatures are executed as one fused batch over just the
        delta partition and their delta tables merged into the cached tables
        (``core.refresh``), so a live dashboard keeps its working set at a
        cost proportional to the delta.  Non-composable affected entries
        (AVG / COUNT DISTINCT / HAVING / ORDER BY / LIMIT) are recomputed
        over the full table (or just dropped when
        ``recompute_fallbacks=False``).  ``refresh=False`` appends the delta
        but applies the plain drop rule — the pre-incremental behavior, kept
        as the benchmark baseline.

        When no update extent is given it is derived from the delta's date
        column, so closed windows outside the ingested date range survive
        untouched.
        """
        t = self.tenant(tenant)
        if delta is None:
            # the snapshot advance (id bump + drop rule) runs under the
            # exclusive write gate: request threads tag stores with
            # t.snapshot_id, and a torn read during the bump would tag a
            # fresh store with a half-advanced snapshot
            with t.gate.write:
                if snapshot_id:
                    t.snapshot_id = snapshot_id
                rep = RefreshReport(
                    tenant=t.name, snapshot_id=t.snapshot_id,
                    updated_start=updated_start, updated_end=updated_end)
                before = len(t.cache)
                rep.dropped = t.cache.invalidate_snapshot(
                    updated_start, updated_end)
                rep.unaffected = before - rep.dropped
                return rep
        ds = getattr(t.backend, "ds", None)
        if ds is None or not hasattr(ds, "append_rows") \
                or not _accepts_partition(getattr(t.backend, "execute_batch", None)):
            # checked before the append: failing *after* rows committed would
            # leave the cache stale relative to the grown dataset
            raise TypeError(
                "advance_snapshot(delta=...) needs an OlapExecutor-style "
                "backend exposing its Dataset as .ds and a partition-capable "
                "execute_batch")
        with t.gate.write:  # exclusive vs request-thread backend scans
            if snapshot_id:
                t.snapshot_id = snapshot_id
            rep = RefreshReport(tenant=t.name, snapshot_id=t.snapshot_id,
                                updated_start=updated_start,
                                updated_end=updated_end)
            return self._advance_with_delta(
                t, rep, ds, delta, updated_start, updated_end,
                refresh=refresh, recompute_fallbacks=recompute_fallbacks)

    def _advance_with_delta(self, t, rep, ds, delta, updated_start,
                            updated_end, *, refresh, recompute_fallbacks):
        """Dataset-mutating half of :meth:`advance_snapshot`; runs under the
        tenant's exclusive write gate so a concurrent request thread can
        never scan half-appended columns or lose its executor plan memos
        mid-execution."""
        part = ds.append_rows(delta, snapshot_id=t.snapshot_id)
        rep.appended_rows = part.num_rows
        # The delta's actual date extent is ground truth: union it with a
        # caller-supplied range so a too-narrow claim can never leave an
        # intersecting entry stale-but-served (ISO strings compare
        # correctly).  A *half-open* caller range stays as given — one
        # missing bound means unknown extent, and affected_keys treats that
        # conservatively (every entry refreshes).
        if part.date_start is not None:
            if updated_start is None and updated_end is None:
                rep.updated_start, rep.updated_end = part.date_start, part.date_end
            elif updated_start is not None and updated_end is not None:
                rep.updated_start = min(updated_start, part.date_start)
                rep.updated_end = max(updated_end, part.date_end)
        affected = t.cache.affected_keys(rep.updated_start, rep.updated_end)
        rep.unaffected = len(t.cache) - len(affected)
        if not refresh:
            for key in affected:
                t.cache.drop(key)
            rep.dropped = len(affected)
            return rep
        # snapshot the affected entries once: under the sharded cluster,
        # concurrent request threads can evict (or a rebalance can migrate) a
        # key between affected_keys() and this loop — a vanished entry simply
        # no longer needs refreshing.  ensure_loaded promotes demoted (cold-
        # tier) entries so the merge below has the actual table; the table is
        # captured here because a later eviction could demote it again.
        loader = getattr(t.cache, "ensure_loaded", t.cache.entry)
        mergeable, fallback = [], []  # lists of (key, entry, table)
        for k in affected:
            e = loader(k)
            if e is None or e.table is None:
                continue
            (mergeable if refreshable(e.signature)
             else fallback).append((k, e, e.table))

        def try_refresh(key, table, merged):
            try:
                t.cache.refresh_entry(key, table, t.snapshot_id, merged=merged)
                return 1
            except KeyError:  # evicted while we were computing its table
                return 0

        if mergeable:
            sigs = [e.signature for _, e, _ in mergeable]
            rows0 = getattr(t.backend, "rows_scanned", 0)
            deltas = t.backend.execute_batch(
                sigs, partition=(part.start_row, part.end_row))
            rep.delta_rows_scanned = getattr(t.backend, "rows_scanned", 0) - rows0
            t.stats.bump(backend_executions=len(sigs))
            for (key, e, base), sig, dtab in zip(mergeable, sigs, deltas):
                merged = merge_tables(sig, base, dtab)
                rep.refreshed += try_refresh(key, merged, True)
        if fallback:
            if recompute_fallbacks:
                sigs = [e.signature for _, e, _ in fallback]
                rows0 = getattr(t.backend, "rows_scanned", 0)
                tables = t.backend.execute_batch(sigs)
                rep.recompute_rows_scanned = \
                    getattr(t.backend, "rows_scanned", 0) - rows0
                t.stats.bump(backend_executions=len(sigs))
                for (key, _, _), table in zip(fallback, tables):
                    rep.recomputed += try_refresh(key, table, False)
            else:
                for key, _, _ in fallback:
                    t.cache.drop(key)
                rep.dropped = len(fallback)
        return rep

    def invalidate(self, tenant: str = DEFAULT_TENANT, *,
                   schema_change: bool = False,
                   updated_start: Optional[str] = None,
                   updated_end: Optional[str] = None) -> int:
        """Explicit invalidation: full drop on schema change, else the same
        window-intersection rule as ``advance_snapshot``."""
        t = self.tenant(tenant)
        if schema_change:
            return t.cache.invalidate_schema_change()
        return t.cache.invalidate_snapshot(updated_start, updated_end)

    # -------------------------------------------------------------- stats
    def stats(self, tenant: Optional[str] = None, *,
              include_entries: bool = False) -> dict:
        """Structured stats: per-tenant service counters (including per-stage
        p50/p95 pipeline latency), cache counters (including derivation
        candidates-scanned vs plans-attempted), per-tier storage gauges
        (hot/cold bytes, promotions, demotions, spill queue depth), and the
        request-plane front-end counters (SQL template cache, NL memo).
        ``include_entries`` adds a capped per-entry summary (age, decayed
        hits, cost, policy score) so eviction inputs are observable."""
        if tenant is not None:
            t = self.tenant(tenant)
            d = {"service": t.stats.to_dict(), "cache": t.cache.stats.to_dict(),
                 "frontend": {"template_cache": t.sql_canon.template_stats()}}
            if t.nl is not None and hasattr(t.nl, "memo_hits"):
                d["frontend"]["nl_memo"] = {
                    "calls": t.nl.calls, "memo_hits": t.nl.memo_hits}
            if hasattr(t.cache, "tier_stats"):
                ts = t.cache.tier_stats()
                store = ts.get("store")
                d["tiers"] = ts
                d["tiers"]["spill_queue_depth"] = (
                    store["spill_queue_depth"] if store else 0)
            if include_entries and hasattr(t.cache, "entries_summary"):
                d["entries"] = t.cache.entries_summary()
            if hasattr(t.cache, "stats_by_shard"):
                d["cluster"] = t.cache.describe()
                d["cluster"]["by_shard"] = t.cache.stats_by_shard()
            if hasattr(t.backend, "stats"):
                # executor counters: totals, memo sizes, per-partition scan
                # accounting when the partition-parallel scan plane is active
                d["backend"] = t.backend.stats()
            return d
        return {name: self.stats(name, include_entries=include_entries)
                for name in self.tenants()}

    # ------------------------------------------------------------ metrics
    _BREAKER_STATES = {"closed": 0.0, "half_open": 1.0, "open": 2.0}

    def metrics(self, fmt: str = "prometheus"):
        """Exposition endpoint for the observability plane: mirror every
        existing counter surface (per-tenant service counters, stage latency
        histograms, cache counters, tier/store gauges, breaker states,
        cluster shard gauges, fault-injection counters, the tracer's and
        audit log's own counters) onto the shared
        :class:`~repro_torch.obs.MetricsRegistry`, then render it.

        Mirroring happens here, at exposition time, from the sources of
        truth that requests already maintain — the request hot path never
        double-bumps a registry instrument.  ``fmt="prometheus"`` returns
        the text exposition format (v0.0.4); ``fmt="json"`` a structured
        dict."""
        self._mirror_metrics()
        reg = self.obs.registry
        if fmt == "prometheus":
            return reg.render_prometheus()
        if fmt == "json":
            return reg.render_json()
        raise ValueError(f"unknown metrics format {fmt!r} "
                         "(expected 'prometheus' or 'json')")

    def _mirror_metrics(self) -> None:
        reg = self.obs.registry
        with self._reg_lock:
            tenants = list(self._tenants.values())
        for t in tenants:
            self._mirror_tenant(reg, t)
        fc = faults.counts()
        arr = reg.counter("fault_arrivals_total",
                          "arrivals at fault-injection points", ("point",))
        fired = reg.counter("fault_fired_total",
                            "faults actually injected", ("point",))
        for point, n in fc["arrivals"].items():
            arr.set_total(n, point=point)
        for point, n in fc["fired"].items():
            fired.set_total(n, point=point)
        tr = self.obs.tracer.stats()
        reg.counter("traces_seen_total",
                    "requests considered for sampling").set_total(tr["seen"])
        reg.counter("traces_sampled_total",
                    "requests traced").set_total(tr["sampled"])
        reg.counter("trace_spans_total",
                    "spans emitted").set_total(tr["spans_emitted"])
        reg.gauge("trace_ring_len",
                  "spans currently buffered").set(tr["ring_len"])
        if self.obs.audit is not None:
            reg.counter("audit_events_total",
                        "cache lifecycle events emitted").set_total(
                self.obs.audit.stats()["emitted"])

    def _mirror_tenant(self, reg, t: Tenant) -> None:
        name = t.name
        svc = t.stats.to_dict()
        svc.pop("stages_ms", None)
        for k, v in svc.items():
            reg.counter(f"service_{k}_total", f"pipeline counter: {k}",
                        ("tenant",)).set_total(v, tenant=name)
        stage_h = reg.histogram("stage_latency_ms",
                                "per-stage pipeline latency",
                                ("tenant", "stage"))
        for stage, hist in t.stats.stage_histograms().items():
            stage_h.merge_snapshot(hist, tenant=name, stage=stage)
        for k, v in t.cache.stats.to_dict().items():
            if k in ("bytes_cached", "bytes_cold", "hit_rate"):
                reg.gauge(f"cache_{k}", f"cache gauge: {k}",
                          ("tenant",)).set(v, tenant=name)
            else:
                reg.counter(f"cache_{k}_total", f"cache counter: {k}",
                            ("tenant",)).set_total(v, tenant=name)
        for k, v in t.sql_canon.template_stats().items():
            if k in ("templates", "bindings"):
                reg.gauge(f"frontend_template_{k}",
                          f"template cache footprint: {k}",
                          ("tenant",)).set(v, tenant=name)
            else:
                reg.counter(f"frontend_template_{k}_total",
                            f"template cache counter: {k}",
                            ("tenant",)).set_total(v, tenant=name)
        if t.nl is not None and hasattr(t.nl, "memo_hits"):
            reg.counter("frontend_nl_calls_total", "NL canonicalizer calls",
                        ("tenant",)).set_total(t.nl.calls, tenant=name)
            reg.counter("frontend_nl_memo_hits_total", "NL memo hits",
                        ("tenant",)).set_total(t.nl.memo_hits, tenant=name)
        breakers = dict(t.resilience.breakers())
        if hasattr(t.cache, "tier_stats"):
            ts = t.cache.tier_stats()
            for k in ("hot_entries", "cold_entries", "hot_bytes",
                      "cold_bytes"):
                reg.gauge(f"tier_{k}", f"tier gauge: {k}",
                          ("tenant",)).set(ts[k], tenant=name)
            store = ts.get("store")
            if store:
                for k, v in store.items():
                    if isinstance(v, bool) or not isinstance(v, (int, float)):
                        continue
                    reg.gauge(f"store_{k}", f"durable store gauge: {k}",
                              ("tenant",)).set(v, tenant=name)
                cold = store.get("cold_breaker")
                if cold is not None:
                    breakers["cold_tier"] = cold
        bstate = reg.gauge("breaker_state",
                           "circuit breaker state: 0=closed 1=half_open "
                           "2=open", ("tenant", "dependency"))
        bopens = reg.counter("breaker_opens_total", "breaker open events",
                             ("tenant", "dependency"))
        brej = reg.counter("breaker_rejections_total",
                           "calls rejected while open",
                           ("tenant", "dependency"))
        for dep, snap in breakers.items():
            bstate.set(self._BREAKER_STATES.get(snap.get("state"), 0.0),
                       tenant=name, dependency=dep)
            bopens.set_total(snap.get("opens", 0), tenant=name,
                             dependency=dep)
            brej.set_total(snap.get("rejections", 0), tenant=name,
                           dependency=dep)
        if hasattr(t.cache, "stats_by_shard"):
            g_entries = reg.gauge("shard_entries", "entries per shard",
                                  ("tenant", "shard"))
            g_inflight = reg.gauge("shard_inflight",
                                   "single-flight leaders per shard",
                                   ("tenant", "shard"))
            for d in t.cache.stats_by_shard():
                g_entries.set(d["entries"], tenant=name,
                              shard=str(d["shard"]))
                g_inflight.set(d["inflight"], tenant=name,
                               shard=str(d["shard"]))

    def health(self, tenant: Optional[str] = None) -> dict:
        """The resilience plane's health surface: per-tenant circuit-breaker
        snapshots (canonicalizer, backend, and the cold tier's breaker when a
        durable store is attached), degraded/failure/retry/shed counters, and
        storage error gauges (spill retries/drops, WAL + cold-read errors).
        ``status`` is ``ok`` when every breaker is closed and nothing is
        degrading, ``degraded`` otherwise — a load balancer's readiness
        probe, not a liveness one (a degraded tenant still serves)."""
        if tenant is not None:
            t = self.tenant(tenant)
            breakers = t.resilience.breakers()
            d: dict = {
                "policy_enabled": t.resilience.policy.enabled,
                "breakers": breakers,
            }
            svc = t.stats.to_dict()
            d["counters"] = {k: svc.get(k, 0) for k in (
                "retries", "degraded", "shed", "failures", "store_errors")}
            storage: dict = {}
            store = getattr(t.cache, "store", None)
            if store is not None and hasattr(store, "stats"):
                ss = store.stats()
                for k in ("spill_errors", "spill_retries", "spill_last_error",
                          "read_errors", "worker_deaths", "wal_append_errors"):
                    if k in ss:
                        storage[k] = ss[k]
                cold = ss.get("cold_breaker")
                if cold is not None:
                    breakers["cold_tier"] = cold
            if storage:
                d["storage"] = storage
            open_breakers = [name for name, b in breakers.items()
                             if b.get("state") != "closed"]
            degrading = bool(open_breakers) \
                or d["counters"]["degraded"] > 0 \
                or storage.get("spill_last_error") is not None
            d["status"] = "degraded" if degrading else "ok"
            d["open_breakers"] = open_breakers
            return d
        return {name: self.health(name) for name in self.tenants()}
