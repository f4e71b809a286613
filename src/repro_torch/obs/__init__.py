"""Unified observability plane: tracing, metrics, and the cache audit log.

Three substrates behind one config (:class:`ObsConfig`) and one holder
(:class:`ObsPlane`, owned by ``CacheService`` and shared by its tenants):

* :mod:`.trace` — per-request traces of nested spans with head-based
  sampling, a bounded span ring, an optional JSONL sink, and explicit
  cross-thread context propagation (shard-miss pool, scan-plane partition
  pool, single-flight leader→follower links, the storage spill worker);
* :mod:`.metrics` — typed Counter/Gauge/Histogram instruments with label
  sets and Prometheus-text / JSON exposition (``CacheService.metrics()``);
  the log-bucketed :class:`~.metrics.LogHistogram` also backs
  ``TenantStats.stage_percentiles`` directly;
* :mod:`.audit` — structured cache-lifecycle events (put / hit /
  derivation-hit / evict / demote / promote / refresh / TTL-expiry /
  morgue-serve) with policy inputs, queryable via ``python -m repro_torch.obs``.

Everything is off the hot path when disabled: an unsampled request pays one
``is None`` check per stage, an un-audited cache one attribute load per
lifecycle call site, and metrics are mirrored from the existing counters at
exposition time rather than double-bumped per request.

Future serving-plane endpoints (an async front door) must
export through this registry and propagate trace context through these
helpers rather than growing new ad-hoc counters.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

from .audit import DEFAULT_CAPACITY as DEFAULT_AUDIT_CAPACITY
from .audit import EVENTS, AuditLog
from .metrics import (BUCKET_BOUNDS, Counter, Gauge, Histogram, LogHistogram,
                      MetricsRegistry)
from .trace import (DEFAULT_RING_CAPACITY, DEFAULT_SAMPLE_RATE, Trace,
                    Tracer, adopt, child_span, current_ctx, span_ctx)

__all__ = [
    "AuditLog", "BUCKET_BOUNDS", "Counter", "EVENTS", "Gauge", "Histogram",
    "LogHistogram", "MetricsRegistry", "ObsConfig", "ObsPlane",
    "PIPELINE_STAGES", "Trace", "Tracer", "adopt", "child_span",
    "current_ctx", "required_stages", "span_ctx", "trace_completeness",
]

# mirrors pipeline.STAGES (not imported: obs must stay import-light and
# dependency-free so every layer can use it); the pipeline's test suite
# pins the two tuples equal
PIPELINE_STAGES = ("canonicalize", "validate", "gate", "lookup", "plan",
                   "execute", "store")


@dataclasses.dataclass(frozen=True)
class ObsConfig:
    """One knob bundle for the whole plane.

    The default is *metrics-only*: exposition works (it mirrors existing
    counters on demand) but no request is traced and no audit event is
    emitted — the zero-overhead production baseline.  ``tracing=True``
    samples ``sample_rate`` of requests head-based (the decision is made
    once, before any span exists); ``audit=True`` turns on lifecycle
    events.  The sinks are append-only JSONL paths, ``None`` = in-memory
    ring only."""

    metrics: bool = True
    tracing: bool = False
    sample_rate: float = DEFAULT_SAMPLE_RATE
    ring_capacity: int = DEFAULT_RING_CAPACITY
    trace_sink: Optional[str] = None
    audit: bool = False
    audit_capacity: int = DEFAULT_AUDIT_CAPACITY
    audit_sink: Optional[str] = None


class ObsPlane:
    """The service-level holder: one tracer + one registry + one audit log
    shared by every tenant of a :class:`~repro_torch.service.CacheService`."""

    def __init__(self, config: Optional[ObsConfig] = None):
        if config is None:
            config = ObsConfig()
        self.config = config
        self.tracer = Tracer(enabled=config.tracing,
                             sample_rate=config.sample_rate,
                             ring_capacity=config.ring_capacity,
                             sink_path=config.trace_sink)
        self.registry = MetricsRegistry()
        self.audit: Optional[AuditLog] = (
            AuditLog(config.audit_capacity, config.audit_sink)
            if config.audit else None)

    def stats(self) -> dict:
        d = {"config": dataclasses.asdict(self.config),
             "tracer": self.tracer.stats()}
        if self.audit is not None:
            d["audit"] = self.audit.stats()
        return d

    def close(self) -> None:
        self.tracer.close()
        if self.audit is not None:
            self.audit.close()


# ------------------------------------------------------ completeness check


def required_stages(provenance: Sequence[str]) -> set:
    """The pipeline stages a result's provenance proves it passed through —
    each must have a matching span in the result's trace."""
    req = set()
    for tok in provenance:
        stage = tok.split(":", 1)[0]
        if stage in PIPELINE_STAGES:
            req.add(stage)
    return req


def trace_completeness(results, tracer: Tracer) -> dict:
    """Audit that every stage named in each traced result's ``provenance``
    has a matching span: the bench's zero-missing-spans criterion, checked
    under both clean and chaos runs.  Results without a ``trace_id``
    (unsampled) are skipped."""
    by_trace: dict[str, set] = {}
    for s in tracer.spans():
        by_trace.setdefault(s["trace"], set()).add(s["name"])
    checked = 0
    missing: list[dict] = []
    for r in results:
        tid = getattr(r, "trace_id", None)
        if tid is None:
            continue
        checked += 1
        names = by_trace.get(tid, set())
        for stage in sorted(required_stages(r.provenance)):
            if stage not in names:
                missing.append({"trace": tid, "stage": stage,
                                "provenance": list(r.provenance),
                                "spans": sorted(names)})
    return {"traces_checked": checked, "missing": missing,
            "missing_count": len(missing), "ok": not missing}
