"""Back-compat middleware shims over the batch-first service (§3.2).

The end-to-end request path — canonicalize, validate, NL-gate, cache lookup
(exact, then roll-up / filter-down derivations), miss execution, store —
lives in the staged pipeline of :mod:`repro_torch.service`.  This module keeps the
original one-schema, one-query surface (``query_sql`` / ``query_nl`` and the
:class:`Response` envelope) as thin shims that submit one-element batches to
a single-tenant :class:`CacheService`, so existing call sites keep working
unchanged while new code talks to the service directly.
"""
from __future__ import annotations

import dataclasses
import datetime as _dt
from typing import TYPE_CHECKING, Optional, Protocol

from .cache import SemanticCache
from .nl_canon import NLCanonicalizer
from .safety import SafetyPolicy
from .schema import StarSchema
from .signature import Signature
from .table import ResultTable

if TYPE_CHECKING:  # pragma: no cover
    from ..service.api import QueryResult


def __getattr__(name: str):
    # Back-compat alias: the service-level per-tenant stats carry the
    # original MiddlewareStats fields (bypasses, nl_gated,
    # backend_executions) and more.  Resolved lazily — the service package
    # imports core submodules, so a module-level import here would be
    # circular when repro_torch.service loads first.
    if name == "MiddlewareStats":
        from ..service.api import TenantStats

        return TenantStats
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


class Backend(Protocol):
    """Any engine that can execute an intent signature (paper: DuckDB; here:
    the PyTorch columnar executor, or raw SQL for out-of-scope bypasses)."""

    def execute(self, sig: Signature) -> ResultTable: ...

    def execute_raw(self, sql: str) -> Optional[ResultTable]: ...


@dataclasses.dataclass
class Response:
    status: str  # 'hit_exact' | 'hit_rollup' | 'hit_filterdown' | 'miss' | 'bypass'
    table: Optional[ResultTable]
    signature: Optional[Signature]
    origin: str  # 'sql' | 'nl'
    bypass_reason: Optional[str] = None
    confidence: Optional[float] = None
    lookup_ms: float = 0.0
    backend_ms: float = 0.0
    canon_ms: float = 0.0
    source_origin: Optional[str] = None  # origin of the serving cache entry

    @property
    def hit(self) -> bool:
        return self.status.startswith("hit")


def _to_response(qr: "QueryResult") -> Response:
    t = qr.timings_ms
    return Response(
        status=qr.status, table=qr.table, signature=qr.signature,
        origin=qr.origin, bypass_reason=qr.bypass_reason,
        confidence=qr.confidence,
        lookup_ms=t.get("lookup", 0.0),
        backend_ms=t.get("execute", 0.0),
        canon_ms=t.get("canonicalize", 0.0) + t.get("validate", 0.0),
        source_origin=qr.source_origin,
    )


class SemanticCacheMiddleware:
    """One-tenant facade over :class:`repro_torch.service.CacheService`."""

    def __init__(
        self,
        schema: StarSchema,
        backend: Backend,
        cache: SemanticCache,
        nl: Optional[NLCanonicalizer] = None,
        policy: SafetyPolicy = SafetyPolicy(),
        snapshot_id: str = "snap0",
    ):
        from ..service.service import CacheService

        self.schema = schema
        self.service = CacheService()
        self._tenant = self.service.register_tenant(
            schema=schema, backend=backend, cache=cache, nl=nl,
            policy=policy, snapshot_id=snapshot_id)
        self.sql_canon = self._tenant.sql_canon
        self.validator = self._tenant.validator
        self.stats = self._tenant.stats

    # The pre-service middleware read these per request, so reassigning
    # them (mw.policy = ..., tests swapping backends) must keep taking
    # effect: forward everything to the live tenant record.
    def _tenant_attr(name: str):  # noqa: N805 — descriptor factory
        def get(self):
            return getattr(self._tenant, name)

        def set_(self, value):
            setattr(self._tenant, name, value)

        return property(get, set_)

    backend = _tenant_attr("backend")
    cache = _tenant_attr("cache")
    nl = _tenant_attr("nl")
    policy = _tenant_attr("policy")
    snapshot_id = _tenant_attr("snapshot_id")
    del _tenant_attr

    def service_stats(self) -> dict:
        """Structured front-end observability for this tenant: per-stage
        p50/p95, template-cache and NL-memo counters, derivation-probe
        counters (see :meth:`repro_torch.service.CacheService.stats`)."""
        return self.service.stats(self._tenant.name)

    # ------------------------------------------------------------------ SQL
    def query_sql(self, sql: str, scope: Optional[str] = None) -> Response:
        from ..service.api import QueryRequest

        return _to_response(self.service.submit(QueryRequest(sql=sql, scope=scope)))

    # ------------------------------------------------------------------- NL
    def query_nl(self, text: str, now: Optional[_dt.date] = None,
                 scope: Optional[str] = None) -> Response:
        from ..service.api import QueryRequest

        return _to_response(
            self.service.submit(QueryRequest(nl=text, now=now, scope=scope)))
