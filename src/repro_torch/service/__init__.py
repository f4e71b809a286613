"""Service layer: the batch-first, multi-tenant request surface over the
semantic cache — unified QueryRequest/QueryResult envelopes, a staged
request pipeline with per-stage observability, and a miss planner that
routes batched cache misses through the fused shared-scan backend."""

from .api import (Backend, BatchBackend, QueryRequest, QueryResult,
                  RefreshReport, TenantStats, DEFAULT_TENANT)
from .pipeline import STAGES, run_pipeline
from .service import CacheService, Tenant

__all__ = [
    "Backend", "BatchBackend", "CacheService", "DEFAULT_TENANT",
    "QueryRequest", "QueryResult", "RefreshReport", "STAGES", "Tenant",
    "TenantStats", "run_pipeline",
]
