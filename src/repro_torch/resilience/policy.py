"""Per-tenant resilience configuration and runtime state.

:class:`ResiliencePolicy` is the knob set (immutable, passed at tenant
registration); :class:`TenantResilience` is the live state — one circuit
breaker per unreliable tenant dependency (the canonicalizer LLM and the
OLAP backend; the cold tier's breaker lives on the :class:`TieredStore`
that owns the disk).  ``enabled=False`` keeps the error *containment*
(structured results, never raw exceptions) but turns off *recovery*
(retries, breakers, stale-on-error serving) — the chaos bench's
"resilience off" baseline.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from .primitives import CircuitBreaker


@dataclasses.dataclass(frozen=True)
class ResiliencePolicy:
    """Resilience knobs for one tenant."""

    enabled: bool = True
    # retry (idempotent stages: backend execute; spill/cold-read retries are
    # configured on the TieredStore)
    execute_attempts: int = 3
    retry_base_s: float = 0.01
    retry_max_s: float = 0.25
    # per-dependency circuit breakers
    breaker_failures: int = 5
    breaker_recovery_s: float = 1.0
    breaker_half_open_probes: int = 1
    # on backend failure, serve a TTL-expired cached answer with explicit
    # 'degraded:stale' provenance instead of an error (never silently)
    serve_stale: bool = True

    @classmethod
    def disabled(cls) -> "ResiliencePolicy":
        return cls(enabled=False)


class TenantResilience:
    """Live resilience state for one tenant: policy + dependency breakers."""

    def __init__(self, policy: Optional[ResiliencePolicy] = None):
        self.policy = policy if policy is not None else ResiliencePolicy()
        p = self.policy
        self.canonicalizer = CircuitBreaker(
            "canonicalizer", failure_threshold=p.breaker_failures,
            recovery_s=p.breaker_recovery_s,
            half_open_probes=p.breaker_half_open_probes)
        self.backend = CircuitBreaker(
            "backend", failure_threshold=p.breaker_failures,
            recovery_s=p.breaker_recovery_s,
            half_open_probes=p.breaker_half_open_probes)

    def breakers(self) -> dict[str, dict]:
        return {
            "canonicalizer": self.canonicalizer.snapshot(),
            "backend": self.backend.snapshot(),
        }
