"""Fault injection & graceful degradation for the cache service.

The paper's contract is *safety-first* — zero false hits under strict
validation — and this package extends that promise off the happy path.  It
has two halves that prove each other out, in the spirit of the lock-order
sanitizer (inject the failure, demonstrate the invariant):

* :mod:`faults` — a deterministic, seedable chaos harness.  Named injection
  points sit on every stage boundary (canonicalize / backend execute /
  storage WAL + payloads + spill worker / cluster single-flight) and are
  activated via ``REPRO_FAULTS="point:rate:seed"``, so every failure test
  and chaos bench run is replayable bit-for-bit.
* :mod:`primitives` + :mod:`policy` — the resilience machinery the
  injections exercise: per-stage deadline budgets, retry with exponential
  backoff + deterministic jitter for idempotent stages (execute, spill,
  cold-tier read), per-dependency circuit breakers (canonicalizer, backend,
  cold tier) with half-open probing, and stale-on-error serving with
  explicit ``degraded:stale`` / ``breaker:open`` provenance — a degraded
  answer is always *tagged*, never a silent wrong answer.

:class:`~repro_torch.resilience.errors.FailureInfo` is the typed error taxonomy
carried on ``QueryResult.error``; ``CacheService.health()`` aggregates the
breaker states and storage error counters.
"""
from . import faults
from .errors import FailureInfo
from .policy import ResiliencePolicy, TenantResilience
from .primitives import CircuitBreaker, Deadline, backoff_delays

__all__ = [
    "CircuitBreaker",
    "Deadline",
    "FailureInfo",
    "ResiliencePolicy",
    "TenantResilience",
    "backoff_delays",
    "faults",
]
