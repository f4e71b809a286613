"""Typed error taxonomy for pipeline failures.

A request that hits a dependency failure never surfaces a raw exception:
it resolves to a ``QueryResult`` whose ``status`` is ``"degraded"`` (a
stale-but-tagged cached answer was served) or ``"error"`` (nothing safe to
serve), carrying a :class:`FailureInfo` that records *where* it failed
(stage), *how* (kind), and what the resilience machinery did about it
(retries used, breaker state, whether a degraded answer was served).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

# failure kinds (the closed vocabulary used by the pipeline):
#   'timeout'       — dependency call exceeded its time budget
#   'deadline'      — the request's own deadline budget expired (shed)
#   'breaker_open'  — failed fast: the dependency's circuit breaker is open
#   'fault'         — an injected chaos-harness failure (FaultError)
#   'io'            — storage/OS-level failure (OSError family)
#   'internal'      — unexpected pipeline-stage exception (contained)
#   'error'         — any other dependency exception
KINDS = ("timeout", "deadline", "breaker_open", "fault", "io", "internal",
         "error")


@dataclasses.dataclass
class FailureInfo:
    """What went wrong for one request, and what resilience did about it."""

    stage: str  # pipeline stage that failed ('canonicalize' | 'execute' | ...)
    kind: str  # one of KINDS
    message: str = ""
    retries: int = 0  # retry attempts spent before giving up
    breaker: Optional[str] = None  # breaker state at failure time, if any
    degraded: bool = False  # a stale/tagged answer was served despite this

    def to_dict(self) -> dict[str, Any]:
        d: dict[str, Any] = {"stage": self.stage, "kind": self.kind}
        if self.message:
            d["message"] = self.message
        if self.retries:
            d["retries"] = self.retries
        if self.breaker is not None:
            d["breaker"] = self.breaker
        if self.degraded:
            d["degraded"] = True
        return d

    def brief(self) -> str:
        return f"{self.stage}:{self.kind}"


def classify(exc: BaseException) -> str:
    """Map an exception to a :data:`KINDS` entry."""
    from .faults import FaultError

    if isinstance(exc, FaultError):
        return "timeout" if exc.point.endswith(".timeout") else "fault"
    if isinstance(exc, TimeoutError):
        return "timeout"
    if isinstance(exc, OSError):
        return "io"
    return "error"
