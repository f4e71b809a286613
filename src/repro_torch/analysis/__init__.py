"""Concurrency invariant analysis plane.

Two halves share one set of conventions:

* **Static passes** (`python -m repro_torch.analysis`) — an ``ast``-walk suite
  that proves the ``# guarded-by:`` lock discipline, builds the lock-order
  acquisition digraph and rejects cycles, and flags mutation of interned /
  frozen value types outside construction.  See :mod:`repro_torch.analysis.cli`.
* **Runtime sanitizer** (:mod:`repro_torch.analysis.sanitizer`) — opt-in via
  ``REPRO_SANITIZE=1``; wraps the production locks to record per-thread
  acquisition stacks and assert the observed lock order stays acyclic.

This ``__init__`` re-exports only the sanitizer surface: production modules
import :func:`make_lock` unconditionally on their hot construction paths, so
the heavy static passes must never be pulled in transitively.
"""
from .sanitizer import (  # noqa: F401
    LockOrderViolation,
    SanitizedLock,
    allow_same_class_order,
    make_lock,
    note_acquire,
    note_blocking,
    note_release,
    observed_edges,
    reset,
    sanitize_enabled,
    violations,
)

__all__ = [
    "LockOrderViolation",
    "SanitizedLock",
    "allow_same_class_order",
    "make_lock",
    "note_acquire",
    "note_blocking",
    "note_release",
    "observed_edges",
    "reset",
    "sanitize_enabled",
    "violations",
]
