"""Deterministic, seedable fault injection (the chaos harness).

Every failure mode the resilience plane defends against has a **named
injection point** at the exact stage boundary where the real failure would
surface:

====================== ====================================================
point                  where it fires / what it simulates
====================== ====================================================
canonicalize.timeout   the LLM canonicalizer call hangs past its deadline
canonicalize.garbage   the model returns malformed JSON
canonicalize.lowconf   the model returns a far-below-threshold confidence
backend.error          ``execute``/``execute_batch`` raises
backend.latency        a backend latency spike (injected sleep)
backend.partial        one scan-plane partition worker dies mid-batch
flight.leader_death    a single-flight leader dies mid-execute
storage.wal_enospc     WAL append fails with ``OSError(ENOSPC)``
storage.wal_oserror    WAL append fails with a generic ``OSError``
storage.wal_torn       WAL append writes half a frame, then fails (torn line)
storage.sha_corrupt    a cold payload read fails sha verification
storage.spill_error    the spill worker's payload write raises
storage.spill_death    the spill worker thread dies (claim left queued)
coldtier.read_error    a cold-tier payload read raises ``OSError``
====================== ====================================================

Activation is via ``REPRO_FAULTS="point:rate[:seed]"`` (comma-separated for
several points; ``rate`` accepts ``0.1`` or ``10%``; a trailing ``*``
prefix-matches, e.g. ``storage.*:5%:7``), or programmatically via
:func:`install` / :func:`scoped` for tests and benches.

Determinism: draws are **counter-based**, not wall-clock- or RNG-state-
based.  The *n*-th arrival at a point fires iff
``sha256(seed | point | n) < rate`` — so a given (spec, arrival-order)
replays identically, independent of thread scheduling between different
points, and a failure seen once in CI can be reproduced locally from the
spec string alone.
"""
from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import os
from typing import Iterator, Optional, Sequence, Union

from ..analysis.sanitizer import make_lock

ENV_VAR = "REPRO_FAULTS"
LATENCY_ENV = "REPRO_FAULT_LATENCY_MS"
DEFAULT_LATENCY_MS = 25.0


class FaultError(RuntimeError):
    """An injected failure.  Carries its injection point so handlers can
    classify it (and tests can assert exactly which point fired)."""

    def __init__(self, point: str, message: Optional[str] = None):
        super().__init__(message or f"injected fault: {point}")
        self.point = point


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One injection rule: fire ``point`` at ``rate`` under ``seed``."""

    point: str
    rate: float
    seed: int = 0

    def matches(self, point: str) -> bool:
        if self.point.endswith("*"):
            return point.startswith(self.point[:-1])
        return self.point == point


def parse(text: str) -> tuple[FaultSpec, ...]:
    """Parse ``"point:rate[:seed],point2:rate2[:seed2]"``."""
    specs = []
    for part in text.split(","):
        part = part.strip()
        if not part:
            continue
        bits = part.split(":")
        if len(bits) not in (2, 3):
            raise ValueError(
                f"bad fault spec {part!r}: expected point:rate[:seed]")
        rate_s = bits[1].strip()
        rate = (float(rate_s[:-1]) / 100.0 if rate_s.endswith("%")
                else float(rate_s))
        if not 0.0 <= rate <= 1.0:
            raise ValueError(f"bad fault rate {rate_s!r} in {part!r}: "
                             "must be in [0, 1] (or 0%..100%)")
        seed = int(bits[2]) if len(bits) == 3 else 0
        specs.append(FaultSpec(bits[0].strip(), rate, seed))
    return tuple(specs)


def _draw(seed: int, point: str, n: int) -> float:
    h = hashlib.sha256(f"{seed}|{point}|{n}".encode()).digest()
    return int.from_bytes(h[:8], "big") / 2**64


class FaultPlan:
    """A compiled set of specs plus per-point arrival counters.

    ``should_fire`` is the single draw primitive: it advances the point's
    arrival counter and evaluates the deterministic hash draw, under a leaf
    lock (no other lock is ever taken while holding it)."""

    def __init__(self, specs: Sequence[FaultSpec] = ()):
        self.specs = tuple(specs)
        self._lock = make_lock("FaultPlan._lock")
        self._arrivals: dict[str, int] = {}  # guarded-by: self._lock
        self._fired: dict[str, int] = {}  # guarded-by: self._lock

    def should_fire(self, point: str) -> bool:
        spec = next((s for s in self.specs if s.matches(point)), None)
        if spec is None:
            return False
        with self._lock:
            n = self._arrivals.get(point, 0)
            self._arrivals[point] = n + 1
            fire = spec.rate > 0.0 and _draw(spec.seed, point, n) < spec.rate
            if fire:
                self._fired[point] = self._fired.get(point, 0) + 1
        return fire

    def counts(self) -> dict:
        with self._lock:
            return {"arrivals": dict(self._arrivals),
                    "fired": dict(self._fired)}


_EMPTY = FaultPlan()


class _Registry:
    """Process-wide active plan: an installed plan wins; otherwise the
    ``REPRO_FAULTS`` env var is compiled (and cached per text value, so
    monkeypatched env changes take effect without an explicit install)."""

    def __init__(self):
        self._lock = make_lock("faults._Registry._lock")
        self._installed: Optional[FaultPlan] = None  # guarded-by: self._lock
        self._env_text: Optional[str] = None  # guarded-by: self._lock
        self._env_plan: FaultPlan = _EMPTY  # guarded-by: self._lock

    def plan(self) -> FaultPlan:
        with self._lock:
            if self._installed is not None:
                return self._installed
            text = os.environ.get(ENV_VAR, "")
            if text != self._env_text:
                self._env_text = text
                self._env_plan = FaultPlan(parse(text)) if text else _EMPTY
            return self._env_plan

    def install(self, plan: Optional[FaultPlan]) -> None:
        with self._lock:
            self._installed = plan
            # force an env re-compile on the next plan() after clear(), so
            # stale counters from a previous env plan never leak across tests
            self._env_text = None
            self._env_plan = _EMPTY


_registry = _Registry()


def install(spec: Union[str, Sequence[FaultSpec]]) -> FaultPlan:
    """Programmatically activate a fault plan (overrides the env var)."""
    plan = FaultPlan(parse(spec) if isinstance(spec, str) else spec)
    _registry.install(plan)
    return plan


def clear() -> None:
    """Deactivate any installed plan (the env var becomes authoritative)."""
    _registry.install(None)


@contextlib.contextmanager
def scoped(spec: Union[str, Sequence[FaultSpec]]) -> Iterator[FaultPlan]:
    """``with faults.scoped("backend.error:1.0"): ...`` for tests/benches."""
    plan = install(spec)
    try:
        yield plan
    finally:
        clear()


def active_plan() -> FaultPlan:
    return _registry.plan()


def should_fire(point: str) -> bool:
    """Advance ``point``'s arrival counter and report whether it fires."""
    return _registry.plan().should_fire(point)


def fire(point: str) -> None:
    """Raise :class:`FaultError` when ``point`` fires."""
    if should_fire(point):
        raise FaultError(point)


def fire_os(point: str, err_no: Optional[int] = None) -> None:
    """Raise ``OSError`` (optionally with ``errno``) when ``point`` fires —
    for IO boundaries whose callers catch/classify ``OSError``."""
    if should_fire(point):
        if err_no is not None:
            raise OSError(err_no, f"injected fault: {point}")
        raise OSError(f"injected fault: {point}")


def latency_s(point: str) -> float:
    """Injected latency-spike duration in seconds (0.0 when not firing).
    Magnitude via ``REPRO_FAULT_LATENCY_MS`` (default 25 ms)."""
    if not should_fire(point):
        return 0.0
    try:
        ms = float(os.environ.get(LATENCY_ENV, DEFAULT_LATENCY_MS))
    except ValueError:
        ms = DEFAULT_LATENCY_MS
    return max(ms, 0.0) / 1e3


def counts() -> dict:
    """Arrival/fired counters of the active plan (observability + tests)."""
    return _registry.plan().counts()
