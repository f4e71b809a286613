"""Resilience primitives: deadlines, deterministic backoff, circuit breakers.

These are the mechanisms the chaos harness (:mod:`.faults`) proves out:

* :class:`Deadline` — a monotonic per-request budget carried on
  ``QueryRequest.deadline_ms``; stages check it before starting expensive
  work and shed (or serve degraded) instead of burning a dead request's
  backend time.
* :func:`backoff_delays` — exponential backoff with *deterministic* jitter
  (hash-derived, salted by the retried key), so retry schedules are
  replayable under the chaos harness just like the faults themselves.
* :class:`CircuitBreaker` — the classic closed -> open -> half-open state
  machine, one instance per unreliable dependency (canonicalizer, backend,
  cold tier).  ``allow()`` is the admission check; ``record_success`` /
  ``record_failure`` drive the transitions.  After ``recovery_s`` an open
  breaker admits ``half_open_probes`` probe requests: one success closes it,
  one failure re-opens it.
"""
from __future__ import annotations

import hashlib
import time
from typing import Optional

from ..analysis.sanitizer import make_lock


def hash01(salt: str, n: int) -> float:
    """Deterministic uniform draw in [0, 1) from (salt, n)."""
    h = hashlib.sha256(f"{salt}|{n}".encode()).digest()
    return int.from_bytes(h[:8], "big") / 2**64


def backoff_delays(attempts: int, base_s: float, max_s: float,
                   salt: str = "") -> list[float]:
    """The ``attempts - 1`` sleep intervals between retry attempts:
    ``min(max_s, base_s * 2**i)`` scaled by jitter in [0.5, 1.5)."""
    out = []
    for i in range(max(attempts - 1, 0)):
        d = min(max_s, base_s * (2.0 ** i))
        out.append(d * (0.5 + hash01(salt, i)))
    return out


class Deadline:
    """A wall-clock budget anchored at creation (monotonic clock)."""

    __slots__ = ("at",)

    def __init__(self, at: float):
        self.at = at

    @classmethod
    def after_ms(cls, ms: float) -> "Deadline":
        return cls(time.monotonic() + ms / 1e3)

    @property
    def expired(self) -> bool:
        return time.monotonic() >= self.at

    def remaining_s(self) -> float:
        return max(self.at - time.monotonic(), 0.0)


class CircuitBreaker:
    """Per-dependency circuit breaker with half-open probing.

    Thread-safe behind a leaf lock (nothing else is acquired while holding
    it).  ``clock`` is injectable so tests can step recovery time without
    sleeping."""

    def __init__(self, name: str, *, failure_threshold: int = 5,
                 recovery_s: float = 1.0, half_open_probes: int = 1,
                 clock=time.monotonic):
        self.name = name
        self.failure_threshold = int(failure_threshold)
        self.recovery_s = float(recovery_s)
        self.half_open_probes = int(half_open_probes)
        self._clock = clock
        self._lock = make_lock("CircuitBreaker._lock")
        self._state = "closed"  # guarded-by: self._lock
        self._failures = 0  # guarded-by: self._lock
        self._opened_at = 0.0  # guarded-by: self._lock
        self._probes = 0  # guarded-by: self._lock
        self.opens = 0  # guarded-by: self._lock
        self.closes = 0  # guarded-by: self._lock
        self.rejections = 0  # guarded-by: self._lock

    # ----------------------------------------------------------- admission
    def allow(self) -> bool:
        """May a request use this dependency right now?  Advances
        open -> half-open once ``recovery_s`` has elapsed."""
        with self._lock:
            if self._state == "closed":
                return True
            if self._state == "open":
                if self._clock() - self._opened_at < self.recovery_s:
                    self.rejections += 1
                    return False
                self._state = "half_open"
                self._probes = 0
            # half-open: admit a bounded number of probes
            if self._probes < self.half_open_probes:
                self._probes += 1
                return True
            self.rejections += 1
            return False

    # --------------------------------------------------------- transitions
    def record_success(self) -> None:
        with self._lock:
            self._failures = 0
            if self._state != "closed":
                self._state = "closed"
                self.closes += 1

    def record_failure(self) -> None:
        with self._lock:
            if self._state == "half_open":
                # a failed probe re-opens immediately (fresh recovery window)
                self._state = "open"
                self._opened_at = self._clock()
                self.opens += 1
                return
            self._failures += 1
            if self._state == "closed" and \
                    self._failures >= self.failure_threshold:
                self._state = "open"
                self._opened_at = self._clock()
                self.opens += 1

    # ------------------------------------------------------- introspection
    @property
    def state(self) -> str:
        with self._lock:
            return self._state

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "name": self.name,
                "state": self._state,
                "failures": self._failures,
                "opens": self.opens,
                "closes": self.closes,
                "rejections": self.rejections,
            }


def run_with_retry(fn, *, attempts: int, base_s: float, max_s: float,
                   salt: str = "", sleep=time.sleep,
                   retryable=(Exception,),
                   on_retry=None) -> tuple[object, int, Optional[BaseException]]:
    """Run ``fn()`` up to ``attempts`` times with backoff between failures.

    Returns ``(result, retries_used, last_error)``: ``last_error`` is None on
    success.  ``on_retry(attempt, error)`` is called before each re-attempt
    (for counters).  Intended for idempotent stages only."""
    delays = backoff_delays(attempts, base_s, max_s, salt)
    err: Optional[BaseException] = None
    for attempt in range(max(attempts, 1)):
        try:
            return fn(), attempt, None
        except retryable as e:  # noqa: PERF203 — retry loop by design
            err = e
            if attempt + 1 < attempts:
                if on_retry is not None:
                    on_retry(attempt, e)
                sleep(delays[attempt])
    return None, max(attempts, 1) - 1, err
