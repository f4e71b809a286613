"""Request tracing: per-request traces of nested spans.

A :class:`Tracer` makes the head-based sampling decision once per request
(``start_trace`` returns a :class:`Trace` handle, or ``None`` when the
request is unsampled / tracing is disabled — the whole request then pays a
single ``is None`` check per stage).  Sampled requests carry the handle on
their pipeline state; every span of the request records through it into one
process-wide bounded ring buffer (plus an optional JSONL sink), so traces
survive the request and late spans — the storage spill worker finishing a
write-behind job after the response went out — still land under their
originating trace id.

Two recording styles, matching how the pipeline is instrumented:

* ``trace.record(name, ...)`` — after-the-fact span from a measured
  duration (the per-stage spans are emitted at finalize time from the same
  ``perf_counter`` timings the pipeline already keeps, so tracing adds no
  second clock read per stage);
* ``span_ctx(trace, name, ...)`` — a *live* span context manager that also
  publishes itself as the calling thread's current span context, which is
  how cross-thread propagation works: the scan plane's partition pool, the
  shard-miss pool, and the spill worker each *adopt* the context captured
  at submit time and hang their child spans under it.

Context propagation is explicit-capture + thread-local-adopt:
``current_ctx()`` reads the calling thread's ``(trace, span_id)`` pair,
``adopt(ctx)`` installs one for a worker's body, and ``child_span(name)``
opens a live span under whatever context is installed (a no-op when none
is — disabled tracing costs one thread-local read at each fan-out point,
nothing on the warm-hit path).

Locking: ``Tracer._lock`` is a leaf — emission happens under shard locks
and inside pool threads, and nothing else is ever acquired while holding
it.
"""
from __future__ import annotations

import itertools
import json
import threading
import time
from collections import deque
from contextlib import contextmanager
from typing import Optional

from ..analysis.sanitizer import make_lock

__all__ = [
    "DEFAULT_SAMPLE_RATE", "Trace", "Tracer", "adopt", "child_span",
    "current_ctx", "span_ctx",
]

DEFAULT_SAMPLE_RATE = 0.01  # head-based: 1 in 100 requests fully traced
DEFAULT_RING_CAPACITY = 4096  # spans retained in memory

# process-wide id source: next() on itertools.count is GIL-atomic, so ids
# are unique across tracers and threads without a lock
_ids = itertools.count(1)
# per-thread current span context: (Trace, span_id) or unset
_tls = threading.local()


def _new_id(prefix: str) -> str:
    return f"{prefix}{next(_ids):010x}"


class Trace:
    """One sampled request's trace handle.

    Thread-safe: followers, pool workers, and the spill worker record spans
    into the leader's trace concurrently (each ``record`` is one append to
    the tracer's lock-guarded ring)."""

    __slots__ = ("tracer", "trace_id", "root_id")

    def __init__(self, tracer: "Tracer", trace_id: str, root_id: str):
        self.tracer = tracer
        self.trace_id = trace_id
        # the root span id is allocated up front so children created *before*
        # the root span is recorded (it lands at finalize) can parent on it
        self.root_id = root_id

    def new_span_id(self) -> str:
        return _new_id("s")

    def record(self, name: str, *, span_id: Optional[str] = None,
               parent_id: Optional[str] = None,
               start_s: Optional[float] = None, dur_ms: float = 0.0,
               attrs: Optional[dict] = None) -> str:
        """Emit one finished span; returns its id."""
        sid = span_id if span_id is not None else self.new_span_id()
        self.tracer.emit({
            "trace": self.trace_id,
            "span": sid,
            "parent": parent_id,
            "name": name,
            "start_s": time.time() if start_s is None else start_s,
            "dur_ms": float(dur_ms),
            "attrs": dict(attrs) if attrs else {},
        })
        return sid

    def ctx(self) -> tuple:
        """The root-span context pair, for ``adopt``/span parenting."""
        return (self, self.root_id)


class Tracer:
    """Sampling decision + the bounded span ring + the optional JSONL sink."""

    def __init__(self, enabled: bool = False,
                 sample_rate: float = DEFAULT_SAMPLE_RATE,
                 ring_capacity: int = DEFAULT_RING_CAPACITY,
                 sink_path: Optional[str] = None):
        self.enabled = bool(enabled)
        self.sample_rate = float(sample_rate)
        self._lock = make_lock("Tracer._lock")
        self._ring: deque = deque(maxlen=ring_capacity)  # guarded-by: self._lock
        self.emitted = 0  # spans ever emitted  # guarded-by: self._lock
        self.sampled = 0  # traces started  # guarded-by: self._lock
        # head sampling as a countdown: one trace per `period` requests
        # (period = round(1/rate); 0 = never).  The pipeline decrements
        # `countdown` inline — per *unsampled* request the whole decision is
        # one integer subtract + compare, the cheapest per-request hook the
        # interpreter allows (even an empty method call measures ~1us in
        # situ on the warm-hit path).  Unlocked by design: a lost decrement
        # under concurrent batches only stretches one sampling interval;
        # stats derive `seen` from (sampled, period, countdown).
        if self.enabled and self.sample_rate > 0.0:
            self.period = (1 if self.sample_rate >= 1.0
                           else max(1, round(1.0 / self.sample_rate)))
        else:
            self.period = 0
        self.countdown = (
            self.period)  # guarded-by: external[benign sampling jitter]
        self._sink = open(sink_path, "a", encoding="utf-8") \
            if sink_path else None  # guarded-by: self._lock
        self.sink_path = sink_path

    # ---------------------------------------------------------- sampling
    def start_trace(self) -> Optional[Trace]:
        """Head-based sampling: the keep/drop decision is made once, here,
        before any span exists.  Returns ``None`` for unsampled requests.
        Deterministic pacing, no RNG: exactly one request per ``period``
        is sampled.

        The batch pipeline inlines this exact countdown (see
        ``run_pipeline``) and only calls :meth:`make_trace` on the sampled
        path; this method is the one-stop form for everything off the warm
        path."""
        if not self.enabled or not self.period:
            return None
        c = self.countdown = self.countdown - 1
        if c > 0:
            return None
        self.countdown = c + self.period
        return self.make_trace()

    def make_trace(self) -> Trace:
        """Allocate a sampled trace handle (the keep decision was already
        made by the caller)."""
        with self._lock:
            self.sampled += 1
        return Trace(self, _new_id("t"), _new_id("s"))

    # ---------------------------------------------------------- emission
    def emit(self, span: dict) -> None:
        line = None if self._sink is None else json.dumps(span, default=str)
        with self._lock:
            self._ring.append(span)
            self.emitted += 1
            if self._sink is not None:
                self._sink.write(line + "\n")

    # ------------------------------------------------------------- reads
    def spans(self, trace_id: Optional[str] = None) -> list[dict]:
        """Snapshot of the retained spans (oldest first), optionally
        filtered to one trace."""
        with self._lock:
            out = list(self._ring)
        if trace_id is not None:
            out = [s for s in out if s["trace"] == trace_id]
        return out

    def trace_ids(self) -> list[str]:
        seen: dict[str, None] = {}
        for s in self.spans():
            seen.setdefault(s["trace"])
        return list(seen)

    def stats(self) -> dict:
        with self._lock:
            return {
                "enabled": self.enabled,
                "sample_rate": self.sample_rate,
                "seen": (self.sampled * self.period
                         + (self.period - self.countdown)
                         if self.period else 0),
                "sampled": self.sampled,
                "spans_emitted": self.emitted,
                "ring_len": len(self._ring),
                "sink": self.sink_path,
            }

    def flush(self) -> None:
        with self._lock:
            if self._sink is not None:
                self._sink.flush()

    def close(self) -> None:
        with self._lock:
            if self._sink is not None:
                self._sink.flush()
                self._sink.close()
                self._sink = None


# ------------------------------------------------- cross-thread propagation


def current_ctx() -> Optional[tuple]:
    """The calling thread's current span context ``(Trace, span_id)``, or
    ``None`` — captured at fan-out points and handed to worker threads."""
    return getattr(_tls, "ctx", None)


@contextmanager
def adopt(ctx: Optional[tuple]):
    """Install a captured span context as this thread's current one for the
    body (pool workers adopting their submitter's context).  ``adopt(None)``
    is a no-op shell."""
    prev = getattr(_tls, "ctx", None)
    _tls.ctx = ctx
    try:
        yield
    finally:
        _tls.ctx = prev


@contextmanager
def span_ctx(trace: Optional[Trace], name: str,
             parent_id: Optional[str] = None,
             attrs: Optional[dict] = None):
    """A live span: yields its span id, publishes itself as the thread's
    current context for the body, and records with the measured duration at
    exit.  ``attrs`` is read at exit, so the body may add outcome fields to
    the dict it passed in.  No-op (yields ``None``) when ``trace`` is."""
    if trace is None:
        yield None
        return
    sid = trace.new_span_id()
    prev = getattr(_tls, "ctx", None)
    _tls.ctx = (trace, sid)
    w0 = time.time()
    t0 = time.perf_counter()
    try:
        yield sid
    finally:
        _tls.ctx = prev
        trace.record(name, span_id=sid, parent_id=parent_id, start_s=w0,
                     dur_ms=(time.perf_counter() - t0) * 1e3, attrs=attrs)


@contextmanager
def child_span(name: str, attrs: Optional[dict] = None):
    """A live span under the thread's current context (no-op without one) —
    the one-liner for instrumenting worker bodies."""
    ctx = getattr(_tls, "ctx", None)
    if ctx is None:
        yield None
        return
    with span_ctx(ctx[0], name, parent_id=ctx[1], attrs=attrs) as sid:
        yield sid
