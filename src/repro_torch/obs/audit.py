"""Cache-lifecycle audit log: structured events for every entry decision.

``SemanticCache`` (and the storage-backed tiering inside it) emits one
:class:`AuditLog` event per lifecycle decision — ``put`` / ``hit`` /
``derivation_hit`` / ``evict`` / ``demote`` / ``promote`` / ``refresh`` /
``ttl_expiry`` / ``morgue_serve`` (plus ``stale_serve`` for degraded reads
out of a live tier, and ``drop`` for explicit invalidation) — carrying the
signature key, the tier it happened on, the *policy inputs* that drove it
(decayed hits, recompute cost, bytes, benefit score for evictions and
demotions), and provenance (origin surface, snapshot id).  Together with
request traces this makes the paper's headline claims auditable after the
fact: why an entry was evicted, which cached entry served a derivation hit,
and whether any hit was served from a key that was not live at serve time
(the false-hit audit) are all answerable from the log alone — see
``python -m repro_torch.obs``.

The emitter is deliberately dumb and cheap: a dict append into a bounded
ring, plus an optional JSONL sink.  The cache holds ``audit=None`` by
default, so the disabled hot path pays a single attribute load per call
site.  With no sink attached (the default), the append path is lock-free:
a ``deque.append`` is a single C-level operation that never runs Python
code mid-step, so it is atomic under the GIL, and the event counter is an ``itertools.count`` (``next()``
is likewise GIL-atomic).  ``hit`` events ride the warm-lookup path, where a
lock round-trip per request is a measurable share of total latency.

Locking: ``AuditLog._lock`` only serializes the optional JSONL sink (and
is a leaf — events are emitted under ``CacheShard.lock`` on the cluster
request path, and nothing is acquired while holding it).
"""
from __future__ import annotations

import itertools
import json
from collections import deque
from typing import Optional

from ..analysis.sanitizer import make_lock

__all__ = ["AuditLog", "EVENTS"]

EVENTS = ("put", "hit", "derivation_hit", "evict", "demote", "promote",
          "refresh", "ttl_expiry", "morgue_serve", "stale_serve", "drop")

DEFAULT_CAPACITY = 4096


class AuditLog:
    """Bounded in-memory ring of lifecycle events + optional JSONL sink."""

    def __init__(self, capacity: int = DEFAULT_CAPACITY,
                 sink_path: Optional[str] = None):
        self._lock = make_lock("AuditLog._lock")
        # bounded-deque append and list() snapshot are single C-level ops;
        # no invariant spans entries
        self._ring: deque = deque(
            maxlen=capacity)  # guarded-by: external[GIL-atomic deque ops]
        # events ever emitted; next() is GIL-atomic, peeked for stats
        self._emitted = itertools.count()
        self._sink = open(sink_path, "a", encoding="utf-8") \
            if sink_path else None  # guarded-by: self._lock
        self.sink_path = sink_path

    def append(self, rec: dict) -> None:
        """Record one pre-built event dict (must carry ``ts``/``event``/
        ``key``).  The hot ``hit`` path builds its record in place and calls
        this directly — with no sink attached this is lock-free (see module
        docstring)."""
        self._ring.append(rec)
        next(self._emitted)
        if self._sink is not None:
            with self._lock:
                self._sink.write(json.dumps(rec, default=str) + "\n")

    def stats(self) -> dict:
        # peek the count without consuming (it pickles as count(current))
        emitted = self._emitted.__reduce__()[1][0]
        return {"emitted": emitted, "ring_len": len(self._ring),
                "sink": self.sink_path}

    def close(self) -> None:
        with self._lock:
            if self._sink is not None:
                self._sink.flush()
                self._sink.close()
                self._sink = None
