"""One cache shard: a :class:`SemanticCache` behind a fine-grained lock.

A shard is the cluster's unit of concurrency and eviction: it owns a plain
single-threaded ``SemanticCache`` (per-shard behavior is bit-identical to a
standalone cache), an ``RLock`` serializing every cache operation, and the
single-flight registry for misses routed to it.  Lock hold times are the
length of one cache operation — lookups on different shards never contend,
which is where the cluster's multi-thread throughput comes from.
"""
from __future__ import annotations

from typing import Optional, Sequence

from ..analysis.sanitizer import make_lock
from ..core.cache import CacheEntry, LookupResult, SemanticCache
from ..core.signature import Signature
from ..core.table import ResultTable
from .flight import Flight


class CacheShard:
    """A locked ``SemanticCache`` + the single-flight registry for its keys."""

    def __init__(self, index: int, cache: SemanticCache):
        # index is rewritten only by the stop-the-world rebalance, which
        # holds every shard lock
        self.index = index  # guarded-by: external[cluster rebalance holds all shard locks]
        self.cache = cache
        self.lock = make_lock("CacheShard.lock", reentrant=True)
        self._inflight: dict[str, Flight] = {}  # guarded-by: self.lock

    # -------------------------------------------------------------- lookups
    def lookup(self, sig: Signature, request_origin: str = "sql") -> LookupResult:
        with self.lock:
            return self.cache.lookup(sig, request_origin)

    def lookup_batch(
        self, items: Sequence[tuple[Signature, str]]
    ) -> list[LookupResult]:
        """One lock acquisition for a whole shard-local batch."""
        with self.lock:
            return [self.cache.lookup(sig, origin) for sig, origin in items]

    def peek_stale(self, sig: Signature):
        """Degraded-serving read: a possibly-stale table for this signature
        (hot even-if-expired, cold payload, or the TTL morgue), or None."""
        with self.lock:
            return self.cache.peek_stale(sig)

    def lookup_or_flight(
        self, sig: Signature, request_origin: str = "sql"
    ) -> tuple[LookupResult, Optional[Flight], bool]:
        """Atomic lookup + single-flight registration.

        Returns ``(result, flight, leader)``: a hit carries no flight; a miss
        either *creates* a flight (``leader=True`` — the caller must execute
        and resolve it) or *joins* an existing one (``leader=False`` — the
        caller waits on it instead of executing).
        """
        with self.lock:
            lr = self.cache.lookup(sig, request_origin)
            if lr.status != "miss":
                return lr, None, False
            key = sig.key()
            flight = self._inflight.get(key)
            if flight is not None:
                return lr, flight, False
            flight = Flight(key, self)
            self._inflight[key] = flight
            return lr, flight, True

    def lookup_or_flight_batch(
        self, items: Sequence[tuple[Signature, str]]
    ) -> list[tuple[LookupResult, Optional[Flight], bool]]:
        with self.lock:
            return [self.lookup_or_flight(sig, origin) for sig, origin in items]

    # ------------------------------------------------------- flight lifecycle
    def complete_flight(self, flight: Flight, table: Optional[ResultTable]) -> None:
        with self.lock:
            self._inflight.pop(flight.key, None)
            flight._resolve(table, None)

    def fail_flight(self, flight: Flight, error: BaseException) -> None:
        with self.lock:
            self._inflight.pop(flight.key, None)
            flight._resolve(None, error)

    def inflight(self) -> int:
        with self.lock:
            return len(self._inflight)

    # ------------------------------------------------------------- mutation
    def put(self, sig: Signature, table: ResultTable, origin: str = "sql",
            snapshot_id: str = "snap0", *, cost_ms: float = 0.0,
            ttl_s: Optional[float] = None) -> str:
        with self.lock:
            return self.cache.put(sig, table, origin, snapshot_id,
                                  cost_ms=cost_ms, ttl_s=ttl_s)

    def drop(self, key: str) -> bool:
        with self.lock:
            return self.cache.drop(key)

    def refresh_entry(self, key: str, table: ResultTable, snapshot_id: str,
                      merged: bool = True) -> None:
        with self.lock:
            self.cache.refresh_entry(key, table, snapshot_id, merged)

    def invalidate_snapshot(self, updated_start: Optional[str] = None,
                            updated_end: Optional[str] = None) -> int:
        with self.lock:
            return self.cache.invalidate_snapshot(updated_start, updated_end)

    def invalidate_schema_change(self) -> int:
        with self.lock:
            return self.cache.invalidate_schema_change()

    def ensure_loaded(self, key: str) -> Optional[CacheEntry]:
        """Entry with its table resident, promoting from the cold tier if
        demoted (refresh merges need the actual table)."""
        with self.lock:
            return self.cache.ensure_loaded(key)

    # -------------------------------------------------------- introspection
    def contains(self, key: str) -> bool:
        with self.lock:
            return (key in self.cache._entries
                    or key in self.cache._cold)

    def entry(self, key: str) -> Optional[CacheEntry]:
        with self.lock:
            return self.cache.entry(key)

    def affected_keys(self, updated_start: Optional[str] = None,
                      updated_end: Optional[str] = None) -> list[str]:
        with self.lock:
            return self.cache.affected_keys(updated_start, updated_end)

    def keys(self) -> list[str]:
        with self.lock:
            return self.cache.keys()

    def __len__(self) -> int:
        with self.lock:
            return len(self.cache)

    def total_bytes(self) -> int:
        with self.lock:
            return self.cache.total_bytes()

    def tier_stats(self) -> dict:
        with self.lock:
            return self.cache.tier_stats()

    def entries_summary(self, limit: int = 256) -> list[dict]:
        with self.lock:
            return self.cache.entries_summary(limit)
