"""CacheCluster — family-partitioned shards under one cache surface.

The cluster partitions the OLAP Intent Signature key space across N
:class:`CacheShard` s by **derivation-family key** ``(scope, schema,
measure_key)`` — exactly the tier-1 key of the in-cache derivation index.
Every candidate that could ever serve a roll-up / filter-down / compose
derivation for a request shares that triple with it, so derivation families
are *shard-local by construction*: a shard-local lookup sees the same
candidate set as a single global cache, and per-shard behavior stays
bit-identical to a standalone :class:`SemanticCache`.  ``shards=1`` is
therefore a differential oracle for the unsharded path.

The cluster exposes the full cache surface:

* routed ``lookup`` / ``put`` (+ single-flight miss registration, so
  concurrent identical cold signatures execute once — see ``flight.py``);
* **scatter-gather** batch lookup: one lock acquisition per touched shard
  per batch, results reassembled in request order;
* broadcast lifecycle — ``affected_keys`` / ``invalidate_snapshot`` /
  ``invalidate_schema_change`` / ``refresh_entry`` fan out over shards;
* ``add_shard`` / ``remove_shard`` with deterministic key migration:
  entries re-route under the new shard count and are rebuilt preserving
  tables, hit counters, LRU recency order, store order, and derivation-index
  membership (``SemanticCache.rebuild``);
* aggregated ``stats`` (sum over shards plus retired shards' counters) and
  per-shard breakdowns.

Concurrency model: every cache operation holds exactly one shard lock for
the duration of one ``SemanticCache`` call; cross-shard operations
(broadcasts, key probes) take shard locks one at a time and are linearizable
per shard but not atomic across shards.  Rebalancing holds *all* shard locks
(stop-the-world for the cache, not for executing backends).
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
from typing import Optional, Sequence

from ..analysis.sanitizer import allow_same_class_order, make_lock
from ..core import derivations as dv
from ..core.cache import (CacheEntry, CacheStats, LookupResult, SemanticCache)
from ..core.schema import StarSchema
from ..core.signature import Signature
from ..core.table import ResultTable
from .flight import DEFAULT_FLIGHT_TIMEOUT_S, Flight
from .shard import CacheShard


def family_key(sig: Signature) -> tuple:
    """The derivation-family routing key: the same ``(scope, schema, measure
    multiset)`` triple the cache's tier-1 derivation index buckets by.  Two
    signatures where one could serve the other through any derivation always
    share it."""
    return (sig.scope, sig.schema, sig.measure_key())


def family_hash(sig: Signature) -> int:
    """Deterministic (process- and run-independent) hash of the family key,
    so a persisted/warmed cluster routes identically across restarts.
    Interned on the (frozen) signature instance like ``key()`` — routing a
    previously seen signature is a dict probe, not a hash computation (the
    benign compute-twice race under threads is idempotent)."""
    h = sig.__dict__.get("_family_hash")
    if h is None:
        scope, schema, measures = family_key(sig)
        blob = json.dumps([scope, schema, [list(m) for m in measures]],
                          separators=(",", ":"), default=str)
        h = int.from_bytes(
            hashlib.blake2b(blob.encode(), digest_size=8).digest(), "big")
        object.__setattr__(sig, "_family_hash", h)
    return h


def _sum_stats(parts: Sequence[CacheStats]) -> CacheStats:
    agg = CacheStats()
    for p in parts:
        for f in dataclasses.fields(CacheStats):
            setattr(agg, f.name, getattr(agg, f.name) + getattr(p, f.name))
    return agg


class CacheCluster:
    """N family-partitioned cache shards behind the SemanticCache surface."""

    def __init__(
        self,
        schema: StarSchema,
        shards: int = 4,
        *,
        capacity: Optional[int] = None,  # TOTAL entry budget, split per shard
        capacity_bytes: Optional[int] = None,  # TOTAL byte budget, split
        enable_rollup: bool = True,
        enable_filterdown: bool = True,
        enable_compose: bool = False,
        level_mapper: Optional[dv.LevelMapper] = None,
        indexed_probes: bool = True,
        single_flight: bool = True,
        flight_timeout: float = DEFAULT_FLIGHT_TIMEOUT_S,
        concurrent_misses: bool = True,
        policy: Optional[str] = None,  # 'lru' | 'cost' | None = auto
        cold_capacity_bytes: Optional[int] = None,  # TOTAL cold budget, split
        ttl_s: Optional[float] = None,
        hit_half_life_s: Optional[float] = None,
        write_through: bool = False,
    ):
        if shards < 1:
            raise ValueError(f"cluster needs >= 1 shard, got {shards}")
        self.schema = schema
        self.capacity = capacity
        self.capacity_bytes = capacity_bytes
        self.enable_rollup = enable_rollup
        self.enable_filterdown = enable_filterdown
        self.enable_compose = enable_compose
        self.level_mapper = level_mapper
        self.indexed_probes = indexed_probes
        self.single_flight = single_flight
        self.flight_timeout = flight_timeout
        self.policy = policy
        self.cold_capacity_bytes = cold_capacity_bytes
        self.ttl_s = ttl_s
        self.hit_half_life_s = hit_half_life_s
        self.write_through = write_through  # guarded-by: self._topology_lock
        # one shared TieredStore per tenant/cluster; bound by attach_store
        # under the topology lock, read by _new_cache (same lock)
        self._store = None  # guarded-by: self._topology_lock
        # advisory to the miss planner: per-shard miss groups may execute
        # concurrently (the backend's plan memos are idempotent)
        self.concurrent_misses = concurrent_misses
        # serializes topology changes; individual operations take only the
        # target shard's lock
        self._topology_lock = make_lock("CacheCluster._topology_lock")
        # the rebalance nests every shard lock (in shard-index order) under
        # the topology lock: register that deterministic same-class order
        allow_same_class_order("CacheShard.lock")
        self._retired_stats = CacheStats()  # guarded-by: self._topology_lock
        # obs-plane audit log, re-applied to every shard cache across
        # reshards (set_audit / set_shards both hold the topology lock)
        self._audit = None  # guarded-by: self._topology_lock
        self._audit_labels: dict = {}  # guarded-by: self._topology_lock
        # rebound only by set_shards under the topology lock; lock-free
        # readers take a consistent list snapshot and re-validate routes
        # after acquiring the target shard's lock (see _shard_op)
        self._shards: list[CacheShard] = [  # guarded-by: self._topology_lock
            CacheShard(i, self._new_cache(shards)) for i in range(shards)
        ]

    @classmethod
    def from_template(cls, cache: SemanticCache, shards: int,
                      **kw) -> "CacheCluster":
        """Build a cluster whose shards inherit a template cache's config
        (the ``register_tenant(cache=..., shards=N)`` path)."""
        return cls(
            cache.schema, shards,
            capacity=cache.capacity, capacity_bytes=cache.capacity_bytes,
            enable_rollup=cache.enable_rollup,
            enable_filterdown=cache.enable_filterdown,
            enable_compose=cache.enable_compose,
            level_mapper=cache.level_mapper,
            indexed_probes=cache.indexed_probes,
            policy=cache.policy,
            cold_capacity_bytes=cache.cold_capacity_bytes,
            ttl_s=cache.ttl_s,
            hit_half_life_s=cache.hit_half_life_s,
            write_through=cache.write_through, **kw)

    def _new_cache(self, n_shards: int) -> SemanticCache:
        kw = {}
        if self.hit_half_life_s is not None:
            kw["hit_half_life_s"] = self.hit_half_life_s
        return SemanticCache(
            self.schema,
            capacity=self._split(self.capacity, n_shards),
            enable_rollup=self.enable_rollup,
            enable_filterdown=self.enable_filterdown,
            enable_compose=self.enable_compose,
            level_mapper=self.level_mapper,
            indexed_probes=self.indexed_probes,
            capacity_bytes=self._split(self.capacity_bytes, n_shards),
            policy=self.policy,
            store=self._store,
            cold_capacity_bytes=self._split(self.cold_capacity_bytes, n_shards),
            ttl_s=self.ttl_s,
            write_through=self.write_through,
            **kw,
        )

    @staticmethod
    def _split(total: Optional[int], n: int) -> Optional[int]:
        # ceil-split so shards=1 gets exactly the single-cache budget and a
        # rebalance can never silently shrink the aggregate budget below it
        return None if total is None else -(-total // n)

    # --------------------------------------------------------------- routing
    @property
    def num_shards(self) -> int:
        return len(self._shards)

    def shard_index(self, sig: Signature) -> int:
        return family_hash(sig) % len(self._shards)

    def shard_for(self, sig: Signature) -> CacheShard:
        shards = self._shards  # consistent snapshot under topology changes
        return shards[family_hash(sig) % len(shards)]

    def _shard_op(self, sig: Signature, fn):
        """Run ``fn(shard)`` under the routed shard's lock, re-validating the
        route after acquiring it: an operation that raced ``set_shards`` may
        have blocked on a shard that was retired or re-routed away from this
        family while it waited (the rebalance holds every shard lock), and
        landing there would strand the write on an unreachable shard.  The
        re-check makes routed operations linearizable with topology changes."""
        while True:
            shards = self._shards
            shard = shards[family_hash(sig) % len(shards)]
            with shard.lock:
                now = self._shards
                if now is not shards \
                        and now[family_hash(sig) % len(now)] is not shard:
                    continue  # topology changed under us: re-route
                return fn(shard)

    def shards(self) -> list[CacheShard]:
        return list(self._shards)

    def _shard_of_key(self, key: str) -> Optional[CacheShard]:
        """Locate the shard holding ``key``.  Keys are signature hashes — the
        family is not recoverable from them — so this probes each shard's
        entry dict (one O(1) membership check per shard)."""
        for shard in self._shards:
            if shard.contains(key):
                return shard
        return None

    # --------------------------------------------------------------- lookups
    def lookup(self, sig: Signature, request_origin: str = "sql") -> LookupResult:
        return self._shard_op(
            sig, lambda shard: shard.lookup(sig, request_origin))

    def lookup_batch(
        self, items: Sequence[tuple[Signature, str]]
    ) -> list[LookupResult]:
        """Scatter-gather: partition by shard, one locked batch per shard,
        gather in request order."""
        return [r[0] for r in self._scatter_gather(items, flights=False)]

    def peek_stale(self, sig: Signature):
        """Degraded-serving read on the routed shard (see
        :meth:`CacheShard.peek_stale`); None when no stale copy exists."""
        # shard.peek_stale re-acquires shard.lock (reentrant) — routed
        # through _shard_op so a racing rebalance can't strand the read
        return self._shard_op(sig, lambda shard: shard.peek_stale(sig))

    def lookup_or_flight(
        self, sig: Signature, request_origin: str = "sql"
    ) -> tuple[LookupResult, Optional[Flight], bool]:
        if not self.single_flight:
            return self.lookup(sig, request_origin), None, False
        return self._shard_op(
            sig, lambda shard: shard.lookup_or_flight(sig, request_origin))

    def lookup_or_flight_batch(
        self, items: Sequence[tuple[Signature, str]]
    ) -> list[tuple[LookupResult, Optional[Flight], bool]]:
        return self._scatter_gather(items, flights=self.single_flight)

    def _scatter_gather(
        self, items: Sequence[tuple[Signature, str]], flights: bool
    ) -> list[tuple[LookupResult, Optional[Flight], bool]]:
        """One lock acquisition per touched shard; items whose route went
        stale while waiting for a shard lock (concurrent rebalance) fall back
        to individually re-routed operations."""
        shards = self._shards
        n = len(shards)
        groups: dict[CacheShard, list[int]] = {}
        for i, (sig, _) in enumerate(items):
            groups.setdefault(shards[family_hash(sig) % n], []).append(i)
        out: list = [None] * len(items)
        stale: list[int] = []
        for shard, idxs in groups.items():
            with shard.lock:
                now = self._shards
                if now is not shards:
                    # re-validate each item's route under the new topology
                    fresh = [i for i in idxs
                             if now[family_hash(items[i][0]) % len(now)] is shard]
                    stale.extend(i for i in idxs if i not in set(fresh))
                    idxs = fresh
                for i in idxs:
                    sig, origin = items[i]
                    out[i] = (shard.lookup_or_flight(sig, origin) if flights
                              else (shard.lookup(sig, origin), None, False))
        for i in stale:
            sig, origin = items[i]
            out[i] = (self.lookup_or_flight(sig, origin) if flights
                      else (self.lookup(sig, origin), None, False))
        return out

    # ------------------------------------------------------ flight lifecycle
    def complete_flight(self, flight: Flight, table: Optional[ResultTable]) -> None:
        flight.shard.complete_flight(flight, table)

    def fail_flight(self, flight: Flight, error: BaseException) -> None:
        flight.shard.fail_flight(flight, error)

    def inflight(self) -> int:
        return sum(s.inflight() for s in self._shards)

    # -------------------------------------------------------------- mutation
    def put(self, sig: Signature, table: ResultTable, origin: str = "sql",
            snapshot_id: str = "snap0", *, cost_ms: float = 0.0,
            ttl_s: Optional[float] = None) -> str:
        return self._shard_op(
            sig, lambda shard: shard.put(sig, table, origin, snapshot_id,
                                         cost_ms=cost_ms, ttl_s=ttl_s))

    def drop(self, key: str) -> bool:
        shard = self._shard_of_key(key)
        return shard.drop(key) if shard is not None else False

    def refresh_entry(self, key: str, table: ResultTable, snapshot_id: str,
                      merged: bool = True) -> None:
        shard = self._shard_of_key(key)
        if shard is None:
            raise KeyError(f"cannot refresh unknown entry {key!r}")
        shard.refresh_entry(key, table, snapshot_id, merged)

    def ensure_loaded(self, key: str) -> Optional[CacheEntry]:
        shard = self._shard_of_key(key)
        return shard.ensure_loaded(key) if shard is not None else None

    # ------------------------------------------------------- store lifecycle
    @property
    def store(self):
        return self._store

    def attach_store(self, store, entries: Sequence[CacheEntry] = (),
                     write_through: Optional[bool] = None) -> int:
        """Attach one shared cold-tier store to every shard and route the
        replayed cold metas to their owning shards by family hash (the same
        deterministic modulus as live traffic, so warm-restarted entries land
        exactly where lookups will probe for them)."""
        adopted = 0
        with self._topology_lock:
            self._store = store
            if write_through is not None:
                self.write_through = write_through
            shards = self._shards
            n = len(shards)
            groups: dict[int, list[CacheEntry]] = {i: [] for i in range(n)}
            for e in entries:
                groups[family_hash(e.signature) % n].append(e)
            for i, shard in enumerate(shards):
                with shard.lock:
                    adopted += shard.cache.attach_store(
                        store, groups[i], write_through=write_through)
        return adopted

    def set_audit(self, audit, **labels) -> None:
        """Attach the obs plane's lifecycle audit log to every shard cache,
        each labelled with its shard index (plus the caller's labels, e.g.
        ``tenant=``).  Survives resharding: ``set_shards`` re-applies it."""
        with self._topology_lock:
            self._audit = audit
            self._audit_labels = dict(labels)
            for shard in self._shards:
                with shard.lock:
                    shard.cache.set_audit(audit, shard=shard.index, **labels)

    def detach_store(self) -> None:
        with self._topology_lock:
            self._store = None
            for shard in self._shards:
                with shard.lock:
                    shard.cache.detach_store()

    def persist_hot(self) -> int:
        n = 0
        for shard in self._shards:
            with shard.lock:
                n += shard.cache.persist_hot()
        return n

    def tier_stats(self) -> dict:
        """Aggregated per-tier gauges/counters; the shared store's own stats
        are reported once (every shard sees the same engine)."""
        agg = {"hot_entries": 0, "cold_entries": 0, "hot_bytes": 0,
               "cold_bytes": 0, "promotions": 0, "demotions": 0,
               "cold_drops": 0, "ttl_expiries": 0, "policy": None,
               "store": None}
        for shard in self._shards:
            ts = shard.tier_stats()
            for k in ("hot_entries", "cold_entries", "hot_bytes", "cold_bytes",
                      "promotions", "demotions", "cold_drops", "ttl_expiries"):
                agg[k] += ts[k]
            agg["policy"] = ts["policy"]
        if self._store is not None:
            agg["store"] = self._store.stats()
        return agg

    def entries_summary(self, limit: int = 256) -> list[dict]:
        out: list[dict] = []
        for shard in self._shards:
            if len(out) >= limit:
                break
            out.extend(shard.entries_summary(limit - len(out)))
        return out

    # ------------------------------------------------------------- broadcast
    def affected_keys(self, updated_start: Optional[str] = None,
                      updated_end: Optional[str] = None) -> list[str]:
        out: list[str] = []
        for shard in self._shards:
            out.extend(shard.affected_keys(updated_start, updated_end))
        return out

    def invalidate_snapshot(self, updated_start: Optional[str] = None,
                            updated_end: Optional[str] = None) -> int:
        return sum(s.invalidate_snapshot(updated_start, updated_end)
                   for s in self._shards)

    def invalidate_schema_change(self) -> int:
        return sum(s.invalidate_schema_change() for s in self._shards)

    # ------------------------------------------------------------- topology
    def add_shard(self) -> int:
        """Grow the cluster by one shard; entries re-route deterministically
        under the new modulus.  Returns the new shard count."""
        return self.set_shards(len(self._shards) + 1)

    def remove_shard(self) -> int:
        """Shrink the cluster by one shard; the removed shard's entries
        migrate to the survivors and its counters fold into the aggregate
        stats.  Returns the new shard count."""
        if len(self._shards) == 1:
            raise ValueError("cannot remove the last shard")
        return self.set_shards(len(self._shards) - 1)

    def set_shards(self, n: int) -> int:
        """Rebalance to ``n`` shards (stop-the-world: holds every shard lock).

        Migration is deterministic: each entry's new shard is the family hash
        under the new modulus, and each rebuilt shard reconstructs LRU order
        from the entries' global ``lru_stamp`` and derivation-probe MRU order
        from ``store_stamp`` — so entries that stay put keep their exact
        order, and movers interleave by true recency.  Capacity budgets are
        re-split; shrink-induced overflow evicts LRU as usual."""
        if n < 1:
            raise ValueError(f"cluster needs >= 1 shard, got {n}")
        with self._topology_lock:
            old = self._shards
            for shard in old:
                shard.lock.acquire()
            try:
                entries: list[CacheEntry] = []
                for shard in old:
                    entries.extend(shard.cache.export_entries())
                new = old[:n] + [CacheShard(i, self._new_cache(n))
                                 for i in range(len(old), n)]
                for shard in old[n:]:  # fold removed shards' counters
                    folded = dataclasses.replace(shard.cache.stats)
                    # bytes_cached/bytes_cold are gauges, not counters: the
                    # removed shard's entries migrate to survivors, whose own
                    # gauges will account for them
                    folded.bytes_cached = 0
                    folded.bytes_cold = 0
                    self._retired_stats = _sum_stats(
                        [self._retired_stats, folded])
                assign: dict[int, list[CacheEntry]] = {i: [] for i in range(n)}
                for e in entries:
                    assign[family_hash(e.signature) % n].append(e)
                for i, shard in enumerate(new):
                    shard.index = i
                    shard.cache.capacity = self._split(self.capacity, n)
                    shard.cache.capacity_bytes = self._split(
                        self.capacity_bytes, n)
                    if self._audit is not None:
                        # relabel before rebuild so shrink-induced evictions
                        # are audited under the shard's new index
                        shard.cache.set_audit(self._audit, shard=i,
                                              **self._audit_labels)
                    shard.cache.rebuild(assign[i])
                self._shards = new
            finally:
                for shard in old:
                    shard.lock.release()
        return n

    # ---------------------------------------------------------------- stats
    @property
    def stats(self) -> CacheStats:
        """Aggregated counters: the sum over live shards plus the folded
        counters of removed shards (so totals never go backwards)."""
        return _sum_stats([self._retired_stats]
                          + [s.cache.stats for s in self._shards])

    def stats_by_shard(self) -> list[dict]:
        out = []
        for shard in self._shards:
            with shard.lock:
                d = shard.cache.stats.to_dict()
                d["shard"] = shard.index
                d["entries"] = len(shard.cache)
                d["inflight"] = len(shard._inflight)
            out.append(d)
        return out

    def describe(self) -> dict:
        return {
            "shards": len(self._shards),
            "routing": "family:(scope,schema,measure_key)",
            "single_flight": self.single_flight,
            "concurrent_misses": self.concurrent_misses,
            "capacity": self.capacity,
            "capacity_bytes": self.capacity_bytes,
        }

    # -------------------------------------------------------- introspection
    def entry(self, key: str) -> Optional[CacheEntry]:
        shard = self._shard_of_key(key)
        return shard.entry(key) if shard is not None else None

    def keys(self) -> list[str]:
        out: list[str] = []
        for shard in self._shards:
            out.extend(shard.keys())
        return out

    def __len__(self) -> int:
        return sum(len(s) for s in self._shards)

    def total_bytes(self) -> int:
        return sum(s.total_bytes() for s in self._shards)
