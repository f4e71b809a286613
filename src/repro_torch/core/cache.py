"""The semantic cache store (§3.5, §3.6, §6.2).

Exact-intent lookup by signature hash, plus correctness-preserving
derivations (roll-up, filter-down) found through a metadata index keyed by
measure multiset — the in-memory analogue of the paper's SQLite derivation
index (entries matching requested measures with superset dimensions or
superset filters).  LRU eviction; snapshot-based invalidation where entries
whose time window intersects updated partitions (or is open-ended) are
refreshed while closed windows remain valid.

Derivation probes are **indexed**: within a measure-multiset bucket,
candidates are further keyed by time window (every derivation requires
window equality), then by exact filter tuple (roll-up requires filter
equality) and exact level tuple (filter-down requires level equality), with
set-semantics prefilters for the strict-subset checks.  A lookup therefore
runs ``plan_rollup``/``plan_filterdown`` only on structurally *viable*
candidates — bounded by the viable subset, not the bucket — visited in the
same most-recently-stored-first order as the pre-index linear scan, so hit/
miss outcomes are unchanged (``indexed_probes=False`` keeps the linear scan
for differential testing).  Entries carrying HAVING/ORDER BY/LIMIT can never
serve a derivation and are excluded from the tier-2 index at ``put``.

Accounting is byte-aware: every entry records its table's byte footprint,
``capacity_bytes`` bounds resident bytes alongside the entry-count
``capacity`` (eviction runs until under *both* budgets), and
``stats.bytes_cached`` / ``stats.bytes_evicted`` expose the gauge/counter
pair.  Entries also carry global recency stamps so a sharded cluster
(:mod:`repro.cluster`) can migrate them between shards deterministically
(``export_entries`` / ``rebuild``).  Instances are single-threaded by
design; the cluster provides the locking.

Storage is tiered (:mod:`repro.storage`): with a :class:`TieredStore`
attached, eviction under the hot budgets *demotes* entries to a durable
cold tier instead of dropping them — the victim chosen by a pluggable
policy (``policy="cost"`` scores recompute-cost x decayed hits / bytes;
``policy="lru"`` preserves the exact pre-tiering evictor) — and cold hits
promote transparently back through the same lookup path (``tier="cold"``
on the result is the only observable difference).  Demoted entries keep
their metadata and derivation-index membership hot, so probe order
survives demotion.  Entries may carry a TTL (per-entry or cache default),
expired lazily at lookup.  ``save_cache``/``load_cache`` are thin shims
over the store's crash-safe manifest.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from collections import OrderedDict
from typing import Iterable, Optional

from . import derivations as dv
from .schema import StarSchema
from .signature import Signature, TimeWindow
from .table import ResultTable
from ..storage import policy as _policy


def _discard(lst: list, item) -> None:
    try:
        lst.remove(item)
    except ValueError:
        pass


class _StampClock:
    """Process-wide recency clock for cluster migration and warm restart:
    every store and every touch draws a strictly increasing stamp, so entries
    moved between shards can be interleaved into the target's LRU order
    (``lru_stamp``) and derivation MRU order (``store_stamp``)
    deterministically, without comparing wall clocks.  A warm restart calls
    :func:`advance_stamp` with the highest persisted stamp so fresh stamps
    stay strictly above restored ones.  The internal lock is a plain leaf
    mutex held only for the increment (deliberately not sanitized, like the
    sanitizer's own bookkeeping lock)."""

    __slots__ = ("_lock", "_v")

    def __init__(self):
        self._lock = threading.Lock()
        self._v = 0  # guarded-by: self._lock

    def __next__(self) -> int:
        with self._lock:
            self._v += 1
            return self._v

    def advance_to(self, floor: int) -> None:
        with self._lock:
            if floor > self._v:
                self._v = floor


_STAMP = _StampClock()


def advance_stamp(floor: int) -> None:
    """Ensure future stamps exceed ``floor`` (warm-restart stamp adoption)."""
    _STAMP.advance_to(floor)


@dataclasses.dataclass
class CacheEntry:
    signature: Signature
    table: Optional[ResultTable]  # None while demoted to the cold tier
    origin: str  # 'sql' | 'nl'
    snapshot_id: str
    stored_at: float
    hits: int = 0
    refreshes: int = 0  # in-place table replacements on snapshot advance
    refreshed_at: Optional[float] = None
    table_nbytes: int = 0  # byte footprint of .table (capacity_bytes budget)
    lru_stamp: int = 0  # global recency stamp: last store or touch
    store_stamp: int = 0  # global stamp of the *first* store (MRU probe order)
    version: int = 0  # bumped on every table rewrite (put-overwrite/refresh);
    #                   the store skips payload rewrites for matching versions
    cost_ms: float = 0.0  # execute-stage cost of the producing miss (policy input)
    ttl_s: Optional[float] = None  # per-entry TTL override; None = cache default
    last_used_at: float = 0.0  # monotonic time of last store/touch (hit decay)


@dataclasses.dataclass
class CacheStats:
    hits_exact: int = 0
    hits_rollup: int = 0
    hits_filterdown: int = 0
    hits_compose: int = 0
    misses: int = 0
    stores: int = 0
    evictions: int = 0
    invalidations: int = 0
    refreshes: int = 0  # entries merged in place from a delta scan
    refresh_fallbacks: int = 0  # affected entries replaced by a full recompute
    cross_surface_hits: int = 0  # NL request served by SQL-seeded entry or v.v.
    nl_hits: int = 0
    # derivation-probe observability: viable candidates visited vs plan
    # checks actually run (linear scans visit whole buckets; the index visits
    # only structurally viable candidates)
    derivation_candidates_scanned: int = 0
    derivation_plans_attempted: int = 0
    # byte-aware accounting: bytes_cached is a gauge of the current resident
    # table bytes; bytes_evicted counts bytes removed by LRU eviction
    bytes_cached: int = 0
    bytes_evicted: int = 0
    # tiered storage: demotions move a hot table to the cold tier,
    # promotions bring one back on a cold hit; cold_drops count entries the
    # policy (or cold budget / damage) removed from the cold tier entirely;
    # bytes_cold is the gauge of cold-resident table bytes
    demotions: int = 0
    promotions: int = 0
    cold_drops: int = 0
    ttl_expiries: int = 0  # entries lazily expired by TTL at lookup time
    bytes_cold: int = 0

    @property
    def hits(self) -> int:
        return (self.hits_exact + self.hits_rollup + self.hits_filterdown
                + self.hits_compose)

    @property
    def lookups(self) -> int:
        return self.hits + self.misses

    @property
    def hit_rate(self) -> float:
        n = self.lookups
        return self.hits / n if n else 0.0

    def to_dict(self) -> dict:
        """Serializable counter snapshot (fields + derived totals) for the
        service stats endpoints — the derived values are materialized here
        so ``json.dumps`` can never silently emit a bound method."""
        d = dataclasses.asdict(self)
        d["hits"] = self.hits
        d["lookups"] = self.lookups
        d["hit_rate"] = self.hit_rate
        return d


@dataclasses.dataclass
class LookupResult:
    """Outcome of one cache probe.

    ``status`` is one of ``'hit_exact'`` (signature-key match),
    ``'hit_rollup'`` (re-aggregated from a finer-grained entry),
    ``'hit_filterdown'`` (post-filtered from a superset entry),
    ``'hit_compose'`` (flag-gated beyond-paper derivation: filter-down
    composed with roll-up in one step, e.g. a cached (region, category)
    result answering "by region WHERE category = x"), or ``'miss'``.
    ``source_key``/``source_origin``/``source_snapshot`` identify the
    serving entry and the data snapshot its table reflects.  ``tier`` is
    ``"cold"`` when the serving entry was promoted from the cold tier for
    this request (``tier:cold`` provenance downstream), else ``None`` —
    appended last so positional construction stays source-compatible.
    """

    status: str
    table: Optional[ResultTable]
    source_key: Optional[str] = None
    source_origin: Optional[str] = None
    source_snapshot: Optional[str] = None
    tier: Optional[str] = None


class _TwBucket:
    """Tier-2 derivation index for one (measure bucket, time window) group:
    candidates keyed by exact filter tuple (roll-up needs filter equality)
    and by exact level tuple (filter-down needs level equality)."""

    __slots__ = ("by_filters", "by_levels")

    def __init__(self):
        self.by_filters: dict[tuple, list[str]] = {}
        self.by_levels: dict[tuple, list[str]] = {}


class _MeasureBucket:
    """Tier-1 derivation index bucket: every entry sharing a measure
    multiset, in insertion order (the linear-scan path), plus the tier-2
    time-window index over the derivation-capable subset."""

    __slots__ = ("order", "by_tw")

    def __init__(self):
        self.order: list[str] = []
        self.by_tw: dict[Optional[TimeWindow], _TwBucket] = {}


class SemanticCache:
    def __init__(
        self,
        schema: StarSchema,
        capacity: Optional[int] = None,  # max entries; None = unbounded
        enable_rollup: bool = True,
        enable_filterdown: bool = True,
        enable_compose: bool = False,  # beyond-paper: filter-down o roll-up
        level_mapper: Optional[dv.LevelMapper] = None,
        indexed_probes: bool = True,  # False: pre-index linear scan (testing)
        capacity_bytes: Optional[int] = None,  # max table bytes; None = unbounded
        policy: Optional[str] = None,  # 'lru' | 'cost'; None = auto (lru
        #                                without a store, cost with one)
        store=None,  # repro.storage.engine.TieredStore (cold tier); None = all-hot
        cold_capacity_bytes: Optional[int] = None,  # cold-tier byte budget
        ttl_s: Optional[float] = None,  # default entry TTL; None = no expiry
        hit_half_life_s: float = _policy.DEFAULT_HALF_LIFE_S,
        write_through: bool = False,  # also spill puts/refreshes (durable
        #                               working set, not just demotions)
    ):
        self.schema = schema
        self.capacity = capacity
        self.capacity_bytes = capacity_bytes
        self._bytes = 0  # resident table bytes (mirrors stats.bytes_cached)
        self.enable_rollup = enable_rollup
        self.enable_filterdown = enable_filterdown
        self.enable_compose = enable_compose
        self.level_mapper = level_mapper
        self.indexed_probes = indexed_probes
        self.policy = policy
        self.store = store
        self.cold_capacity_bytes = cold_capacity_bytes
        self.ttl_s = ttl_s
        self.hit_half_life_s = hit_half_life_s
        self.write_through = write_through
        self._policies = {
            "lru": _policy.LruPolicy(),
            "cost": _policy.CostPolicy(half_life_s=hit_half_life_s),
        }
        self._entries: "OrderedDict[str, CacheEntry]" = OrderedDict()
        # cold-tier metas: demoted entries keep their CacheEntry (stamps, hit
        # counters, index membership) with table=None; the bytes live in the
        # attached store.  Insertion order is demotion order (oldest first).
        self._cold: "OrderedDict[str, CacheEntry]" = OrderedDict()
        self._cold_bytes = 0  # mirrors stats.bytes_cold
        # derivation candidate index: (scope, schema, measure multiset)
        self._by_measures: dict[tuple, _MeasureBucket] = {}
        # reverse map key -> (bucket key, signature) so eviction/invalidation
        # unindexes without scanning every bucket
        self._index_of: dict[str, tuple] = {}
        # monotonic store sequence per key: the MRU merge order of the
        # indexed probe (== position in the bucket's insertion-order list)
        self._seq = 0
        self._seq_of: dict[str, int] = {}
        # stale-on-error morgue: the last tables of TTL-expired hot entries,
        # kept (bounded, LRU) so degraded serving can offer an *explicitly
        # tagged* stale answer when the backend is down.  Never consulted by
        # lookup() — only by peek_stale(), and only the resilience plane
        # calls that.
        self._morgue: "OrderedDict[str, object]" = OrderedDict()
        self.morgue_capacity = 128
        self.stats = CacheStats()
        # lifecycle audit log (repro.obs.audit.AuditLog); None = disabled,
        # so every emission site pays one attribute load + None check.
        # Label fields (tenant=..., shard=...) ride on every event.
        self.audit = None
        self._audit_labels: dict = {}

    def set_audit(self, audit, **labels) -> None:
        """Attach (or detach, with ``None``) the obs plane's cache-lifecycle
        audit log.  ``labels`` (``tenant=...``, ``shard=...``) are stamped
        onto every event this cache emits."""
        self.audit = audit
        self._audit_labels = dict(labels)

    def _emit_audit(self, event: str, key: str, **fields) -> None:
        # callers pre-check `self.audit is not None`: the disabled hot path
        # never pays this call.  The record is built in place and appended
        # directly (no kwargs re-splat) — `hit` rides the warm path, where
        # this is a measurable share of request latency.
        rec = {"ts": time.time(), "event": event, "key": key}
        rec.update(self._audit_labels)
        rec.update(fields)
        self.audit.append(rec)

    def _policy_inputs(self, e: CacheEntry, now: float) -> dict:
        """The same per-entry policy inputs ``entries_summary`` reports —
        attached to evict/demote audit events so ``python -m repro.obs
        explain`` can narrate *why* the policy chose this victim."""
        return {
            "age_s": round(now - e.stored_at, 3),
            "idle_s": round(now - e.last_used_at, 3),
            "hits": e.hits,
            "decayed_hits": round(
                _policy.decayed_hits(e, now, self.hit_half_life_s), 4),
            "cost_ms": e.cost_ms,
            "nbytes": e.table_nbytes,
            "score": round(
                _policy.cost_benefit_score(e, now, self.hit_half_life_s), 6),
            "policy": self._resolve_policy().name,
        }

    # ------------------------------------------------------------------- api
    def __len__(self) -> int:
        return len(self._entries)

    def lookup(self, sig: Signature, request_origin: str = "sql") -> LookupResult:
        key = sig.key()
        now = time.monotonic()
        tier = None
        entry = self._entries.get(key)
        if entry is not None and self._expired(entry, now):
            self._expire(key)
            entry = None
        if entry is None and key in self._cold:
            if self._expired(self._cold[key], now):
                self._expire(key)
            else:
                entry = self._promote(key)
                tier = "cold"
        if entry is not None:
            # capture before re-enforcing capacity: a tiny hot budget could
            # demote the just-promoted entry again and null its table
            table = entry.table
            origin, snap = entry.origin, entry.snapshot_id
            self._touch(key, entry, request_origin)
            self.stats.hits_exact += 1
            if self.audit is not None:
                # built in place (no kwargs hop): this site rides the warm
                # path, where every dict round-trip is measurable
                rec = {"ts": time.time(), "event": "hit", "key": key}
                rec.update(self._audit_labels)
                rec["tier"] = tier or "hot"
                rec["origin"] = origin
                rec["snapshot"] = snap
                rec["request_origin"] = request_origin
                rec["hits"] = entry.hits
                self.audit.append(rec)
            if tier == "cold":
                self._enforce_capacity()
            return LookupResult("hit_exact", table, key, origin, snap,
                                tier=tier)

        # derivation pass: only post-aggregation-free requests can be served
        # by a derivation (every planner requires it), and only candidates
        # sharing the measure multiset are admissible
        bucket = self._by_measures.get((sig.scope, sig.schema, sig.measure_key()))
        if bucket is not None and dv.no_postagg(sig) and (
                self.enable_rollup or self.enable_filterdown or self.enable_compose):
            probe = self._probe_indexed if self.indexed_probes else self._probe_linear
            hit = probe(sig, request_origin, bucket)
            if hit is not None:
                return hit
        self.stats.misses += 1
        return LookupResult("miss", None)

    # ------------------------------------------------------ derivation probes
    def _attempt(self, sig: Signature, cand_key: str, cand: CacheEntry,
                 kind: str, request_origin: str) -> Optional[LookupResult]:
        """Run one derivation plan+apply; None when it doesn't pan out.

        Plans run on metadata only, so a cold candidate is promoted (its
        table loaded from the store) only *after* its plan succeeds — a
        structurally unviable cold entry costs no IO."""
        self.stats.derivation_plans_attempted += 1
        now = time.monotonic()
        if self._expired(cand, now):
            self._expire(cand_key)
            return None
        planner = {"rollup": dv.plan_rollup, "filterdown": dv.plan_filterdown,
                   "compose": dv.plan_compose}[kind]
        plan = planner(sig, cand.signature, self.schema, cand_key)
        if plan is None:
            return None
        tier = None
        if cand.table is None:
            cand = self._promote(cand_key)
            if cand is None:
                return None  # damaged payload: the cold meta was dropped
            tier = "cold"
        if kind == "rollup":
            derived = dv.apply_rollup(plan, sig, cand.signature, cand.table,
                                      self.level_mapper)
        elif kind == "filterdown":
            derived = dv.apply_filterdown(plan, sig, cand.signature, cand.table)
        else:
            derived = dv.apply_compose(plan, sig, cand.signature, cand.table,
                                       self.level_mapper)
        if derived is None:
            if tier == "cold":
                self._enforce_capacity()
            return None
        origin, snap = cand.origin, cand.snapshot_id
        self._touch(cand_key, cand, request_origin)
        status = {"rollup": "hit_rollup", "filterdown": "hit_filterdown",
                  "compose": "hit_compose"}[kind]
        setattr(self.stats, f"hits_{kind}",
                getattr(self.stats, f"hits_{kind}") + 1)
        if self.audit is not None:
            # key = the *requested* signature; src_key = the cached entry
            # that served it (the false-hit audit checks src_key liveness)
            self._emit_audit("derivation_hit", sig.key(), src_key=cand_key,
                             derivation=kind, tier=tier or "hot",
                             origin=origin, snapshot=snap,
                             request_origin=request_origin)
        if tier == "cold":
            self._enforce_capacity()
        return LookupResult(status, derived, cand_key, origin, snap, tier=tier)

    def _probe_indexed(self, sig: Signature, request_origin: str,
                       bucket: _MeasureBucket) -> Optional[LookupResult]:
        """Gather the structurally viable candidates through the tier-2
        index, then try plans most-recently-stored first — the same visit
        order as the linear scan, restricted to candidates that can pass the
        planners' structural preconditions.  The three viability classes are
        mutually exclusive per candidate (filter equality vs strict subset;
        level equality vs inequality), mirroring the per-candidate
        rollup -> filterdown -> compose priority of the linear scan."""
        twb = bucket.by_tw.get(sig.time_window)
        if twb is None:
            return None
        seq = self._seq_of
        composable = sig.all_composable()
        cands: list[tuple[int, str, str]] = []
        if self.enable_rollup and composable:
            for k in twb.by_filters.get(sig.filters, ()):
                if self._entry_any(k).signature.levels != sig.levels:
                    cands.append((seq.get(k, 0), k, "rollup"))
        req_fs = sig.filters_frozen()
        if self.enable_filterdown:
            for k in twb.by_levels.get(sig.levels, ()):
                if self._entry_any(k).signature.filters_frozen() < req_fs:
                    cands.append((seq.get(k, 0), k, "filterdown"))
        if self.enable_compose and composable:
            for ftup, keys in twb.by_filters.items():
                if not frozenset(ftup) < req_fs:
                    continue
                for k in keys:
                    if self._entry_any(k).signature.levels != sig.levels:
                        cands.append((seq.get(k, 0), k, "compose"))
        cands.sort(reverse=True)
        self.stats.derivation_candidates_scanned += len(cands)
        for _, cand_key, kind in cands:
            cand = self._entry_any(cand_key)
            if cand is None:
                continue
            hit = self._attempt(sig, cand_key, cand, kind, request_origin)
            if hit is not None:
                return hit
        return None

    def _probe_linear(self, sig: Signature, request_origin: str,
                      bucket: _MeasureBucket) -> Optional[LookupResult]:
        """Pre-index behavior: walk the whole measure bucket most-recently-
        stored first, trying every derivation on every candidate.  Kept as
        the differential-testing oracle for the indexed probe."""
        # snapshot: _attempt may expire/drop candidates, mutating the bucket
        for cand_key in list(reversed(bucket.order)):
            cand = self._entry_any(cand_key)
            if cand is None:
                continue
            self.stats.derivation_candidates_scanned += 1
            for kind, enabled in (("rollup", self.enable_rollup),
                                  ("filterdown", self.enable_filterdown),
                                  ("compose", self.enable_compose)):
                if not enabled:
                    continue
                hit = self._attempt(sig, cand_key, cand, kind, request_origin)
                if hit is not None:
                    return hit
        return None

    def put(
        self,
        sig: Signature,
        table: ResultTable,
        origin: str = "sql",
        snapshot_id: str = "snap0",
        *,
        cost_ms: float = 0.0,
        ttl_s: Optional[float] = None,
    ) -> str:
        key = sig.key()
        now = time.monotonic()
        if key in self._cold:
            # overwrite of a demoted entry: pull the meta back hot (its index
            # membership and stamps survive) and fall through to the
            # overwrite path below
            e = self._cold.pop(key)
            self._cold_bytes -= e.table_nbytes
            self.stats.bytes_cold = self._cold_bytes
            self._entries[key] = e
            self._bytes += e.table_nbytes
        if key in self._entries:
            # full overwrite: provenance (origin, stored_at) must track the
            # new producer, or a SQL-refreshed entry keeps reporting the
            # stale origin in provenance chains and stats forever
            e = self._entries[key]
            self._entries.move_to_end(key)
            e.table = table
            e.snapshot_id = snapshot_id
            e.origin = origin
            e.stored_at = now
            e.last_used_at = now
            e.lru_stamp = next(_STAMP)
            e.version += 1
            if cost_ms:
                e.cost_ms = cost_ms
            if ttl_s is not None:
                e.ttl_s = ttl_s
            self._set_entry_bytes(e, table.nbytes())
            if self.audit is not None:
                self._emit_audit("put", key, overwrite=True, origin=origin,
                                 snapshot=snapshot_id, nbytes=e.table_nbytes,
                                 cost_ms=e.cost_ms, version=e.version)
            self._maybe_write_through(key, e)
            self._enforce_capacity()
            return key
        e = CacheEntry(sig, table, origin, snapshot_id, now,
                       cost_ms=cost_ms, ttl_s=ttl_s, last_used_at=now)
        stamp = next(_STAMP)
        e.lru_stamp = e.store_stamp = stamp
        self._entries[key] = e
        self._set_entry_bytes(e, table.nbytes())
        self._seq += 1
        self._seq_of[key] = self._seq
        self._index(key, sig)
        self.stats.stores += 1
        if self.audit is not None:
            self._emit_audit("put", key, overwrite=False, origin=origin,
                             snapshot=snapshot_id, nbytes=e.table_nbytes,
                             cost_ms=e.cost_ms, ttl_s=e.ttl_s)
        self._maybe_write_through(key, e)
        self._enforce_capacity()
        return key

    # ----------------------------------------------- invalidation / refresh
    def affected_keys(
        self, updated_start: Optional[str] = None, updated_end: Optional[str] = None
    ) -> list[str]:
        """Keys of the entries a data update covering [updated_start,
        updated_end) can affect (§6.2): open-ended windows and windowless
        entries always (they span everything), closed windows only when they
        intersect the updated range, every entry when the update extent is
        unknown.  The caller decides what to do with them — drop
        (``invalidate_snapshot``) or refresh in place (``refresh_entry``).
        Cold-tier entries are included: a demoted table is just as stale."""
        out = []
        for key, e in list(self._entries.items()) + list(self._cold.items()):
            tw = e.signature.time_window
            if tw is None or tw.open_ended:
                out.append(key)
            elif updated_start is None or updated_end is None:
                out.append(key)  # unknown update extent: conservative
            elif tw.intersects(updated_start, updated_end):
                out.append(key)
        return out

    def invalidate_snapshot(
        self, updated_start: Optional[str] = None, updated_end: Optional[str] = None
    ) -> int:
        """New data arrived covering [updated_start, updated_end).  Affected
        entries (see ``affected_keys``) are dropped; closed windows outside
        the range remain valid (§6.2)."""
        dropped = self.affected_keys(updated_start, updated_end)
        for key in dropped:
            self._remove(key)
            self.stats.invalidations += 1
            if self.audit is not None:
                self._emit_audit("drop", key, reason="snapshot_invalidation",
                                 updated_start=updated_start,
                                 updated_end=updated_end)
        return len(dropped)

    def refresh_entry(
        self, key: str, table: ResultTable, snapshot_id: str, merged: bool = True
    ) -> None:
        """Bring an entry current in place after a data update, instead of
        dropping it: the working set (LRU position, hit counters, derivation
        index membership) survives the snapshot advance.  ``merged`` tells
        the stats whether the table came from a delta merge (the cheap path)
        or a full recompute fallback."""
        e = self._entries.get(key)
        if e is None and key in self._cold:
            # refreshing a demoted entry replaces its table wholesale — no
            # need to read the stale cold payload; just pull the meta hot
            e = self._cold.pop(key)
            self._cold_bytes -= e.table_nbytes
            self.stats.bytes_cold = self._cold_bytes
            self._entries[key] = e
            self._bytes += e.table_nbytes
        if e is None:
            raise KeyError(f"cannot refresh unknown entry {key!r}")
        e.table = table
        self._set_entry_bytes(e, table.nbytes())
        e.snapshot_id = snapshot_id
        e.refreshes += 1
        e.version += 1
        e.refreshed_at = time.monotonic()
        if merged:
            self.stats.refreshes += 1
        else:
            self.stats.refresh_fallbacks += 1
        if self.audit is not None:
            self._emit_audit("refresh", key, snapshot=snapshot_id,
                             merged=merged, nbytes=e.table_nbytes,
                             version=e.version)
        self._maybe_write_through(key, e)
        # delta merges grow tables (group unions), so a refresh can push the
        # cache over its byte budget just like a put
        self._enforce_capacity()

    def drop(self, key: str) -> bool:
        """Explicitly invalidate one entry by key; True when it existed."""
        if key not in self._entries and key not in self._cold:
            return False
        self._remove(key)
        self.stats.invalidations += 1
        if self.audit is not None:
            self._emit_audit("drop", key, reason="explicit_invalidation")
        return True

    def invalidate_schema_change(self) -> int:
        n = len(self._entries) + len(self._cold)
        if self.audit is not None:
            for key in list(self._entries) + list(self._cold):
                self._emit_audit("drop", key, reason="schema_change")
        self._entries.clear()
        self._cold.clear()
        # a schema change makes stale tables structurally wrong, not merely
        # old: degraded serving must never offer them
        self._morgue.clear()
        self._by_measures.clear()
        self._index_of.clear()
        self._seq_of.clear()
        self._bytes = 0
        self._cold_bytes = 0
        self.stats.bytes_cached = 0
        self.stats.bytes_cold = 0
        self.stats.invalidations += n
        if self.store is not None:
            self.store.purge()
        return n

    # ------------------------------------------------------------- internals
    def _touch(self, key: str, entry: CacheEntry, request_origin: str) -> None:
        self._entries.move_to_end(key)
        entry.hits += 1
        entry.lru_stamp = next(_STAMP)
        entry.last_used_at = time.monotonic()
        if request_origin == "nl":
            self.stats.nl_hits += 1
        if request_origin != entry.origin:
            self.stats.cross_surface_hits += 1

    def _entry_any(self, key: str) -> Optional[CacheEntry]:
        """Hot entry, or the cold-tier meta (table=None) for a demoted one."""
        e = self._entries.get(key)
        return e if e is not None else self._cold.get(key)

    # ------------------------------------------------------------ TTL expiry
    def _expired(self, e: CacheEntry, now: float) -> bool:
        ttl = e.ttl_s if e.ttl_s is not None else self.ttl_s
        if ttl is None:
            return False
        born = e.refreshed_at if e.refreshed_at is not None else e.stored_at
        return (now - born) > ttl

    def _expire(self, key: str) -> None:
        """Lazy TTL expiry: drop the entry from whichever tier holds it (and
        its durable record — an expired entry must not resurrect on replay).
        A resident table moves to the morgue first so degraded serving can
        still offer it, explicitly tagged, when the backend is down."""
        e = self._entries.get(key)
        morgued = False
        if e is not None and e.table is not None:
            self._morgue[key] = e.table
            self._morgue.move_to_end(key)
            while len(self._morgue) > self.morgue_capacity:
                self._morgue.popitem(last=False)
            morgued = True
        tier = "hot" if e is not None else "cold"
        self._remove(key)
        self.stats.ttl_expiries += 1
        if self.audit is not None:
            self._emit_audit("ttl_expiry", key, tier=tier, morgued=morgued)

    def peek_stale(self, sig: Signature):
        """A possibly-stale table for this exact signature, or None — the
        degraded-serving read.  Checks the hot tier (even if TTL-expired),
        the cold tier via a non-mutating payload read (no promotion, no
        counter churn), then the morgue of TTL-expired tables.  Never
        derives, never touches hit accounting: callers *must* tag anything
        served from here (``degraded:stale``)."""
        key = sig.key()
        e = self._entries.get(key)
        if e is not None and e.table is not None:
            if self.audit is not None:
                self._emit_audit("stale_serve", key, source="hot",
                                 snapshot=e.snapshot_id)
            return e.table
        if key in self._cold and self.store is not None:
            table = self.store.peek(key)
            if table is not None:
                if self.audit is not None:
                    self._emit_audit("stale_serve", key, source="cold",
                                     snapshot=self._cold[key].snapshot_id)
                return table
        table = self._morgue.get(key)
        if table is not None and self.audit is not None:
            self._emit_audit("morgue_serve", key, source="morgue")
        return table

    # -------------------------------------------------------------- tiering
    def _resolve_policy(self):
        name = self.policy
        if name is None:
            name = "cost" if self.store is not None else "lru"
        return self._policies[name]

    def _maybe_write_through(self, key: str, e: CacheEntry) -> None:
        if self.store is not None and self.write_through:
            self.store.spill(key, e, e.table)

    def _promote(self, key: str) -> Optional[CacheEntry]:
        """Bring a demoted entry back hot.  ``None`` (and the cold meta is
        dropped) when the payload is damaged — a cold read never turns into
        a false hit.  A *transient* read failure (IO errors, cold breaker
        open) is a miss too, but the cold entry is kept: the durable replica
        is intact and serves again once the tier recovers."""
        e = self._cold.get(key)
        if e is None:
            return None
        try:
            table = self.store.promote(key) if self.store is not None else None
        except OSError:
            return None  # unavailable, not damaged: keep the replica
        if table is None:
            self._drop_cold(key, reason="damaged_payload")
            return None
        del self._cold[key]
        self._cold_bytes -= e.table_nbytes
        self.stats.bytes_cold = self._cold_bytes
        e.table = table
        self._entries[key] = e
        self._bytes += e.table_nbytes
        self._set_entry_bytes(e, table.nbytes())
        self.stats.promotions += 1
        if self.audit is not None:
            self._emit_audit("promote", key, nbytes=e.table_nbytes,
                             hits=e.hits)
        return e

    def _drop_cold(self, key: str, reason: str = "cold_capacity") -> None:
        """Remove a cold-tier entry entirely (budget pressure or damage)."""
        e = self._cold.pop(key, None)
        if e is None:
            return
        self._cold_bytes -= e.table_nbytes
        self.stats.bytes_cold = self._cold_bytes
        self._unindex(key)
        if self.store is not None:
            self.store.delete(key)
        self.stats.cold_drops += 1
        self.stats.bytes_evicted += e.table_nbytes
        if self.audit is not None:
            self._emit_audit("evict", key, tier="cold", disposition="drop",
                             reason=reason,
                             **self._policy_inputs(e, time.monotonic()))

    def ensure_loaded(self, key: str) -> Optional[CacheEntry]:
        """The entry with its table resident, promoting from cold if needed
        (refresh merges need the actual table).  None if unknown/damaged."""
        e = self._entries.get(key)
        if e is not None:
            return e
        if key in self._cold:
            # no capacity re-enforcement here: the caller is mid-mutation
            # (refresh) and needs the table resident; the following
            # refresh/put re-enforces budgets
            return self._promote(key)
        return None

    def _set_entry_bytes(self, entry: CacheEntry, nbytes: int) -> None:
        self._bytes += nbytes - entry.table_nbytes
        entry.table_nbytes = nbytes
        self.stats.bytes_cached = self._bytes

    def _index(self, key: str, sig: Signature) -> None:
        """Insert ``key`` into the derivation candidate index (tier 1 always;
        tier 2 only for entries that can actually serve a derivation)."""
        idx_key = (sig.scope, sig.schema, sig.measure_key())
        bucket = self._by_measures.setdefault(idx_key, _MeasureBucket())
        bucket.order.append(key)
        if dv.no_postagg(sig):
            # entries with HAVING/ORDER BY/LIMIT can never serve a
            # derivation; they stay out of the tier-2 viability index
            twb = bucket.by_tw.setdefault(sig.time_window, _TwBucket())
            twb.by_filters.setdefault(sig.filters, []).append(key)
            twb.by_levels.setdefault(sig.levels, []).append(key)
        self._index_of[key] = (idx_key, sig)

    def _enforce_capacity(self) -> None:
        while self._entries and (
            (self.capacity is not None and len(self._entries) > self.capacity)
            or (self.capacity_bytes is not None
                and self._bytes > self.capacity_bytes)
        ):
            self._evict_one()
        self._enforce_cold_capacity()

    def _evict_one(self) -> None:
        """Evict one hot entry under capacity pressure.  With a store
        attached the policy decides demote-to-cold (write-behind spill, the
        meta keeps its index membership and stamps) vs drop; without one this
        is the eviction from before tiering, byte-for-byte."""
        now = time.monotonic()
        pol = self._resolve_policy()
        key = pol.victim(self._entries, now)
        e = self._entries.pop(key)
        self._bytes -= e.table_nbytes
        self.stats.bytes_cached = self._bytes
        if self.store is not None and pol.admit_cold(e, now):
            table, e.table = e.table, None
            self._cold[key] = e
            self._cold_bytes += e.table_nbytes
            self.stats.bytes_cold = self._cold_bytes
            self.stats.demotions += 1
            if self.audit is not None:
                self._emit_audit("demote", key, tier="hot",
                                 reason="hot_capacity",
                                 **self._policy_inputs(e, now))
            self.store.spill(key, e, table)
        else:
            self._unindex(key)
            if self.store is not None:
                # the policy chose drop, not demote: the durable copy (if
                # write-through made one) must go too, or replay resurrects it
                self.store.delete(key)
            self.stats.bytes_evicted += e.table_nbytes
            self.stats.evictions += 1
            if self.audit is not None:
                self._emit_audit("evict", key, tier="hot",
                                 disposition="drop", reason="hot_capacity",
                                 **self._policy_inputs(e, now))

    def _enforce_cold_capacity(self) -> None:
        if self.cold_capacity_bytes is None or not self._cold:
            return
        now = time.monotonic()
        while self._cold and self._cold_bytes > self.cold_capacity_bytes:
            # lowest benefit density goes first, like the hot tier
            key = min(self._cold, key=lambda k: _policy.cost_benefit_score(
                self._cold[k], now, self.hit_half_life_s))
            self._drop_cold(key)

    def _remove(self, key: str) -> None:
        e = self._entries.pop(key, None)
        if e is None:
            e = self._cold.pop(key, None)
            if e is not None:
                self._cold_bytes -= e.table_nbytes
                self.stats.bytes_cold = self._cold_bytes
        else:
            self._bytes -= e.table_nbytes
            self.stats.bytes_cached = self._bytes
        if e is not None:
            self._unindex(key)
            if self.store is not None:
                self.store.delete(key)

    def _unindex(self, key: str) -> None:
        rec = self._index_of.pop(key, None)
        if rec is None:
            return
        idx_key, sig = rec
        self._seq_of.pop(key, None)
        bucket = self._by_measures.get(idx_key)
        if bucket is None:
            return
        _discard(bucket.order, key)
        twb = bucket.by_tw.get(sig.time_window)
        if twb is not None:
            for sub, sub_key in ((twb.by_filters, sig.filters),
                                 (twb.by_levels, sig.levels)):
                lst = sub.get(sub_key)
                if lst is not None:
                    _discard(lst, key)
                    if not lst:
                        del sub[sub_key]
            if not twb.by_filters and not twb.by_levels:
                del bucket.by_tw[sig.time_window]
        if not bucket.order:
            del self._by_measures[idx_key]

    # ----------------------------------------------------- cluster migration
    def export_entries(self) -> list[CacheEntry]:
        """Live entries in LRU order (least-recently-used first), hot tier
        then cold metas (``table is None`` marks a demoted entry whose bytes
        live in the shared store).  Each entry carries its global
        ``lru_stamp``/``store_stamp``, so a cluster rebalance can
        deterministically interleave entries from several source shards (see
        :meth:`rebuild`)."""
        return list(self._entries.values()) + list(self._cold.values())

    def rebuild(self, entries: Iterable[CacheEntry]) -> None:
        """Replace the cache contents with ``entries`` (shard rebalance /
        warm-restart adoption).

        LRU order is reconstructed from ``lru_stamp`` and the derivation
        index's most-recently-stored probe order from ``store_stamp`` — the
        same global clock both stamps were drawn from — so migrated entries
        keep their recency relative to entries already resident on the target
        shard.  Entry state (tables, hit counters, snapshot ids) moves
        untouched; cumulative stats counters are preserved.  Table-less
        entries (cold metas) land in the cold tier — kept only when a store
        is attached to serve their payloads.  Capacity budgets are
        re-enforced afterwards (a shrink migration can evict, counted as
        ordinary evictions)."""
        entries = list(entries)
        self._entries.clear()
        self._cold.clear()
        self._by_measures.clear()
        self._index_of.clear()
        self._seq_of.clear()
        self._bytes = 0
        self._cold_bytes = 0
        kept = []
        for e in sorted(entries, key=lambda e: e.lru_stamp):
            key = e.signature.key()
            if e.table is not None:
                self._entries[key] = e
                self._bytes += e.table_nbytes
            elif self.store is not None and self.store.has(key):
                self._cold[key] = e
                self._cold_bytes += e.table_nbytes
            else:
                continue  # cold meta with no serving store: unservable
            kept.append(e)
        self._seq = 0
        for e in sorted(kept, key=lambda e: e.store_stamp):
            key = e.signature.key()
            self._seq += 1
            self._seq_of[key] = self._seq
            self._index(key, e.signature)
        self.stats.bytes_cached = self._bytes
        self.stats.bytes_cold = self._cold_bytes
        self._enforce_capacity()

    # -------------------------------------------------------- store lifecycle
    def attach_store(self, store, entries: Iterable[CacheEntry] = (),
                     write_through: Optional[bool] = None) -> int:
        """Attach a cold-tier store and adopt replayed entries (warm
        restart).  Adopted metas merge with anything already resident via
        :meth:`rebuild` — live entries win key conflicts (they are newer
        than the replayed copy)."""
        self.store = store
        if write_through is not None:
            self.write_through = write_through
        adopted = list(entries)
        if adopted:
            live = {e.signature.key() for e in self._entries.values()}
            live.update(e.signature.key() for e in self._cold.values())
            adopted = [e for e in adopted if e.signature.key() not in live]
            self.rebuild(self.export_entries() + adopted)
        return len(adopted)

    def detach_store(self) -> None:
        """Drop the store reference; cold metas become unservable and are
        removed (their durable records remain on disk for the next open)."""
        self.store = None
        for key in list(self._cold.keys()):
            e = self._cold.pop(key)
            self._cold_bytes -= e.table_nbytes
            self._unindex(key)
        self._cold_bytes = 0
        self.stats.bytes_cold = 0

    def persist_hot(self) -> int:
        """Spill every hot entry to the store (write-behind; clean versions
        cost only a metadata record).  The graceful-shutdown half of warm
        restart.  Returns the number of entries scheduled."""
        if self.store is None:
            return 0
        n = 0
        for key, e in self._entries.items():
            self.store.spill(key, e, e.table)
            n += 1
        return n

    # ---------------------------------------------------------- introspection
    def entry(self, key: str) -> Optional[CacheEntry]:
        return self._entries.get(key)

    def keys(self) -> list[str]:
        return list(self._entries.keys())

    def cold_keys(self) -> list[str]:
        return list(self._cold.keys())

    def total_bytes(self) -> int:
        return self._bytes

    def tier_stats(self) -> dict:
        """Per-tier observability for the service stats endpoint."""
        return {
            "hot_entries": len(self._entries),
            "cold_entries": len(self._cold),
            "hot_bytes": self._bytes,
            "cold_bytes": self._cold_bytes,
            "promotions": self.stats.promotions,
            "demotions": self.stats.demotions,
            "cold_drops": self.stats.cold_drops,
            "ttl_expiries": self.stats.ttl_expiries,
            "policy": self._resolve_policy().name,
            "store": self.store.stats() if self.store is not None else None,
        }

    def entries_summary(self, limit: int = 256) -> list[dict]:
        """Per-entry policy inputs (age, decayed hits, score) so eviction
        decisions are observable; hot tier first, then cold."""
        now = time.monotonic()
        out = []
        for tier, entries in (("hot", self._entries), ("cold", self._cold)):
            for key, e in entries.items():
                if len(out) >= limit:
                    return out
                out.append({
                    "key": key,
                    "tier": tier,
                    "age_s": now - e.stored_at,
                    "idle_s": now - e.last_used_at,
                    "hits": e.hits,
                    "decayed_hits": _policy.decayed_hits(
                        e, now, self.hit_half_life_s),
                    "cost_ms": e.cost_ms,
                    "nbytes": e.table_nbytes,
                    "score": _policy.cost_benefit_score(
                        e, now, self.hit_half_life_s),
                    "ttl_s": e.ttl_s if e.ttl_s is not None else self.ttl_s,
                    "version": e.version,
                })
        return out


# ------------------------------------------------------------- persistence


def save_cache(cache: SemanticCache, path: str) -> int:
    """Spill the cache to disk — now a thin shim over the tiered store
    (:mod:`repro_torch.storage`): one ``.npz`` payload per entry plus the
    crash-safe manifest (checkpoint + CRC-framed WAL, both written via
    temp file + fsync + atomic rename).  Returns the number of live entries.

    Incremental: an entry whose durable record already matches its
    ``version``/``snapshot_id`` costs only a metadata log record, not a
    payload rewrite.  Keys present on disk but no longer live in the cache
    are tombstoned (and their payload files removed), so a later
    ``load_cache`` cannot resurrect them.  When the cache already has this
    very directory attached as its store, the attached engine is reused
    (its pending write-behind state stays coherent)."""
    import os

    from ..storage.engine import TieredStore

    target = os.path.abspath(path)
    attached = cache.store is not None and cache.store.path == target
    store = cache.store if attached else TieredStore(target, async_spill=False)
    if not attached:
        store.open()
    live: dict = {}
    for key, e in cache._entries.items():
        live[key] = (e, e.table)
    for key, e in cache._cold.items():
        if attached:
            live[key] = (e, None)  # already durable in this very store
        else:
            t = cache.store.peek(key) if cache.store is not None else None
            if t is not None:
                live[key] = (e, t)
    for key, (e, t) in live.items():
        if t is not None:
            store.spill(key, e, t)
    for key in store.keys():
        if key not in live:
            store.delete(key)
    store.flush()
    store.compact()
    if not attached:
        store.close(compact=False)
    return len(live)


def load_cache(cache: SemanticCache, path: str) -> int:
    """Warm a cache from a spill directory — a shim over the tiered store's
    manifest replay.  Entries re-validate their key against the recomputed
    signature hash (tamper/versioning guard), payloads re-verify their
    sha256, and the persisted ``lru_stamp``/``store_stamp`` ride back in so
    LRU order and derivation probe MRU order reconstruct deterministically
    (the untiered loader reset both by re-``put``-ing every entry)."""
    import os

    from ..storage.engine import TieredStore

    store = TieredStore(os.path.abspath(path), async_spill=False)
    entries = store.open()
    adopted = []
    for e in entries:
        key = e.signature.key()
        table = store.peek(key)
        if table is None:
            continue  # damaged payload: never a false hit
        e.table = table
        e.table_nbytes = int(table.nbytes())
        adopted.append(e)
    store.close(compact=False)
    if adopted:
        live = set(cache.keys()) | set(cache.cold_keys())
        adopted = [e for e in adopted if e.signature.key() not in live]
        cache.rebuild(cache.export_entries() + adopted)
    return len(adopted)
