"""OLAP Intent Signature (§3.3) — the unified cache key for SQL and NL.

A signature captures *all* semantics that can affect the numerical output:
measures, grouping levels, filters, time window, post-aggregation operators,
and (optionally) a governed metric identity and tenant scope.  It serializes
to canonical JSON (sorted keys, normalized lists) and hashes with SHA-256 to a
fixed-length cache key, so different surface forms map to the same key.

Signatures are frozen after construction, so every derived form — the
canonical JSON, the SHA-256 key, the measure multiset, the filter set — is
*interned* on the instance the first time it is asked for and reused from
then on.  A request that flows one Signature object through lookup, miss
dedup, store, and spill therefore hashes exactly once; template-cache and
NL-memo hits that return a previously-interned instance hash zero times.
``key_hash_computations()`` exposes a counting hook so tests can assert the
one-hash-per-request invariant.
"""
from __future__ import annotations

import dataclasses
import datetime as _dt
import hashlib
import json
from typing import Any, Optional

COMPOSABLE_AGGS = ("SUM", "COUNT", "MIN", "MAX")  # roll-up-safe (§3.6)
ALL_AGGS = COMPOSABLE_AGGS + ("AVG", "COUNT_DISTINCT")

_OPS = ("=", "!=", "<", "<=", ">", ">=", "in")

# Counting hook for the interning invariant: incremented only when a key is
# actually SHA-256'd (memoized re-reads are free).  Tests reset it around a
# request and assert at most one computation.
_KEY_COMPUTES = 0


def key_hash_computations() -> int:
    return _KEY_COMPUTES


def reset_key_hash_computations() -> None:
    global _KEY_COMPUTES
    _KEY_COMPUTES = 0


def _canon_value(v: Any) -> Any:
    """Canonical literal format: ints stay ints, floats normalized, strings
    stripped; dates as ISO 'YYYY-MM-DD' strings."""
    if isinstance(v, bool):
        return int(v)
    if isinstance(v, float):
        if v == int(v) and abs(v) < 1e15:
            return int(v)
        return float(v)
    if isinstance(v, _dt.date):
        return v.isoformat()
    if isinstance(v, str):
        return v.strip()
    if isinstance(v, (list, tuple)):
        return tuple(sorted((_canon_value(x) for x in v), key=lambda x: (str(type(x)), str(x))))
    return v


@dataclasses.dataclass(frozen=True)
class Measure:
    """Aggregation function + canonical base expression, e.g. SUM(sales.amount).

    ``expr`` is the canonical expression string produced by the canonicalizer
    (fully-qualified lowercase identifiers, commutative operands sorted).
    """

    agg: str
    expr: str
    distinct: bool = False

    def __post_init__(self):
        agg = self.agg.upper()
        object.__setattr__(self, "agg", "COUNT_DISTINCT" if (agg == "COUNT" and self.distinct) else agg)
        if self.agg not in ALL_AGGS:
            raise ValueError(f"unsupported aggregation {self.agg!r}")

    def composable(self) -> bool:
        return self.agg in COMPOSABLE_AGGS and not self.distinct

    def to_json(self) -> dict:
        d = {"agg": self.agg, "expr": self.expr}
        if self.distinct:
            d["distinct"] = True
        return d


@dataclasses.dataclass(frozen=True)
class Filter:
    """A normalized predicate over a non-temporal dimension/fact column."""

    col: str  # fully-qualified 'table.column'
    op: str
    val: Any

    def __post_init__(self):
        if self.op not in _OPS:
            raise ValueError(f"unsupported filter op {self.op!r}")
        object.__setattr__(self, "val", _canon_value(self.val))
        # the JSON serialization of the (canonical) value is fixed at
        # construction — sort_key used to re-dump it on every comparison
        object.__setattr__(
            self, "_sort_key",
            (self.col, self.op, json.dumps(self.val, default=str, sort_keys=True)),
        )

    def sort_key(self) -> tuple:
        return self._sort_key

    def to_json(self) -> dict:
        v = self.val
        if isinstance(v, tuple):
            v = list(v)
        return {"col": self.col, "op": self.op, "val": v}


@dataclasses.dataclass(frozen=True)
class TimeWindow:
    """Explicit [start, end) boundaries on the time dimension (§3.3).

    ``open_ended`` marks windows derived from relative phrases ("last 30
    days"): they resolve to concrete boundaries at canonicalization time but
    must be refreshed on data arrival (§6.2), unlike closed windows.
    """

    start: str  # ISO date, inclusive
    end: str  # ISO date, exclusive
    open_ended: bool = False

    def __post_init__(self):
        s = _dt.date.fromisoformat(self.start)
        e = _dt.date.fromisoformat(self.end)
        if e < s:
            raise ValueError(f"time window end {self.end} before start {self.start}")

    def to_json(self) -> dict:
        d = {"start": self.start, "end": self.end}
        if self.open_ended:
            d["open_ended"] = True
        return d

    def contains(self, other: "TimeWindow") -> bool:
        return self.start <= other.start and other.end <= self.end

    def intersects(self, start: str, end: str) -> bool:
        return self.start < end and start < self.end


@dataclasses.dataclass(frozen=True)
class OrderKey:
    key: str  # level name or 'measure:<index>'
    desc: bool = False

    def to_json(self) -> dict:
        return {"key": self.key, "desc": self.desc}


@dataclasses.dataclass(frozen=True)
class HavingClause:
    """Post-aggregation predicate over a measure, by measure index."""

    measure: int
    op: str
    val: Any

    def __post_init__(self):
        if self.op not in _OPS:
            raise ValueError(f"unsupported having op {self.op!r}")
        object.__setattr__(self, "val", _canon_value(self.val))

    def to_json(self) -> dict:
        v = self.val
        if isinstance(v, tuple):
            v = list(v)
        return {"measure": self.measure, "op": self.op, "val": v}


@dataclasses.dataclass(frozen=True)
class Signature:
    """The OLAP Intent Signature — canonical cache key (§3.3)."""

    schema: str  # schema name the signature is resolved against
    measures: tuple[Measure, ...]
    levels: tuple[str, ...] = ()  # 'dim.level' names, canonically sorted
    filters: tuple[Filter, ...] = ()
    time_window: Optional[TimeWindow] = None
    having: tuple[HavingClause, ...] = ()
    order_by: tuple[OrderKey, ...] = ()
    limit: Optional[int] = None
    metric_id: Optional[str] = None  # governed-layer identity (optional)
    scope: Optional[str] = None  # tenant/user isolation (optional)

    def __post_init__(self):
        if not self.measures:
            raise ValueError("signature requires at least one measure")
        object.__setattr__(self, "levels", tuple(sorted(self.levels)))
        object.__setattr__(
            self, "filters", tuple(sorted(self.filters, key=Filter.sort_key))
        )
        object.__setattr__(
            self, "having", tuple(sorted(self.having, key=lambda h: (h.measure, h.op, str(h.val))))
        )
        # set-semantics view of the filters, used by the derivation planners'
        # subset checks (Filter is frozen/hashable, so no JSON round trip)
        object.__setattr__(self, "_filters_frozen", frozenset(self.filters))

    def _interned(self, slot: str, compute):
        cached = self.__dict__.get(slot)
        if cached is None:
            cached = compute()
            object.__setattr__(self, slot, cached)
        return cached

    # ------------------------------------------------------------- canonical
    def to_json(self) -> dict:
        d: dict[str, Any] = {
            "schema": self.schema,
            "measures": [m.to_json() for m in self.measures],
            "levels": list(self.levels),
            "filters": [f.to_json() for f in self.filters],
        }
        if self.time_window is not None:
            d["time_window"] = self.time_window.to_json()
        if self.having:
            d["having"] = [h.to_json() for h in self.having]
        if self.order_by:
            d["order_by"] = [o.to_json() for o in self.order_by]
        if self.limit is not None:
            d["limit"] = self.limit
        if self.metric_id is not None:
            d["metric_id"] = self.metric_id
        if self.scope is not None:
            d["scope"] = self.scope
        return d

    def canonical_json(self) -> str:
        return self._interned("_canonical_json", lambda: json.dumps(
            self.to_json(), sort_keys=True, separators=(",", ":"), default=str))

    def key(self) -> str:
        """SHA-256 over the canonical JSON — the fixed-length cache key.
        Interned: computed once per instance (see ``key_hash_computations``)."""
        k = self.__dict__.get("_key")
        if k is None:
            global _KEY_COMPUTES
            _KEY_COMPUTES += 1
            k = hashlib.sha256(self.canonical_json().encode()).hexdigest()
            object.__setattr__(self, "_key", k)
        return k

    # --------------------------------------------------------------- helpers
    def has_order_or_limit(self) -> bool:
        return bool(self.order_by) or self.limit is not None

    def all_composable(self) -> bool:
        return all(m.composable() for m in self.measures)

    def measure_key(self) -> tuple:
        """Identity of the measure set (used by the derivation index)."""
        return self._interned("_measure_key", lambda: tuple(
            sorted((m.agg, m.expr, m.distinct) for m in self.measures)))

    def filters_frozen(self) -> frozenset:
        """The filters as a frozenset of :class:`Filter` (precomputed at
        construction) — the derivation planners' subset-check currency."""
        return self._filters_frozen

    def filter_set(self) -> frozenset:
        return self._interned("_filter_set", lambda: frozenset(
            (f.col, f.op, json.dumps(f.val, default=str)) for f in self.filters))

    def replace(self, **kw) -> "Signature":
        return dataclasses.replace(self, **kw)


def signature_from_json(obj: dict) -> Signature:
    """Parse a signature from (LLM-emitted) JSON.  Raises on malformed input —
    the safety layer treats parse failures as bypass."""
    measures = tuple(
        Measure(m["agg"], m["expr"], bool(m.get("distinct", False)))
        for m in obj["measures"]
    )
    filters = tuple(
        Filter(f["col"], f["op"], f["val"]) for f in obj.get("filters", ())
    )
    tw = None
    if obj.get("time_window"):
        t = obj["time_window"]
        tw = TimeWindow(t["start"], t["end"], bool(t.get("open_ended", False)))
    having = tuple(
        HavingClause(h["measure"], h["op"], h["val"]) for h in obj.get("having", ())
    )
    order = tuple(
        OrderKey(o["key"], bool(o.get("desc", False))) for o in obj.get("order_by", ())
    )
    return Signature(
        schema=obj["schema"],
        measures=measures,
        levels=tuple(obj.get("levels", ())),
        filters=filters,
        time_window=tw,
        having=having,
        order_by=order,
        limit=obj.get("limit"),
        metric_id=obj.get("metric_id"),
        scope=obj.get("scope"),
    )
