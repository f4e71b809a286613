"""Cost-benefit admission/eviction scoring for the tiered cache.

The currency (after Szépkúti, "Caching in Multidimensional Databases") is
*recompute cost x reuse probability / bytes*, not recency:

    score(e) = (cost_ms + floor) * (1 + decayed_hits(e)) / max(nbytes, 1)

* ``cost_ms`` is the stored execute-stage timing for the entry's query — what
  a miss would pay again (``floor`` keeps never-timed entries comparable);
* ``decayed_hits`` is the hit count decayed exponentially with idle time
  (half-life ``half_life_s``) — a frequency estimate that forgets, so a
  burst a week ago does not pin an entry forever;
* dividing by ``table_nbytes`` makes the score a per-byte benefit density:
  under a byte budget, evicting the lowest-density entry frees the most
  bytes per unit of future cost incurred.

Two policies share one duck-typed surface (``victim(entries, now)`` over the
cache's LRU-ordered hot dict, ``admit_cold(entry, now)`` for demote-vs-drop):

* :class:`LruPolicy` — the behavior from before tiering, kept as the differential
  oracle (``policy="lru"``): victim = front of the OrderedDict, every victim
  admitted to the cold tier.
* :class:`CostPolicy` — scans only the ``sample`` oldest entries (the LRU
  prefix) and evicts the min-score one: scan-resistant (one-touch scans age
  to the front and score near zero) without ever evicting the hot MRU tail.

This module deliberately imports nothing from the rest of ``repro`` so
``core.cache`` can import it at module scope without a cycle; entries are
duck-typed (``hits``, ``cost_ms``, ``table_nbytes``, ``last_used_at``).
"""
from __future__ import annotations

import math
from typing import Optional

__all__ = ["decayed_hits", "cost_benefit_score", "LruPolicy", "CostPolicy",
           "make_policy", "DEFAULT_HALF_LIFE_S", "COST_FLOOR_MS",
           "DEFAULT_SAMPLE"]

DEFAULT_HALF_LIFE_S = 600.0
COST_FLOOR_MS = 0.05
DEFAULT_SAMPLE = 64


def decayed_hits(entry, now: float,
                 half_life_s: float = DEFAULT_HALF_LIFE_S) -> float:
    """Hit count decayed by idle time: ``hits * 2^(-idle / half_life)``."""
    hits = float(getattr(entry, "hits", 0))
    if hits <= 0.0:
        return 0.0
    last = getattr(entry, "last_used_at", None)
    if last is None or half_life_s <= 0.0:
        return hits
    idle = max(0.0, now - last)
    return hits * math.pow(2.0, -idle / half_life_s)


def cost_benefit_score(entry, now: float,
                       half_life_s: float = DEFAULT_HALF_LIFE_S) -> float:
    """Per-byte benefit density of keeping ``entry`` (higher = keep)."""
    cost = max(float(getattr(entry, "cost_ms", 0.0)), 0.0) + COST_FLOOR_MS
    benefit = cost * (1.0 + decayed_hits(entry, now, half_life_s))
    nbytes = max(int(getattr(entry, "table_nbytes", 0)), 1)
    return benefit / nbytes


class LruPolicy:
    """Plain LRU: the differential oracle (the eviction order from before tiering)."""

    name = "lru"

    def victim(self, entries, now: float) -> str:
        return next(iter(entries))

    def admit_cold(self, entry, now: float) -> bool:
        return True


class CostPolicy:
    """Cost-benefit eviction over a sample of the LRU-oldest entries."""

    name = "cost"

    def __init__(self, half_life_s: float = DEFAULT_HALF_LIFE_S,
                 sample: int = DEFAULT_SAMPLE,
                 demote_min_score: float = 0.0):
        self.half_life_s = half_life_s
        self.sample = max(1, sample)
        self.demote_min_score = demote_min_score

    def victim(self, entries, now: float) -> str:
        best_key = None
        best_score = math.inf
        for i, (key, e) in enumerate(entries.items()):
            if i >= self.sample:
                break
            s = cost_benefit_score(e, now, self.half_life_s)
            if s < best_score:
                best_score = s
                best_key = key
        return best_key

    def admit_cold(self, entry, now: float) -> bool:
        if self.demote_min_score <= 0.0:
            return True
        return (cost_benefit_score(entry, now, self.half_life_s)
                >= self.demote_min_score)


def make_policy(name: Optional[str], **kwargs):
    """``"lru"`` | ``"cost"`` -> policy instance (extra kwargs to CostPolicy)."""
    if name in (None, "lru"):
        return LruPolicy()
    if name == "cost":
        return CostPolicy(**kwargs)
    raise ValueError(f"unknown cache policy {name!r} (expected 'lru'|'cost')")
