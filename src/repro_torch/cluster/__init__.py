"""Sharded concurrent cache cluster.

Partitions the signature key space across N locked :class:`CacheShard` s by
derivation-family key ``(scope, schema, measure_key)`` — keeping roll-up /
filter-down candidates shard-local — with single-flight miss deduplication
and a scatter-gather router exposing the full ``SemanticCache`` surface.
``CacheCluster(shards=1)`` is a differential oracle for the unsharded path.
"""

from .cluster import CacheCluster, family_hash, family_key
from .flight import DEFAULT_FLIGHT_TIMEOUT_S, Flight
from .shard import CacheShard

__all__ = [
    "CacheCluster", "CacheShard", "DEFAULT_FLIGHT_TIMEOUT_S", "Flight",
    "family_hash", "family_key",
]
