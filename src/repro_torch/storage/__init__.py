"""Tiered durable cache storage.

A hot (RAM) / cold (disk) hierarchy behind :class:`repro_torch.core.cache.SemanticCache`:

* :mod:`repro_torch.storage.manifest` — crash-safe record log: an atomic-rename
  checkpoint (``manifest.json``, the untiered spill format) plus an fsync'd append-only
  CRC-framed WAL (``manifest.log``) that is replayable after a kill at any
  byte offset.
* :mod:`repro_torch.storage.coldstore` — the cold tier proper: per-entry ``.npz``
  payloads written tmp+fsync+rename with sha256/size framing, orphan cleanup
  on replay.
* :mod:`repro_torch.storage.policy` — cost-benefit admission/eviction scoring
  (recompute-cost x decayed hit-count / bytes) with plain LRU kept as the
  differential oracle.
* :mod:`repro_torch.storage.engine` — :class:`TieredStore`, the write-behind spill
  engine (async worker thread, locks via the sanitizer's lock factory).

This ``__init__`` stays import-light: ``repro_torch.core.cache`` imports
``repro_torch.storage.policy`` at module scope, and the engine imports
``repro_torch.core.cache`` — the package root must not force the cycle.
"""
from __future__ import annotations

__all__ = ["TieredStore", "ColdTier", "DurableManifest",
           "LruPolicy", "CostPolicy", "make_policy",
           "decayed_hits", "cost_benefit_score"]


def __getattr__(name):  # lazy: avoid core.cache <-> storage import cycle
    if name == "TieredStore":
        from .engine import TieredStore
        return TieredStore
    if name in ("ColdTier",):
        from .coldstore import ColdTier
        return ColdTier
    if name in ("DurableManifest",):
        from .manifest import DurableManifest
        return DurableManifest
    if name in ("LruPolicy", "CostPolicy", "make_policy", "decayed_hits",
                "cost_benefit_score"):
        from . import policy as _p
        return getattr(_p, name)
    raise AttributeError(f"module 'repro_torch.storage' has no attribute {name!r}")
