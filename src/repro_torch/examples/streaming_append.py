"""Streaming-append scenario: a live dashboard that survives data ticks.

The classic failure mode of snapshot invalidation (§6.2) is a dashboard of
open-ended intents losing its whole working set every time a micro-batch of
rows lands, then paying full scans to rebuild it.  With incremental refresh,
``advance_snapshot(delta=...)`` appends the rows, scans *only the delta
partition* as one fused batch, and merges the delta aggregates into the
cached tables — every tile stays a cache hit, and each tile's table is
verified here against an independent numpy full rescan of the grown table.

The live tenant's backend runs on ``--device``: on the card every delta
scan goes through the seg_agg kernels.  (The JAX script runs it on the
numpy oracle impl; the printed counts are the same.)

    PYTHONPATH=src python -m repro_torch.examples.streaming_append [--device cpu]
"""
from __future__ import annotations

import argparse

import numpy as np

from ..core import SemanticCache
from ..olap.executor import OlapExecutor
from ..service import CacheService, QueryRequest
from ..workloads import ssb
from .data import DASHBOARD, make_delta

ROWS, DELTA, TICKS = 60_000, 2_000, 3


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    print(f"building SSB with {ROWS:,} fact rows ...")
    wl = ssb.build(n_fact=ROWS, seed=0)
    backend = OlapExecutor(wl.dataset, device=args.device)
    svc = CacheService()
    svc.register_tenant("live", schema=wl.schema, backend=backend,
                        cache=SemanticCache(wl.schema,
                                            level_mapper=wl.dataset.level_mapper()))

    reqs = [QueryRequest(sql=q, tenant="live") for q in DASHBOARD]
    svc.submit_batch(reqs)  # cold warm-up: every tile misses once
    cache = svc.tenant("live").cache
    print(f"warmed {len(cache)} dashboard tiles (snapshot {wl.dataset.snapshot_id})")

    rng = np.random.default_rng(42)
    ticks = []
    for tick in range(1, TICKS + 1):
        delta = make_delta(wl.dataset, DELTA, rng)
        rep = svc.advance_snapshot("live", f"snap{tick}", delta=delta)
        served = svc.submit_batch(
            [QueryRequest(sql=q, tenant="live", read_only=True) for q in DASHBOARD])
        hits = sum(1 for r in served if r.hit)
        print(f"tick {tick}: +{rep.appended_rows:,} rows "
              f"[{rep.updated_start}, {rep.updated_end}) -> "
              f"{rep.refreshed} merged / {rep.recomputed} recomputed / "
              f"{rep.unaffected} untouched; dashboard: {hits}/{len(served)} hits, "
              f"{rep.delta_rows_scanned:,} rows scanned")
        ticks.append({"appended_rows": rep.appended_rows, "refreshed": rep.refreshed,
                      "recomputed": rep.recomputed, "unaffected": rep.unaffected,
                      "hits": hits, "delta_rows_scanned": rep.delta_rows_scanned})

    # trust, but verify: served tables match a full rescan of the grown table
    oracle = OlapExecutor(wl.dataset, impl="numpy")
    served = svc.submit_batch(
        [QueryRequest(sql=q, tenant="live", read_only=True) for q in DASHBOARD])
    if not all(r.hit and r.table.equals(oracle.execute(r.signature)) for r in served):
        raise AssertionError("a served tile differs from the full-rescan oracle")
    s = cache.stats
    print(f"verified {len(served)} tiles against full-rescan oracle at "
          f"{wl.dataset.fact.num_rows:,} rows")
    print(f"cache stats: {s.refreshes} delta merges, {s.refresh_fallbacks} "
          f"fallback recomputes, {s.invalidations} invalidations, "
          f"hit rate {s.hit_rate:.3f}")
    return {"ticks": ticks, "verified": len(served), "rows": wl.dataset.fact.num_rows,
            "refreshes": s.refreshes, "refresh_fallbacks": s.refresh_fallbacks,
            "invalidations": s.invalidations, "hit_rate": s.hit_rate}


if __name__ == "__main__":
    main()
