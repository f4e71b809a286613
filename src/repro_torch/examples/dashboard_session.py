"""Dashboard session replay on the batch-first service API: a BI tool, a
notebook, and an NL interface all hitting one CacheService tenant over NYC
TLC data — the paper's cross-client fragmentation story, plus LRU behaviour
under a Zipf request mix.  Requests arrive in refresh-sized batches, so each
wave's cache misses are deduped and executed as one shared backend scan on
``--device`` (the card's seg_agg kernels by default).

    PYTHONPATH=src python -m repro_torch.examples.dashboard_session [--device cpu]
"""
from __future__ import annotations

import argparse

from ..core import MemoizedNL, SafetyPolicy, SemanticCache, SimulatedLLM
from ..olap.executor import OlapExecutor
from ..service import CacheService, QueryRequest
from ..workloads import nyc_tlc

REFRESH = 8  # tiles per dashboard refresh wave


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    wl = nyc_tlc.build(n_fact=60_000)
    backend = OlapExecutor(wl.dataset, device=args.device)
    cache = SemanticCache(wl.schema, capacity=10,  # ~half the intent set: LRU visible
                          level_mapper=wl.dataset.level_mapper())
    svc = CacheService()
    tenant = svc.register_tenant(
        "tlc", schema=wl.schema, backend=backend, cache=cache,
        nl=MemoizedNL(SimulatedLLM(wl.vocab, model="gpt-4o-mini")),
        policy=SafetyPolicy.balanced(
            wl.spatial_ambiguous,
            qualified=("pickup zone", "dropoff zone", "pickup borough", "dropoff borough")))

    stream = wl.queries(order="zipf", seed=7)[:400]
    reqs = [QueryRequest(sql=q.text, tenant="tlc") if q.kind == "sql"
            else QueryRequest(nl=q.text, tenant="tlc") for q in stream]
    for i in range(0, len(reqs), REFRESH):
        svc.submit_batch(reqs[i:i + REFRESH])

    s = cache.stats
    t = tenant.stats
    print(f"zipf dashboard mix over {len(stream)} requests, "
          f"waves of {REFRESH}, cache capacity 10 intents")
    print(f"  hit rate        : {s.hit_rate:.3f}")
    print(f"  exact / rollup  : {s.hits_exact} / {s.hits_rollup}")
    print(f"  cross-surface   : {s.cross_surface_hits} (NL served by SQL-seeded entries or v.v.)")
    print(f"  evictions       : {s.evictions} (LRU)")
    print(f"  batched misses  : {t.batched_misses} (served by shared execute_batch scans)")
    print(f"  deduped in-batch: {t.deduped_misses} (identical in-flight intents coalesced)")
    print(f"  backend executes: {backend.executions} "
          f"({backend.rows_scanned:,} fact rows scanned vs "
          f"{len(stream) * wl.dataset.fact.num_rows:,} without the cache)")
    out = {"requests": len(stream), "hit_rate": s.hit_rate, "hits_exact": s.hits_exact,
           "hits_rollup": s.hits_rollup, "cross_surface_hits": s.cross_surface_hits,
           "evictions": s.evictions, "batched_misses": t.batched_misses,
           "deduped_misses": t.deduped_misses, "backend_executions": backend.executions,
           "rows_scanned": backend.rows_scanned}

    # data refresh: new partition arrives -> open/intersecting windows invalidated
    # (streaming_append shows the delta path that refreshes in place)
    rep = svc.advance_snapshot("tlc", "snap1", "2024-12-01", "2025-01-01")
    print(f"  invalidated on refresh of [2024-12-01, 2025-01-01): {rep.dropped} entries")

    # warm the next day's dashboard through the same pipeline the live path uses
    warmed = svc.warm(reqs[:REFRESH])
    re_executed = sum(1 for r in warmed if r.status == "miss")
    present = sum(1 for r in warmed if r.hit)
    print(f"  warm({REFRESH} tiles)  : {re_executed} re-executed, {present} already present")
    return {**out, "invalidated": rep.dropped, "warm_re_executed": re_executed,
            "warm_present": present}


if __name__ == "__main__":
    main()
