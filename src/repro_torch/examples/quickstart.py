"""Quickstart: the paper's full pipeline on the port.

Builds the SSB workload (schema + synthetic data), boots the semantic cache
middleware with the calibrated NL canonicalizer over an ``OlapExecutor`` on
``--device`` (the card's seg_agg kernels by default), runs a mixed SQL/NL
dashboard session, and prints the cache's view of it.

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
"""
from __future__ import annotations

import argparse

from ..core import (MemoizedNL, SafetyPolicy, SemanticCache,
                    SemanticCacheMiddleware, SimulatedLLM)
from ..olap.executor import OlapExecutor
from ..workloads import ssb

REQUESTS = [
    # fine-grain query populates the cache (cold miss)
    ("sql", "SELECT c_nation, SUM(lo_revenue) AS revenue FROM lineorder "
            "JOIN customer ON lineorder.lo_custkey = customer.c_key "
            "JOIN dates ON lineorder.lo_orderdate = dates.d_key "
            "WHERE d_year = 1994 GROUP BY c_nation"),
    # same intent, different SQL surface form -> exact hit
    ("sql", "select SUM(lo_revenue) revenue, c_nation from lineorder "
            "join dates on dates.d_key = lineorder.lo_orderdate "
            "join customer on customer.c_key = lineorder.lo_custkey "
            "where lo_date >= '1994-01-01' and lo_date < '1995-01-01' "
            "group by c_nation"),
    # same intent in natural language -> cross-surface exact hit
    ("nl", "Show total revenue by customer nation in 1994"),
    # coarser grouping -> answered by roll-up derivation, no backend touch
    ("sql", "SELECT c_region, SUM(lo_revenue) AS revenue FROM lineorder "
            "JOIN customer ON lineorder.lo_custkey = customer.c_key "
            "JOIN dates ON lineorder.lo_orderdate = dates.d_key "
            "WHERE d_year = 1994 GROUP BY c_region"),
    # global total -> roll-up to the empty grouping
    ("nl", "What is total revenue in 1994?"),
]


def main(argv=None, served: list | None = None) -> dict:
    """Run the session; ``served``, where given, receives the five
    responses (their tables are what a caller holds to an oracle)."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n-fact", type=int, default=30_000, help="LINEORDER rows")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    wl = ssb.build(n_fact=args.n_fact)
    backend = OlapExecutor(wl.dataset, device=args.device)
    cache = SemanticCache(wl.schema, level_mapper=wl.dataset.level_mapper())
    mw = SemanticCacheMiddleware(
        wl.schema, backend, cache,
        nl=MemoizedNL(SimulatedLLM(wl.vocab, model="oracle")),
        policy=SafetyPolicy.balanced(wl.spatial_ambiguous,
                                     qualified=("customer region", "supplier region")),
    )

    responses = []
    for kind, text in REQUESTS:
        r = mw.query_sql(text) if kind == "sql" else mw.query_nl(text)
        rows = r.table.num_rows if r.table is not None else 0
        print(f"[{kind:3s}] {r.status:15s} rows={rows:3d}  {text[:60]}...")
        responses.append(r)
    if served is not None:
        served.extend(responses)

    s = cache.stats
    print(f"\nhits: exact={s.hits_exact} rollup={s.hits_rollup} "
          f"cross_surface={s.cross_surface_hits} | misses={s.misses} "
          f"| backend executions={backend.executions}")
    return {"statuses": [r.status for r in responses],
            "rows": [r.table.num_rows if r.table is not None else 0 for r in responses],
            "hits_exact": s.hits_exact, "hits_rollup": s.hits_rollup,
            "cross_surface_hits": s.cross_surface_hits, "misses": s.misses,
            "backend_executions": backend.executions}


if __name__ == "__main__":
    main()
