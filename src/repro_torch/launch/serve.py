"""Serving launcher: SQL request streams through the semantic cache, with
misses answered by the OLAP executor on the GPU.

Boots the SSB workload (schema + data synthesised from ``--seed``), the
executor on ``--device``, and a plain :class:`SemanticCache` with the
dataset's level mapper (so roll-ups can hit), then replays the SSB SQL
stream (13 intents x 21 variants) and the hierarchical drill stream in
batches of ``--batch`` and reports statuses, hit rate, backend executions,
rows scanned and kernel launches.

Usage:
    python -m repro_torch.launch.serve --n-fact 6000000 --queries 273 --batch 8
    python -m repro_torch.launch.serve --n-fact 20000 --device cpu
"""
from __future__ import annotations

import argparse
import collections
import json

from ..core.cache import SemanticCache
from ..kernels.seg_agg.kernel import kernel_launches
from ..olap.executor import OlapExecutor
from ..service.pipeline import QueryRequest, QueryResult, Tenant, run_pipeline
from ..workloads import hierarchical, ssb


def build_tenant(wl, device="cuda") -> Tenant:
    """Tenant over ``wl``'s dataset: executor on ``device``, plain semantic
    cache with the dataset's level mapper."""
    backend = OlapExecutor(wl.dataset, device=device)
    cache = SemanticCache(wl.schema, level_mapper=wl.dataset.level_mapper())
    return Tenant.create(wl.schema, backend, cache)


def sql_streams(wl, queries=None) -> dict[str, list[str]]:
    """The SSB SQL stream (first ``queries`` requests) and the hierarchical
    drill stream (20 sessions), as SQL texts."""
    stream = [q.text for q in wl.queries(nl_paraphrases=0)]
    return {
        "ssb_sql": stream if queries is None else stream[:queries],
        "drill": [q.text for q in hierarchical.build_stream(20)],
    }


def replay(tenant: Tenant, sqls: list[str], batch: int = 8) -> list[QueryResult]:
    """Submit ``sqls`` in batches of ``batch``: misses within a batch share
    one backend scan and identical in-flight intents are deduped."""
    out: list[QueryResult] = []
    for i in range(0, len(sqls), batch):
        out += run_pipeline(tenant, [QueryRequest(sql=q) for q in sqls[i:i + batch]])
    return out


def summary(tenant: Tenant, results: list[QueryResult]) -> dict:
    s = tenant.cache.stats
    b = tenant.backend
    return {
        "requests": len(results),
        "statuses": dict(collections.Counter(r.status for r in results)),
        "hit_rate": s.hit_rate,
        "hits_exact": s.hits_exact,
        "hits_rollup": s.hits_rollup,
        "hits_filterdown": s.hits_filterdown,
        "misses": s.misses,
        "bypasses": tenant.stats.bypasses,
        "batched_misses": tenant.stats.batched_misses,
        "deduped_misses": tenant.stats.deduped_misses,
        "backend_executions": b.executions,
        "rows_scanned": b.rows_scanned,
        "kernel_launches": kernel_launches(),
    }


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n-fact", type=int, default=50_000)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--queries", type=int, default=None,
                    help="first N requests of the SSB SQL stream (default all)")
    ap.add_argument("--batch", type=int, default=8,
                    help="requests per pipeline batch (dashboard refresh size)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    wl = ssb.build(n_fact=args.n_fact, seed=args.seed)
    tenant = build_tenant(wl, device=args.device)
    results = []
    for name, sqls in sql_streams(wl, args.queries).items():
        results += replay(tenant, sqls, args.batch)
        print(f"[serve] {name}: {len(sqls)} requests replayed")
    print(json.dumps(summary(tenant, results)))


if __name__ == "__main__":
    main()
