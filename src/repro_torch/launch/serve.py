"""Serving launcher: SQL and NL request streams through the cache service,
with NL canonicalized by the in-framework LLM and misses answered by the
OLAP executor, both on the GPU.

Boots the SSB workload (schema + data synthesised from ``--seed``) and a
:class:`CacheService` with one tenant (``build_tenant`` ->
``register_tenant``): the executor on ``--device``, a semantic cache with
the dataset's level mapper (so roll-ups can hit), and an NL canonicalizer:
the canonicalizer LLM (``--arch``: any ported family, default
``canonicalizer-100m``, or ``mamba2-780m``; ``--reduced`` for the tiny
same-family config) served by :class:`ServingEngine` with weights
initialised from ``--seed``, or with ``--simulated-llm`` the calibrated
:class:`SimulatedLLM` (no model inference).  NL requests pass the balanced
safety policy.  It then replays (``submit_batch``) the SSB mixed stream (13
intents x 21 SQL variants + 10 NL paraphrases each, first ``--queries``)
and the hierarchical drill stream in batches of ``--batch``, and reports
statuses, hit rate, NL gating, backend executions, rows scanned and kernel
launches.  The repo holds no trained checkpoint: with initialised weights
the LLM's answers are malformed JSON and its NL requests bypass the cache.

Usage:
    python -m repro_torch.launch.serve --n-fact 6000000 --queries 403 --batch 8
    python -m repro_torch.launch.serve --device cpu --reduced
    python -m repro_torch.launch.serve --arch mamba2-780m --queries 62
    python -m repro_torch.launch.serve --n-fact 20000 --device cpu --simulated-llm
"""
from __future__ import annotations

import argparse
import collections
import dataclasses
import json

from ..core.cache import SemanticCache
from ..core.nl_canon import MemoizedNL, SimulatedLLM
from ..core.safety import SafetyPolicy
from ..kernels.binding import launch_counts
from ..olap.executor import OlapExecutor
from ..service import CacheService, QueryRequest, QueryResult, Tenant
from ..workloads import hierarchical, ssb

TENANT = "ssb"


def build_tenant(svc: CacheService, wl, device="cuda", nl=None,
                 shards: int | None = None) -> Tenant:
    """Register tenant ``TENANT`` over ``wl``'s dataset with ``svc``:
    executor on ``device``, semantic cache with the dataset's level mapper
    (an N-shard cluster of such caches with ``shards=N``), NL canonicalizer
    ``nl`` behind the balanced safety policy."""
    backend = OlapExecutor(wl.dataset, device=device)
    cache = SemanticCache(wl.schema, level_mapper=wl.dataset.level_mapper())
    return svc.register_tenant(
        TENANT, schema=wl.schema, backend=backend, cache=cache, nl=nl,
        policy=SafetyPolicy.balanced(wl.spatial_ambiguous), shards=shards)


def llm_canonicalizer(wl, arch: str = "canonicalizer-100m", reduced: bool = False,
                      seed: int = 0, device="cuda"):
    """``MemoizedNL(CanonicalizerService(engine))`` over ``arch`` with
    weights initialised from ``seed``.  A reduced config's head is widened
    to the workload tokenizer's vocabulary (the reduced head is narrower
    than the tokenizer, which constrained decoding cannot mask)."""
    from ..configs.registry import get, reduced as reduced_cfg
    from ..serving.engine import CanonicalizerService, ServingEngine
    from ..training.tokenizer import build_tokenizer

    tok = build_tokenizer([wl])
    cfg = reduced_cfg(arch) if reduced else get(arch)
    if cfg.vocab < tok.vocab_size:
        cfg = dataclasses.replace(cfg, vocab=tok.vocab_size)
    engine = ServingEngine(cfg, cfg.build().init_params(cfg, seed, device=device), tok,
                           device=device)
    return MemoizedNL(CanonicalizerService(engine, wl.schema.name))


def sql_streams(wl, queries=None, order: str = "sequential") -> dict[str, list[str]]:
    """The SSB SQL stream in ``order`` (first ``queries`` requests) and the
    hierarchical drill stream (20 sessions), as SQL texts."""
    stream = [q.text for q in wl.queries(nl_paraphrases=0, order=order)]
    return {
        "ssb_sql": stream if queries is None else stream[:queries],
        "drill": [q.text for q in hierarchical.build_stream(20)],
    }


def mixed_streams(wl, queries=None, order: str = "sequential") -> dict[str, list[QueryRequest]]:
    """The SSB mixed SQL + NL stream in ``order`` (first ``queries``
    requests) and the hierarchical drill stream, as requests."""
    stream = wl.queries(order=order)
    if queries is not None:
        stream = stream[:queries]
    return {
        "ssb_mixed": [QueryRequest(sql=q.text, tenant=TENANT) if q.kind == "sql"
                      else QueryRequest(nl=q.text, tenant=TENANT) for q in stream],
        "drill": [QueryRequest(sql=q.text, tenant=TENANT)
                  for q in hierarchical.build_stream(20)],
    }


def replay(svc: CacheService, requests: list, batch: int = 8) -> list[QueryResult]:
    """``svc.submit_batch`` over ``requests`` (QueryRequests, or SQL texts
    for tenant ``TENANT``) in batches of ``batch``: misses within a batch
    share one backend scan and identical in-flight intents are deduped."""
    reqs = [QueryRequest(sql=r, tenant=TENANT) if isinstance(r, str) else r
            for r in requests]
    out: list[QueryResult] = []
    for i in range(0, len(reqs), batch):
        out += svc.submit_batch(reqs[i:i + batch])
    return out


def summary(tenant: Tenant, results: list[QueryResult]) -> dict:
    s = tenant.cache.stats
    b = tenant.backend
    return {
        "requests": len(results),
        "statuses": dict(collections.Counter(r.status for r in results)),
        "nl_requests": sum(r.origin == "nl" for r in results),
        "hit_rate": s.hit_rate,
        "hits_exact": s.hits_exact,
        "hits_rollup": s.hits_rollup,
        "hits_filterdown": s.hits_filterdown,
        "misses": s.misses,
        "bypasses": tenant.stats.bypasses,
        "nl_gated": tenant.stats.nl_gated,
        "batched_misses": tenant.stats.batched_misses,
        "deduped_misses": tenant.stats.deduped_misses,
        "failures": tenant.stats.failures,
        "degraded": tenant.stats.degraded,
        "backend_executions": b.executions,
        "rows_scanned": b.rows_scanned,
        "kernel_launches": dict(launch_counts()),
    }


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n-fact", type=int, default=50_000)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--queries", type=int, default=None,
                    help="first N requests of the SSB mixed stream (default all)")
    ap.add_argument("--order", default="sequential",
                    choices=["sequential", "interleaved", "random", "zipf"],
                    help="order of the SSB stream: an intent's forms together "
                         "(sequential), round-robin across intents "
                         "(interleaved), shuffled, or popularity-skewed")
    ap.add_argument("--batch", type=int, default=8,
                    help="requests per pipeline batch (dashboard refresh size)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--simulated-llm", action="store_true",
                    help="canonicalize NL with the calibrated SimulatedLLM")
    ap.add_argument("--model", default="gpt-4o-mini",
                    help="SimulatedLLM error profile")
    ap.add_argument("--arch", default="canonicalizer-100m")
    ap.add_argument("--reduced", action="store_true",
                    help="the tiny same-family config of --arch")
    args = ap.parse_args(argv)

    wl = ssb.build(n_fact=args.n_fact, seed=args.seed)
    if args.simulated_llm:
        nl = MemoizedNL(SimulatedLLM(wl.vocab, model=args.model))
    else:
        nl = llm_canonicalizer(wl, args.arch, args.reduced, args.seed, args.device)
    svc = CacheService()
    tenant = build_tenant(svc, wl, device=args.device, nl=nl)
    results = []
    for name, reqs in mixed_streams(wl, args.queries, args.order).items():
        results += replay(svc, reqs, args.batch)
        print(f"[serve] {name}: {len(reqs)} requests replayed")
    print(json.dumps(summary(tenant, results)))


if __name__ == "__main__":
    main()
