"""Serving launcher: SQL and NL request streams through the cache service,
with NL canonicalized by the in-framework LLM and misses answered by the
OLAP executor, both on the GPU.

Boots a workload (``--workload``: SSB, NYC TLC or TPC-DS; schema + data
synthesised from ``--seed``) and a :class:`CacheService` with one tenant
(``build_tenant`` -> ``register_tenant``): the executor on ``--device``, a
semantic cache with the dataset's level mapper (so roll-ups can hit) and at
most ``--capacity`` entries, and an NL canonicalizer: the canonicalizer LLM
(``--arch``: any registry config of the four families, default
``canonicalizer-100m``, e.g. the SSM ``mamba2-780m``, the hybrid
``zamba2-7b``, the MoE ``qwen3-moe-235b-a22b`` or ``kimi-k2-1t-a32b``;
``--reduced`` for the tiny same-family config) served by
:class:`ServingEngine` with weights initialised from ``--seed`` or
restored from a training checkpoint (``--ckpt-dir``), or with
``--simulated-llm`` the calibrated :class:`SimulatedLLM` (no model
inference).  NL requests pass the balanced safety policy.  It then replays
(``submit_batch``) the workload's mixed stream (its intents x 21 SQL
variants + 10 NL paraphrases each, first ``--queries``) and, for SSB, the
hierarchical drill stream, in batches of ``--batch``, and reports statuses,
hit rate, NL gating, backend executions, rows scanned and kernel launches.
With initialised weights the LLM's answers are malformed JSON and its NL
requests bypass the cache; ``launch.train`` (or the JAX package's
``train``) writes the checkpoints that ``--ckpt-dir`` reads.

``--ckpt-dir`` departs from the reference's launcher on purpose: that one
asks ``restore_latest`` for a tree of parameters alone, which never
matches a training checkpoint (it also holds the optimizer's ``o/...``
leaves), and serves initialised weights without a word.  Here the
``p/...`` leaves of the newest valid checkpoint whose parameter names fit
the arch are restored (``restore_latest(..., subtree="p")``), the
tokenizer is built over the checkpoint's ``extra["tokenizer_workloads"]``
where it has them (``launch.train`` writes them; else over the served
workload), and the restored step is printed.

Usage:
    python -m repro_torch.launch.serve --n-fact 6000000 --queries 403 --batch 8
    python -m repro_torch.launch.serve --workload tpcds --n-fact 2880404 --simulated-llm
    python -m repro_torch.launch.serve --device cpu --reduced
    python -m repro_torch.launch.serve --ckpt-dir ckpts/canon --queries 62
    python -m repro_torch.launch.serve --arch mamba2-780m --queries 62
    python -m repro_torch.launch.serve --arch zamba2-7b --queries 62
    python -m repro_torch.launch.serve --device cpu --reduced --arch kimi-k2-1t-a32b
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
from ..workloads import hierarchical, nyc_tlc, ssb, tpcds

TENANT = "ssb"
WORKLOADS = {"ssb": ssb, "nyc_tlc": nyc_tlc, "tpcds": tpcds}


def build_tenant(svc: CacheService, wl, device="cuda", nl=None,
                 shards: int | None = None, capacity: int | None = None) -> Tenant:
    """Register tenant ``TENANT`` over ``wl``'s dataset with ``svc``:
    executor on ``device``, semantic cache with the dataset's level mapper
    and at most ``capacity`` entries (an N-shard cluster of such caches
    with ``shards=N``), NL canonicalizer ``nl`` behind the balanced safety
    policy."""
    backend = OlapExecutor(wl.dataset, device=device)
    cache = SemanticCache(wl.schema, capacity=capacity,
                          level_mapper=wl.dataset.level_mapper())
    return svc.register_tenant(
        TENANT, schema=wl.schema, backend=backend, cache=cache, nl=nl,
        policy=SafetyPolicy.balanced(wl.spatial_ambiguous), shards=shards)


def restore_params(cfg, ckpt_dir: str, device="cuda"):
    """The ``p/...`` leaves of the newest valid checkpoint in ``ckpt_dir``
    whose parameter names are ``cfg``'s, in the port's layout on
    ``device``: (params, step, extra), or (None, -1, {}) where no
    checkpoint fits."""
    from ..models.convert import params_from_jax
    from ..training.checkpoint import restore_latest

    def leaf_names(v):  # a stack's names are its layers'; a leaf is None
        v = v[0] if isinstance(v, list) else v
        return {n: None for n in v} if isinstance(v, dict) else None

    names = {k: leaf_names(v) for k, v in cfg.param_shapes().items()}
    tree, step, extra = restore_latest(ckpt_dir, names, subtree="p")
    if tree is None:
        return None, -1, {}
    return params_from_jax(cfg, tree, device=device), step, extra


def served_model(base, wl, ckpt_dir: str | None = None, device="cuda"):
    """What the canonicalizer over ``base`` serves for workload ``wl``:
    (cfg, params, tokenizer, step).  With ``ckpt_dir``, params and step
    come from the newest checkpoint there that fits ``base``
    (``restore_params``) and the tokenizer is built over the checkpoint's
    ``extra["tokenizer_workloads"]`` where it names them (token ids are the
    sorted words, so the workload set decides them); else params are None,
    step -1 and the tokenizer is built over ``wl``.  ``cfg`` is ``base``
    with its head widened to the tokenizer's vocabulary where narrower
    (constrained decoding cannot mask a head narrower than the tokenizer)."""
    from ..training.tokenizer import build_tokenizer

    params, step, extra = (None, -1, {}) if ckpt_dir is None else \
        restore_params(base, ckpt_dir, device)
    tok = build_tokenizer([wl if n == wl.name else WORKLOADS[n].build(n_fact=1000)
                           for n in extra.get("tokenizer_workloads", [wl.name])])
    cfg = base
    if cfg.vocab < tok.vocab_size:
        cfg = dataclasses.replace(cfg, vocab=tok.vocab_size)
    if params is not None and tuple(params["embed"].shape) != (cfg.vocab, cfg.d_model):
        raise SystemExit(f"{ckpt_dir}: step {step}'s embedding "
                         f"{tuple(params['embed'].shape)} does not fit {cfg.name} with "
                         f"vocab {cfg.vocab}")
    return cfg, params, tok, step


def llm_canonicalizer(wl, arch: str = "canonicalizer-100m", reduced: bool = False,
                      seed: int = 0, device="cuda", ckpt_dir: str | None = None):
    """``MemoizedNL(CanonicalizerService(engine))`` over ``arch`` with
    weights initialised from ``seed``, or restored from the newest
    checkpoint in ``ckpt_dir`` that fits the arch, with the tokenizer and
    head width of ``served_model``."""
    from ..configs.registry import get, reduced as reduced_cfg
    from ..serving.engine import CanonicalizerService, ServingEngine

    cfg, params, tok, step = served_model(reduced_cfg(arch) if reduced else get(arch),
                                          wl, ckpt_dir, device)
    if params is None:
        if ckpt_dir is not None:
            print(f"[serve] no checkpoint in {ckpt_dir} fits {cfg.name}: serving "
                  f"weights initialised from seed {seed}")
        params = cfg.build().init_params(cfg, seed, device=device)
    else:
        print(f"[serve] restored canonicalizer from step {step}")
    engine = ServingEngine(cfg, params, tok, device=device)
    return MemoizedNL(CanonicalizerService(engine, wl.schema.name))


def sql_streams(wl, queries=None, order: str = "sequential") -> dict[str, list[str]]:
    """The workload's SQL stream in ``order`` (first ``queries`` requests),
    ``<name>_sql``, and for SSB the hierarchical drill stream (20
    sessions), as SQL texts."""
    stream = [q.text for q in wl.queries(nl_paraphrases=0, order=order)]
    out = {f"{wl.name}_sql": stream if queries is None else stream[:queries]}
    if wl.name == "ssb":
        out["drill"] = [q.text for q in hierarchical.build_stream(20)]
    return out


def mixed_streams(wl, queries=None, order: str = "sequential") -> dict[str, list[QueryRequest]]:
    """The workload's mixed SQL + NL stream in ``order`` (first ``queries``
    requests), ``<name>_mixed``, and for SSB the hierarchical drill stream,
    as requests."""
    stream = wl.queries(order=order)
    if queries is not None:
        stream = stream[:queries]
    out = {f"{wl.name}_mixed": [QueryRequest(sql=q.text, tenant=TENANT) if q.kind == "sql"
                                else QueryRequest(nl=q.text, tenant=TENANT)
                                for q in stream]}
    if wl.name == "ssb":
        out["drill"] = [QueryRequest(sql=q.text, tenant=TENANT)
                        for q in hierarchical.build_stream(20)]
    return out


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
    ap.add_argument("--workload", default="ssb", choices=sorted(WORKLOADS))
    ap.add_argument("--n-fact", type=int, default=50_000)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--queries", type=int, default=None,
                    help="first N requests of the mixed stream (default all)")
    ap.add_argument("--order", default="sequential",
                    choices=["sequential", "interleaved", "random", "zipf"],
                    help="order of the mixed stream: an intent's forms together "
                         "(sequential), round-robin across intents "
                         "(interleaved), shuffled, or popularity-skewed")
    ap.add_argument("--batch", type=int, default=8,
                    help="requests per pipeline batch (dashboard refresh size)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--simulated-llm", action="store_true",
                    help="canonicalize NL with the calibrated SimulatedLLM")
    ap.add_argument("--model", default="gpt-4o-mini",
                    help="SimulatedLLM error profile")
    ap.add_argument("--arch", default="canonicalizer-100m",
                    help="the LLM's registry config: dense (canonicalizer-100m, "
                         "gemma-2b, ...), MoE (qwen3-moe-235b-a22b, kimi-k2-1t-a32b), "
                         "SSM (mamba2-780m) or hybrid (zamba2-7b)")
    ap.add_argument("--reduced", action="store_true",
                    help="the tiny same-family config of --arch")
    ap.add_argument("--capacity", type=int, default=None,
                    help="most entries the semantic cache holds (default unbounded)")
    ap.add_argument("--ckpt-dir", default=None,
                    help="restore the LLM's weights from the newest training "
                         "checkpoint here that fits --arch")
    args = ap.parse_args(argv)

    wl = WORKLOADS[args.workload].build(n_fact=args.n_fact, seed=args.seed)
    if args.simulated_llm:
        nl = MemoizedNL(SimulatedLLM(wl.vocab, model=args.model))
    else:
        nl = llm_canonicalizer(wl, args.arch, args.reduced, args.seed, args.device,
                               args.ckpt_dir)
    svc = CacheService()
    tenant = build_tenant(svc, wl, device=args.device, nl=nl, capacity=args.capacity)
    results = []
    for name, reqs in mixed_streams(wl, args.queries, args.order).items():
        results += replay(svc, reqs, args.batch)
        print(f"[serve] {name}: {len(reqs)} requests replayed")
    print(json.dumps(summary(tenant, results)))


if __name__ == "__main__":
    main()
