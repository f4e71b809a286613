"""The port's serving path on the CPU against the JAX package's.

* ``json_decode``: the same token masks and picks;
* ``ServingEngine.generate`` with ``reduced("canonicalizer-100m")`` at
  vocab 4096 (the reduced head of 256 is narrower than the SSB tokenizer's
  280 ids), float32, ``max_len`` 128, the JAX init converted: identical
  tokens and texts, mean log-probability within 1e-4;
* the port's ``CacheService`` against the JAX ``CacheService`` with
  ``SafetyPolicy.balanced``: 16 SSB NL requests through
  ``MemoizedNL(CanonicalizerService(engine))`` (identical ``NLResult``s;
  with initialised weights every answer is malformed JSON and bypasses),
  and the SSB mixed stream plus the drill stream through
  ``MemoizedNL(SimulatedLLM)``: statuses, provenance, tables, cache and
  NL-gating counters identical;
* the launcher runs with ``--simulated-llm`` on the CPU.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import reduced as jreduced
from repro.core import MemoizedNL as JMemoizedNL
from repro.core import SafetyPolicy as JSafetyPolicy
from repro.core import SemanticCache as JSemanticCache
from repro.core import SimulatedLLM as JSimulatedLLM
from repro.olap.executor import OlapExecutor as JOlapExecutor
from repro.serving import engine as jengine
from repro.serving import json_decode as jjson
from repro.service import CacheService, QueryRequest as JQueryRequest
from repro.training.tokenizer import build_tokenizer as jbuild_tokenizer
from repro.workloads import hierarchical as jhier
from repro_torch.configs.registry import reduced
from repro_torch.core.cache import SemanticCache
from repro_torch.core.nl_canon import MemoizedNL, SimulatedLLM
from repro_torch.core.safety import SafetyPolicy
from repro_torch.launch import serve
from repro_torch.models.convert import params_from_jax
from repro_torch.olap.columnar import from_reference
from repro_torch.olap.executor import OlapExecutor
from repro_torch.serving import engine, json_decode
from repro_torch.service import CacheService as PCacheService
from repro_torch.service import QueryRequest
from repro_torch.training.tokenizer import build_tokenizer
from repro_torch.workloads import ssb


@pytest.fixture(scope="module")
def port_wl():
    return ssb.build(n_fact=4000, seed=0)


@pytest.fixture(scope="module")
def engines(ssb_small, port_wl):
    jcfg = dataclasses.replace(jreduced("canonicalizer-100m"), vocab=4096,
                               dtype=jnp.float32)
    jparams = jcfg.build().init_params(jcfg, jax.random.PRNGKey(0))
    jtok, tok = jbuild_tokenizer([ssb_small]), build_tokenizer([port_wl])
    assert tok.vocab == jtok.vocab and tok.vocab_size == 280
    cfg = dataclasses.replace(reduced("canonicalizer-100m"), vocab=4096,
                              dtype=torch.float32)
    params = params_from_jax(cfg, jax.tree.map(np.asarray, jparams), device="cpu")
    return (jengine.ServingEngine(jcfg, jparams, jtok, max_len=128),
            engine.ServingEngine(cfg, params, tok, max_len=128, device="cpu"))


def _nl_texts(wl, n):
    return list(dict.fromkeys(q.text for q in wl.queries() if q.kind == "nl"))[:n]


def test_json_masks_match_jax(engines):
    vocab = engines[1].vocab
    a, ja = json_decode.JsonSigAutomaton(), jjson.JsonSigAutomaton()
    rng = np.random.default_rng(0)
    prefix = ""
    for p in ['', '{', '{"schema"', '{"schema": "ssb", "measures": [{"agg": "SUM"',
              '{"measures": [{"agg": "SUM", "expr": "t.x"}]}', '}', '{)']:
        np.testing.assert_array_equal(a.token_mask(p, vocab), ja.token_mask(p, vocab))
    for _ in range(30):  # a random walk through legal prefixes
        logits = rng.normal(size=len(vocab)).astype(np.float32)
        nid = json_decode.constrained_sample(logits, prefix, vocab, a)
        assert nid == jjson.constrained_sample(logits, prefix, vocab, ja)
        if nid < 0:
            break
        prefix += vocab[nid]
        assert a.is_complete(prefix) == ja.is_complete(prefix)


@pytest.mark.parametrize("constrained,max_new", [(False, 16), (True, 24)])
def test_generate_matches_jax(engines, port_wl, constrained, max_new):
    jeng, eng = engines
    prompts = [f"question: {t}\nsignature: " for t in _nl_texts(port_wl, 3)]
    want = jeng.generate(prompts, max_new_tokens=max_new, constrained=constrained)
    got = eng.generate(prompts, max_new_tokens=max_new, constrained=constrained)
    for g, w in zip(got, want):
        assert g["tokens"] == [int(t) for t in w["tokens"]]
        assert g["text"] == w["text"]
        assert g["logprob"] == pytest.approx(w["logprob"], abs=1e-4)
    assert eng.steps > 0 and eng.host_s > 0 and eng.model_s > 0


def _jax_tenant(svc, wl, nl):
    cache = JSemanticCache(wl.schema, level_mapper=wl.dataset.level_mapper())
    return svc.register_tenant(
        "ssb", schema=wl.schema, cache=cache, nl=nl,
        backend=JOlapExecutor(wl.dataset, impl="xla"),
        policy=JSafetyPolicy.balanced(wl.spatial_ambiguous))


def _replay_both(ssb_small, port_wl, forms, jnl, nl):
    """``forms``: [("sql" | "nl", text)] through a JAX service tenant and a
    port tenant, in batches of 8."""
    svc = CacheService()
    jtenant = _jax_tenant(svc, ssb_small, jnl)
    ds = from_reference(ssb_small.dataset)
    psvc = PCacheService()
    tenant = psvc.register_tenant(
        "ssb", schema=ds.schema, backend=OlapExecutor(ds, device="cpu"),
        cache=SemanticCache(ds.schema, level_mapper=ds.level_mapper()),
        nl=nl, policy=SafetyPolicy.balanced(port_wl.spatial_ambiguous))
    jres, res = [], []
    for i in range(0, len(forms), 8):
        chunk = forms[i:i + 8]
        jres += svc.submit_batch([JQueryRequest(tenant="ssb", **{k: t}) for k, t in chunk])
        res += psvc.submit_batch([QueryRequest(tenant="ssb", **{k: t}) for k, t in chunk])
    return jres, jtenant, res, tenant


def _assert_same_results(forms, jres, jtenant, res, tenant):
    assert tenant.stats.failures == tenant.stats.degraded == 0
    assert [r.status for r in res] == [r.status for r in jres]
    for i, (r, jr) in enumerate(zip(res, jres)):
        assert r.origin == jr.origin and r.provenance == jr.provenance, (i, forms[i])
        assert r.bypass_reason == jr.bypass_reason, i
        assert r.confidence == jr.confidence, i
        assert (r.batched, r.deduped) == (jr.batched, jr.deduped), i
        assert (r.signature is None) == (jr.signature is None), i
        if jr.signature is not None:
            assert r.signature.key() == jr.signature.key(), i
        if jr.table is None:
            assert r.table is None, i
        else:
            assert r.table.equals(jr.table), (i, forms[i])
    assert dataclasses.asdict(tenant.cache.stats) == dataclasses.asdict(jtenant.cache.stats)
    for name in ("requests", "batches", "bypasses", "nl_gated", "backend_executions",
                 "batched_misses", "deduped_misses", "stores"):
        assert getattr(tenant.stats, name) == getattr(jtenant.stats, name), name
    assert tenant.backend.executions == jtenant.backend.executions
    assert tenant.backend.rows_scanned == jtenant.backend.rows_scanned


def test_llm_canonicalizer_pipeline_matches_jax(engines, ssb_small, port_wl):
    jeng, eng = engines
    jnl = JMemoizedNL(jengine.CanonicalizerService(jeng, "ssb"))
    nl = MemoizedNL(engine.CanonicalizerService(eng, "ssb"))
    texts = _nl_texts(port_wl, 16)
    forms = [("nl", t) for t in texts]
    jres, jtenant, res, tenant = _replay_both(ssb_small, port_wl, forms, jnl, nl)
    # the canonicalizer's answers: identical NLResults, one model pass per batch
    assert list(nl._memo) == list(jnl._memo) and nl.calls == jnl.calls == 16
    for key, jr in jnl._memo.items():
        r = nl._memo[key]
        assert (r.raw_json, r.confidence, r.error) == (jr.raw_json, jr.confidence, jr.error)
        assert (r.signature is None) == (r.error is not None)  # the protocol
    _assert_same_results(forms, jres, jtenant, res, tenant)
    assert {r.status for r in res} == {"bypass"} and tenant.stats.nl_gated == 16
    assert tenant.backend.executions == 0


def test_simulated_llm_mixed_stream_matches_jax(ssb_small, port_wl):
    forms = [(q.kind, q.text) for q in port_wl.queries()]
    assert forms == [(q.kind, q.text) for q in ssb_small.queries()]
    forms += [("sql", q.text) for q in jhier.build_stream(20)]
    jnl = JMemoizedNL(JSimulatedLLM(ssb_small.vocab))
    nl = MemoizedNL(SimulatedLLM(port_wl.vocab))
    jres, jtenant, res, tenant = _replay_both(ssb_small, port_wl, forms, jnl, nl)
    _assert_same_results(forms, jres, jtenant, res, tenant)
    statuses = {r.status for r in res if r.origin == "nl"}
    assert {"bypass"} < statuses and any(s.startswith("hit") for s in statuses)
    assert any(p.startswith("execute:bypass_sig") for r in res for p in r.provenance)
    assert tenant.stats.nl_gated > 0


def test_serve_main_with_simulated_llm_on_cpu(capsys):
    serve.main(["--n-fact", "3000", "--queries", "62", "--device", "cpu",
                "--simulated-llm"])
    out = capsys.readouterr().out
    assert '"requests": 262' in out and '"nl_requests": 20' in out


def test_engine_caches_are_preallocated_and_written_in_place():
    """The engine's KV state: prefill preallocates (L, B, Hkv, max_len, Dh)
    caches and a (B,) int32 pos; each decode step writes its K/V at pos in
    place and returns pos + 1."""
    cfg = dataclasses.replace(reduced("canonicalizer-100m"), dtype=torch.float32)
    mod = cfg.build()
    params = mod.init_params(cfg, 0, device="cpu")
    tokens = torch.randint(0, cfg.vocab, (3, 5), generator=torch.Generator().manual_seed(0))
    with torch.inference_mode():
        _, caches, pos = mod.prefill(cfg, params, tokens=tokens, cache_len=16)
        k, v = caches["layers"]
        assert k.shape == v.shape == (cfg.n_layers, 3, cfg.kv_heads, 16, cfg.hd)
        assert pos.dtype == torch.int32 and pos.tolist() == [5, 5, 5]
        assert k[:, :, :, :5].abs().sum() > 0 and not k[:, :, :, 5:].any()
        _, again, pos = mod.decode_step(cfg, params, tokens[:, -1], caches, pos)
    assert again["layers"][0] is k and again["layers"][1] is v
    assert pos.tolist() == [6, 6, 6]
    assert k[:, :, :, 5].abs().sum() > 0 and not k[:, :, :, 6:].any()
    assert v[:, :, :, 5].abs().sum() > 0 and not v[:, :, :, 6:].any()


def test_engine_and_launcher_default_to_cuda(monkeypatch, port_wl):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = reduced("canonicalizer-100m")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        engine.ServingEngine(cfg, {}, build_tokenizer([port_wl]))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve.main(["--n-fact", "2000", "--simulated-llm"])
