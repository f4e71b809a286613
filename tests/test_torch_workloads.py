"""The port's workload generators against the JAX package's, on the CPU.

* ``workloads.{ssb,nyc_tlc,tpcds}.build`` at 5,000 fact rows: the same
  schema, the same ``Dataset`` column for column (dtype, data, vocab), the
  same intents, NL vocabulary, ``spatial_ambiguous`` and query streams;
* ``workloads.adversarial`` (the 63 queries of Table 2) and
  ``workloads.birdlike`` (150): the same queries and gold signatures, the
  same ``score`` under each package's ``SimulatedLLM``, and Table 2's
  counts (``tests/test_middleware_safety.py``) in the port;
* the TPC-DS and NYC TLC SQL streams, and the adversarial and BIRD-like NL
  queries (``MemoizedNL(SimulatedLLM)`` behind the balanced safety
  policy), through a JAX and a port ``CacheService``: the same statuses,
  provenance and gate counts, tables equal (``ResultTable.equals``, rtol
  1e-4) and equal to the numpy oracle;
* ``python -m repro_torch.launch.serve --workload {nyc_tlc,tpcds}
  --capacity``: the launcher's flags.
"""
import collections
import dataclasses
import json

import numpy as np
import pytest

from repro.core import MemoizedNL as JMemoizedNL
from repro.core import SafetyPolicy as JSafetyPolicy
from repro.core import SemanticCache as JSemanticCache
from repro.core import SimulatedLLM as JSimulatedLLM
from repro.olap.executor import OlapExecutor as JOlapExecutor
from repro.service import CacheService as JCacheService
from repro.service import QueryRequest as JQueryRequest
from repro.workloads import adversarial as jadversarial
from repro.workloads import birdlike as jbirdlike
from repro.workloads import nyc_tlc as jnyc_tlc
from repro.workloads import ssb as jssb
from repro.workloads import tpcds as jtpcds
from repro_torch.core import MemoizedNL, SafetyPolicy, SemanticCache, SimulatedLLM
from repro_torch.launch import serve
from repro_torch.olap.executor import OlapExecutor
from repro_torch.service import CacheService, QueryRequest
from repro_torch.workloads import adversarial, birdlike, nyc_tlc, ssb, tpcds

N_FACT = 5000
MODULES = {"ssb": (ssb, jssb, 0), "nyc_tlc": (nyc_tlc, jnyc_tlc, 1),
           "tpcds": (tpcds, jtpcds, 2)}
BATCH = 8


@pytest.fixture(scope="module")
def built():
    """(port workload, JAX workload) by name, 5,000 rows, each module's seed."""
    return {name: (mod.build(n_fact=N_FACT, seed=seed), jmod.build(n_fact=N_FACT, seed=seed))
            for name, (mod, jmod, seed) in MODULES.items()}


def _table_equal(t, jt):
    assert t.name == jt.name and list(t.columns) == list(jt.columns)
    for name, col in t.columns.items():
        jcol = jt.columns[name]
        assert col.dtype == jcol.dtype, (t.name, name)
        assert col.data.dtype == jcol.data.dtype and np.array_equal(col.data, jcol.data), \
            (t.name, name)
        assert (col.vocab is None) == (jcol.vocab is None), (t.name, name)
        if col.vocab is not None:
            assert np.array_equal(col.vocab, jcol.vocab), (t.name, name)


@pytest.mark.parametrize("name", sorted(MODULES))
def test_generator_matches_the_reference(built, name):
    wl, jwl = built[name]
    assert wl.name == jwl.name == name
    assert dataclasses.asdict(wl.schema) == dataclasses.asdict(jwl.schema)
    _table_equal(wl.dataset.fact, jwl.dataset.fact)
    assert list(wl.dataset.dims) == list(jwl.dataset.dims)
    for dim in wl.dataset.dims:
        _table_equal(wl.dataset.dims[dim], jwl.dataset.dims[dim])
    assert (wl.dataset.snapshot_id, wl.dataset.version) == \
        (jwl.dataset.snapshot_id, jwl.dataset.version)
    assert [dataclasses.asdict(i) for i in wl.intents] == \
        [dataclasses.asdict(i) for i in jwl.intents]
    assert dataclasses.asdict(wl.vocab) == dataclasses.asdict(jwl.vocab)
    assert wl.spatial_ambiguous == jwl.spatial_ambiguous
    assert wl.dataset.validate_hierarchies() == jwl.dataset.validate_hierarchies()
    for order in ("sequential", "interleaved", "zipf"):
        assert [dataclasses.asdict(q) for q in wl.queries(order=order)] == \
            [dataclasses.asdict(q) for q in jwl.queries(order=order)], order


def _same_queries(qs, jqs):
    assert len(qs) == len(jqs)
    for q, jq in zip(qs, jqs):
        assert (q.text, q.ambiguity, q.schema) == (jq.text, jq.ambiguity, jq.schema)
        assert (q.gold is None) == (jq.gold is None)
        if jq.gold is not None:
            assert q.gold.key() == jq.gold.key()


def _verdicts(score) -> list:
    return [(q.text, v) for q, _, v in score["rows"]]


@pytest.mark.parametrize("model", ["gpt-4o-mini", "claude-3.5-haiku"])
def test_adversarial_table2_holds_in_the_port(built, model):
    """The 63 adversarial queries and their scores equal the reference's,
    and the port reproduces Table 2's counts."""
    qs, jqs = adversarial.build(), jadversarial.build()
    _same_queries(qs, jqs)
    llms = {n: SimulatedLLM(built[n][0].vocab, model=model) for n in MODULES}
    jllms = {n: JSimulatedLLM(built[n][1].vocab, model=model) for n in MODULES}
    sc = adversarial.score(qs, [llms[q.schema].canonicalize(q.text, now=None) for q in qs])
    jsc = jadversarial.score(jqs, [jllms[q.schema].canonicalize(q.text, now=None)
                                   for q in jqs])
    assert sc["per_type"] == jsc["per_type"] and _verdicts(sc) == _verdicts(jsc)
    tot = collections.Counter()
    for bucket in sc["per_type"].values():
        tot.update(bucket)
    want = {"gpt-4o-mini": (28, 30, 5), "claude-3.5-haiku": (38, 25, 0)}[model]
    assert (tot["correct"], tot["wrong"], tot["invalid"]) == want


def test_birdlike_matches_the_reference(built):
    qs, jqs = birdlike.build(150), jbirdlike.build(150)
    _same_queries(qs, jqs)
    assert len(qs) == 150 and {q.schema for q in qs} == set(MODULES)
    llms = {n: SimulatedLLM(built[n][0].vocab) for n in MODULES}
    jllms = {n: JSimulatedLLM(built[n][1].vocab) for n in MODULES}
    sc = adversarial.score(qs, [llms[q.schema].canonicalize(q.text, now=None) for q in qs])
    jsc = jadversarial.score(jqs, [jllms[q.schema].canonicalize(q.text, now=None)
                                   for q in jqs])
    assert sc["per_type"] == jsc["per_type"] and _verdicts(sc) == _verdicts(jsc)


class Tenants:
    """A JAX and a port ``CacheService`` with one tenant per workload
    (named as the workload), NL through ``MemoizedNL(SimulatedLLM)`` behind
    the balanced safety policy."""

    def __init__(self, built, names):
        self.jsvc, self.svc = JCacheService(), CacheService()
        self.tenants, self.oracles = {}, {}
        for name in names:
            wl, jwl = built[name]
            self.jsvc.register_tenant(
                name, schema=jwl.schema, backend=JOlapExecutor(jwl.dataset),
                cache=JSemanticCache(jwl.schema, level_mapper=jwl.dataset.level_mapper()),
                nl=JMemoizedNL(JSimulatedLLM(jwl.vocab)),
                policy=JSafetyPolicy.balanced(jwl.spatial_ambiguous))
            self.tenants[name] = self.svc.register_tenant(
                name, schema=wl.schema, backend=OlapExecutor(wl.dataset, device="cpu"),
                cache=SemanticCache(wl.schema, level_mapper=wl.dataset.level_mapper()),
                nl=MemoizedNL(SimulatedLLM(wl.vocab)),
                policy=SafetyPolicy.balanced(wl.spatial_ambiguous))
            self.oracles[name] = OlapExecutor(wl.dataset, impl="numpy")

    def submit(self, forms):
        """``forms``: (tenant, kind, text); batches of 8 per tenant run."""
        jres, res = [], []
        for i in range(0, len(forms), BATCH):
            chunk = forms[i:i + BATCH]
            jres += self.jsvc.submit_batch([JQueryRequest(tenant=t, **{k: x})
                                            for t, k, x in chunk])
            res += self.svc.submit_batch([QueryRequest(tenant=t, **{k: x})
                                          for t, k, x in chunk])
        return jres, res

    def check(self, forms, jres, res) -> int:
        assert [r.status for r in res] == [r.status for r in jres]
        served = 0
        for (tenant, _, _), r, jr in zip(forms, res, jres):
            assert r.provenance == jr.provenance and r.bypass_reason == jr.bypass_reason
            assert (r.signature is None) == (jr.signature is None)
            if jr.signature is not None:
                assert r.signature.key() == jr.signature.key()
            assert r.error is None and (r.table is None) == (jr.table is None)
            if r.table is not None:
                assert r.table.equals(jr.table)
                truth = self.oracles[tenant].execute(r.signature)
                assert r.table.equals(truth, ordered=bool(r.signature.order_by))
                served += 1
        for name, t in self.tenants.items():
            jt = self.jsvc.tenant(name)
            assert t.stats.failures == t.stats.degraded == 0
            assert (t.stats.nl_gated, t.stats.bypasses) == (jt.stats.nl_gated, jt.stats.bypasses)
            assert dataclasses.asdict(t.cache.stats) == dataclasses.asdict(jt.cache.stats)
            assert t.backend.rows_scanned == jt.backend.rows_scanned
        return served


@pytest.mark.parametrize("name", ["nyc_tlc", "tpcds"])
def test_sql_stream_matches_jax_service(built, name):
    wl, _ = built[name]
    tenants = Tenants(built, [name])
    streams = serve.sql_streams(wl)
    assert list(streams) == [f"{name}_sql"]  # the drill stream is SSB's alone
    forms = [(name, "sql", q) for q in streams[f"{name}_sql"]]
    assert len(forms) == 21 * len(wl.intents)
    jres, res = tenants.submit(forms)
    assert tenants.check(forms, jres, res) == len(forms)
    assert {"miss", "hit_exact"} <= {r.status for r in res}


@pytest.mark.parametrize("queries", ["adversarial", "birdlike"])
def test_nl_safety_sets_match_jax_service(built, queries):
    """The adversarial and BIRD-like NL queries through one tenant per
    schema: the same statuses and gate counts, no served table off the
    oracle (no false hit)."""
    qs = adversarial.build() if queries == "adversarial" else birdlike.build(150)
    tenants = Tenants(built, sorted(MODULES))
    forms = [(q.schema, "nl", q.text) for q in qs]
    jres, res = tenants.submit(forms + forms)  # the second pass hits the memo
    served = tenants.check(forms + forms, jres, res)
    assert served > 0 and any(r.hit for r in res)
    assert sum(t.stats.nl_gated for t in tenants.tenants.values()) > 0


@pytest.mark.parametrize("name", ["nyc_tlc", "tpcds"])
def test_serve_main_takes_the_workload_and_capacity(capsys, name):
    serve.main(["--workload", name, "--n-fact", "3000", "--queries", "63", "--device",
                "cpu", "--simulated-llm", "--capacity", "16"])
    out = capsys.readouterr().out.strip().splitlines()
    assert out[0] == f"[serve] {name}_mixed: 63 requests replayed" and len(out) == 2
    summary = json.loads(out[-1])
    assert summary["requests"] == 63 and summary["failures"] == summary["degraded"] == 0
    assert summary["misses"] > 0 and summary["rows_scanned"] > 0
