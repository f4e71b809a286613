"""The port's ``CacheService`` against the JAX package's, on the CPU.

The same SSB workload (20,000 LINEORDER rows, seed 0; each package's own
generator, checked equal) backs a JAX tenant (``repro`` ``OlapExecutor``,
its default kernels) and a port tenant (``OlapExecutor(device="cpu")``,
the plain PyTorch path), one ``CacheService`` each:

* the SSB SQL stream, the hierarchical drill stream, the SSB mixed
  stream (NL through ``MemoizedNL(SimulatedLLM)`` behind the balanced
  safety policy) and the SSB SQL stream interleaved across intents, in
  batches of 8, at ``shards=1`` and ``shards=4``: per
  request status, provenance, bypass reason and signature, tables equal
  under ``ResultTable.equals`` (rtol 1e-4), ``TenantStats`` and
  ``CacheStats`` counters equal, and no served table differs from the
  numpy oracle (no false hit).  At ``shards=4`` the interleaved stream's
  batches mix measure families, and the port's misses run on two or more
  ``shard-miss`` threads at once;
* ``advance_snapshot`` without a delta and ``invalidate``: the same
  dropped counts, then the same statuses; ``advance_snapshot(delta=...)``
  on fresh datasets (the module's are shared): the same ``RefreshReport``,
  then the same statuses and tables, each equal to the oracle over the
  appended dataset; ``warm``;
* ``metrics()``: the same metric names and counter values; ``health()``
  and ``stats()`` the same keys, and the backend's ``stats()`` the same
  values but for the port's ``device`` (and the JAX executor's XLA
  ``rect_index`` memo, which the port does not have);
* one seeded ``backend.error`` plan, then a breaker that opens: the same
  statuses and error kinds, every served table equal to the oracle, and
  nothing left armed;
* a warm restart through the durable store (``open`` -> stream ->
  ``close`` -> a new service ``open``s the same path -> the stream again),
  and ``save_cache``/``load_cache``.
"""
import dataclasses
import threading

import numpy as np
import pytest

from repro.core import MemoizedNL as JMemoizedNL
from repro.core import SafetyPolicy as JSafetyPolicy
from repro.core import SemanticCache as JSemanticCache
from repro.core import SimulatedLLM as JSimulatedLLM
from repro.core.cache import load_cache as jload_cache
from repro.olap.executor import OlapExecutor as JOlapExecutor
from repro.resilience import ResiliencePolicy as JResiliencePolicy
from repro.resilience import faults as jfaults
from repro.service import CacheService as JCacheService
from repro.service import QueryRequest as JQueryRequest
from repro.workloads import ssb as jssb
from benchmarks.bench_refresh import make_delta
from repro_torch.core import MemoizedNL, SafetyPolicy, SemanticCache, SimulatedLLM
from repro_torch.core.cache import load_cache, save_cache
from repro_torch.launch import serve
from repro_torch.olap.executor import OlapExecutor
from repro_torch.resilience import ResiliencePolicy, faults
from repro_torch.service import CacheService, QueryRequest
from repro_torch.workloads import ssb

N_FACT = 20_000
BATCH = 8
COUNTERS = ("executions", "rows_scanned", "batch_calls", "batch_groups")


@pytest.fixture(autouse=True)
def _clear_port_faults():
    """No port fault plan leaks across tests (the conftest clears the JAX
    package's)."""
    yield
    faults.clear()


@pytest.fixture(scope="module")
def wls():
    jwl, wl = jssb.build(n_fact=N_FACT, seed=0), ssb.build(n_fact=N_FACT, seed=0)
    for t in (jwl.dataset.fact, *jwl.dataset.dims.values()):
        port = wl.dataset.fact if t is jwl.dataset.fact else wl.dataset.dims[t.name]
        for name, col in t.columns.items():
            assert np.array_equal(col.data, port.columns[name].data), (t.name, name)
    return jwl, wl


@pytest.fixture(scope="module")
def streams(wls):
    _, wl = wls
    return {"ssb_sql": [("sql", q) for q in serve.sql_streams(wl)["ssb_sql"]],
            "drill": [("sql", q) for q in serve.sql_streams(wl)["drill"]],
            "ssb_mixed": [(q.kind, q.text) for q in wl.queries()],
            "ssb_interleaved": [("sql", q) for q in
                                serve.sql_streams(wl, order="interleaved")["ssb_sql"]]}


class Oracle:
    """The numpy executor over the port's dataset, memoized by key."""

    def __init__(self, wl):
        self.executor = OlapExecutor(wl.dataset, impl="numpy")
        self.truth: dict = {}

    def check(self, results) -> int:
        checked = 0
        for r in results:
            if r.table is None:
                continue
            key = r.signature.key()
            if key not in self.truth:
                self.truth[key] = self.executor.execute(r.signature)
            assert r.table.equals(self.truth[key], ordered=bool(r.signature.order_by)), \
                (r.status, r.provenance)
            checked += 1
        return checked


@pytest.fixture(scope="module")
def oracle(wls):
    return Oracle(wls[1])


class Pair:
    """A JAX service and a port service, tenant ``ssb`` each, over the same
    data; ``submit`` sends the same requests to both in batches of 8."""

    def __init__(self, wls, shards=None, nl=False, resilience=None):
        jwl, wl = wls
        self.jsvc, self.svc = JCacheService(), CacheService()
        self.jtenant = self.jsvc.register_tenant(
            "ssb", schema=jwl.schema, backend=JOlapExecutor(jwl.dataset),
            cache=JSemanticCache(jwl.schema, level_mapper=jwl.dataset.level_mapper()),
            nl=JMemoizedNL(JSimulatedLLM(jwl.vocab)) if nl else None,
            policy=JSafetyPolicy.balanced(jwl.spatial_ambiguous), shards=shards,
            resilience=None if resilience is None else JResiliencePolicy(**resilience))
        self.tenant = self.svc.register_tenant(
            "ssb", schema=wl.schema, backend=OlapExecutor(wl.dataset, device="cpu"),
            cache=SemanticCache(wl.schema, level_mapper=wl.dataset.level_mapper()),
            nl=MemoizedNL(SimulatedLLM(wl.vocab)) if nl else None,
            policy=SafetyPolicy.balanced(wl.spatial_ambiguous), shards=shards,
            resilience=None if resilience is None else ResiliencePolicy(**resilience))

    def submit(self, forms):
        jres, res = [], []
        for i in range(0, len(forms), BATCH):
            chunk = forms[i:i + BATCH]
            jres += self.jsvc.submit_batch([JQueryRequest(tenant="ssb", **{k: t})
                                            for k, t in chunk])
            res += self.svc.submit_batch([QueryRequest(tenant="ssb", **{k: t})
                                          for k, t in chunk])
        return jres, res


def _assert_same_results(jres, res):
    assert [r.status for r in res] == [r.status for r in jres]
    for i, (r, jr) in enumerate(zip(res, jres)):
        assert r.origin == jr.origin and r.provenance == jr.provenance, i
        assert r.bypass_reason == jr.bypass_reason, i
        assert (r.batched, r.deduped) == (jr.batched, jr.deduped), i
        assert (r.signature is None) == (jr.signature is None), i
        if jr.signature is not None:
            assert r.signature.key() == jr.signature.key(), i
        assert (r.error is None) == (jr.error is None), i
        if jr.error is not None:
            assert (r.error.stage, r.error.kind) == (jr.error.stage, jr.error.kind), i
        if jr.table is None:
            assert r.table is None, i
        else:
            assert r.table.equals(jr.table), i


def _counters(stats) -> dict:
    d = stats.to_dict()
    d.pop("stages_ms")
    return d


def _assert_same_state(pair):
    j, p = pair.jtenant, pair.tenant
    assert dataclasses.asdict(p.cache.stats) == dataclasses.asdict(j.cache.stats)
    assert _counters(p.stats) == _counters(j.stats)
    for name in COUNTERS:
        assert getattr(p.backend, name) == getattr(j.backend, name), name


class ShardThreads:
    """Names of the threads that ran the port backend's ``execute_batch``."""

    def __init__(self, backend):
        self.names: list[str] = []
        self._lock = threading.Lock()
        real = backend.execute_batch

        def recording(sigs):
            with self._lock:
                self.names.append(threading.current_thread().name)
            return real(sigs)

        backend.execute_batch = recording


@pytest.mark.parametrize("shards", [1, 4])
@pytest.mark.parametrize("stream", ["ssb_sql", "drill", "ssb_mixed", "ssb_interleaved"])
def test_service_matches_jax(wls, streams, oracle, stream, shards):
    pair = Pair(wls, shards=shards, nl=stream == "ssb_mixed")
    threads = ShardThreads(pair.tenant.backend)
    forms = streams[stream]
    jres, res = pair.submit(forms)
    _assert_same_results(jres, res)
    _assert_same_state(pair)
    statuses = {r.status for r in res}
    assert {"miss", "hit_exact"} <= statuses <= {
        "miss", "hit_exact", "hit_rollup", "hit_filterdown", "hit_compose", "bypass"}
    assert pair.tenant.stats.failures == pair.tenant.stats.degraded == 0
    assert oracle.check(res) == sum(r.table is not None for r in res) > 0
    if stream == "ssb_mixed":
        assert any(r.hit for r in res if r.origin == "nl")
        assert pair.tenant.stats.nl_gated == pair.jtenant.stats.nl_gated > 0
    shard_threads = {n for n in threads.names if n.startswith("shard-miss")}
    if shards == 1:
        assert not shard_threads
    elif stream == "ssb_interleaved":
        assert len(shard_threads) >= 2


@pytest.mark.parametrize("shards", [1, 4])
def test_lifecycle_matches_jax(wls, streams, oracle, shards):
    pair = Pair(wls, shards=shards)
    forms = streams["ssb_sql"][:120]
    pair.submit(forms)
    for kw in ({"snapshot_id": "snap1", "updated_start": "1997-01-01",
                "updated_end": "1998-12-31"},
               {"snapshot_id": "snap2"}):
        jrep = pair.jsvc.advance_snapshot("ssb", **kw)
        rep = pair.svc.advance_snapshot("ssb", **kw)
        assert dataclasses.asdict(rep) == dataclasses.asdict(jrep)
        assert rep.dropped > 0
        jres, res = pair.submit(forms)
        _assert_same_results(jres, res)
        assert any(f"snapshot:{kw['snapshot_id']}" in r.provenance for r in res)
        oracle.check(res)
    assert pair.svc.invalidate("ssb", updated_start="1995-01-01", updated_end="1995-12-31") \
        == pair.jsvc.invalidate("ssb", updated_start="1995-01-01", updated_end="1995-12-31")
    n = pair.svc.invalidate("ssb", schema_change=True)
    assert n == pair.jsvc.invalidate("ssb", schema_change=True) > 0
    assert len(pair.tenant.cache) == len(pair.jtenant.cache) == 0
    _assert_same_state(pair)

    # a delta grows the fact table: fresh datasets, not the module's
    jfresh, fresh_wl = jssb.build(n_fact=N_FACT, seed=0), ssb.build(n_fact=N_FACT, seed=0)
    fresh = Pair((jfresh, fresh_wl), shards=shards)
    fresh.submit(forms)
    delta = make_delta(jfresh.dataset, 500, np.random.default_rng(11))
    jrep = fresh.jsvc.advance_snapshot("ssb", "snap3", delta=delta)
    rep = fresh.svc.advance_snapshot("ssb", "snap3", delta=delta)
    assert dataclasses.asdict(rep) == dataclasses.asdict(jrep)
    assert rep.appended_rows == 500 and rep.refreshed > 0 and rep.delta_rows_scanned > 0
    assert fresh_wl.dataset.fact.num_rows == N_FACT + 500
    jres, res = fresh.submit(forms)
    _assert_same_results(jres, res)
    assert any("snapshot:snap3" in r.provenance for r in res if r.hit)
    assert Oracle(fresh_wl).check(res) == sum(r.table is not None for r in res) > 0
    _assert_same_state(fresh)


def test_warm_matches_jax(wls, streams):
    pair = Pair(wls, shards=4)
    forms = streams["ssb_sql"][:40]
    jwarm = pair.jsvc.warm([JQueryRequest(tenant="ssb", sql=t) for _, t in forms])
    warm = pair.svc.warm([QueryRequest(tenant="ssb", sql=t) for _, t in forms])
    _assert_same_results(jwarm, warm)
    jres, res = pair.submit(forms)
    _assert_same_results(jres, res)
    assert all(r.hit for r in res)
    with pytest.raises(ValueError, match="read_only"):
        pair.svc.warm([QueryRequest(tenant="ssb", sql=forms[0][1], read_only=True)])
    _assert_same_state(pair)


def _metrics(svc) -> dict:
    return {m["name"]: m for m in svc.metrics(fmt="json")["metrics"]}


def _keys(d) -> object:
    return {k: _keys(v) for k, v in d.items()} if isinstance(d, dict) else None


def test_metrics_health_and_stats_match_jax(wls, streams):
    pair = Pair(wls, shards=4, nl=True)
    pair.submit(streams["ssb_mixed"][:96])
    jm, m = _metrics(pair.jsvc), _metrics(pair.svc)
    assert set(m) == set(jm) and all(name.startswith("repro_") for name in m)
    for name, inst in m.items():
        assert inst["type"] == jm[name]["type"], name
        if inst["type"] == "counter" or name.startswith("repro_cache_"):
            assert inst["samples"] == jm[name]["samples"], name
    text = pair.svc.metrics()
    assert "repro_service_requests_total" in text and "repro_stage_latency_ms" in text

    health, jhealth = pair.svc.health(), pair.jsvc.health()
    assert health == jhealth and health["ssb"]["status"] == "ok"
    stats, jstats = pair.svc.stats("ssb"), pair.jsvc.stats("ssb")
    backend, jbackend = stats.pop("backend"), jstats.pop("backend")
    assert _keys(stats) == _keys(jstats)
    assert backend.pop("device") == "cpu" and set(backend) == set(jbackend)
    jbackend["memo_sizes"].pop("rect_index")  # the XLA gather layout, not ported
    assert backend == jbackend
    assert stats["cache"] == jstats["cache"]
    assert stats["cluster"]["by_shard"] == jstats["cluster"]["by_shard"]


RESILIENCE = {"execute_attempts": 2, "retry_base_s": 0.0005, "retry_max_s": 0.001,
              "breaker_failures": 3, "breaker_recovery_s": 600.0}


def test_faults_match_jax(wls, streams, oracle):
    pair = Pair(wls, resilience=RESILIENCE)
    forms = streams["ssb_sql"][:96]
    with jfaults.scoped("backend.error:0.4:11"), faults.scoped("backend.error:0.4:11") as plan:
        jres, res = pair.submit(forms)
        fired = plan.counts()["fired"]["backend.error"]
    _assert_same_results(jres, res)
    assert fired > 0 and pair.tenant.stats.retries == pair.jtenant.stats.retries > 0
    retried = [r for r in res if any(p.startswith("retry:") for p in r.provenance)]
    assert retried and all(r.status == "miss" for r in retried)
    assert oracle.check(res) == sum(r.table is not None for r in res)

    later = streams["drill"][:40]
    with jfaults.scoped("backend.error:1.0"), faults.scoped("backend.error:1.0"):
        jres, res = pair.submit(later)
    _assert_same_results(jres, res)
    kinds = [r.error.kind for r in res if r.error is not None]
    assert "breaker_open" in kinds and pair.tenant.resilience.backend.state == "open"
    assert pair.svc.health()["ssb"] == pair.jsvc.health()["ssb"]
    assert pair.svc.health()["ssb"]["status"] == "degraded"
    oracle.check(res)
    _assert_same_state(pair)
    assert not faults.active_plan().specs and not faults.should_fire("backend.error")


def test_durable_store_warm_restart_matches_jax(wls, streams, oracle, tmp_path):
    forms = streams["ssb_sql"][:64]
    first = Pair(wls, shards=4)
    assert first.svc.open(str(tmp_path / "port")) == first.jsvc.open(str(tmp_path / "jax")) \
        == {"ssb": 0}
    jres0, res0 = first.submit(forms)
    _assert_same_results(jres0, res0)
    closed = first.svc.close()
    assert closed == first.jsvc.close() and closed["ssb"] > 0

    again = Pair(wls, shards=4)
    adopted = again.svc.open(str(tmp_path / "port"))
    assert adopted == again.jsvc.open(str(tmp_path / "jax")) == closed
    jres, res = again.submit(forms)
    _assert_same_results(jres, res)
    assert all(r.hit for r in res)
    assert sum("tier:cold" in r.provenance for r in res) == closed["ssb"]
    for r, r0 in zip(res, res0):
        assert r.table.equals(r0.table)
    oracle.check(res)
    again.svc.close()
    again.jsvc.close()


def test_save_and_load_cache_round_trip(wls, streams, tmp_path):
    jwl, wl = wls
    pair = Pair(wls)
    pair.submit(streams["ssb_sql"][:48])
    cache = pair.tenant.cache
    n = save_cache(cache, str(tmp_path / "spill"))
    assert n == len(cache) > 0
    warm = SemanticCache(wl.schema, level_mapper=wl.dataset.level_mapper())
    assert load_cache(warm, str(tmp_path / "spill")) == n
    jwarm = JSemanticCache(jwl.schema, level_mapper=jwl.dataset.level_mapper())
    assert jload_cache(jwarm, str(tmp_path / "spill")) == n  # one format
    for key in cache.keys():
        e, w, jw = cache.entry(key), warm.entry(key), jwarm.entry(key)
        assert w.table.equals(e.table) and jw.table.equals(e.table)
        assert (w.lru_stamp, w.store_stamp) == (e.lru_stamp, e.store_stamp)
