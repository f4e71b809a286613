"""The port's delta partition and incremental refresh against the JAX
package's, on the CPU (plain PyTorch path).

* ``OlapExecutor.execute_batch(sigs, partition=(start, end))`` on
  ``ssb_small``/``tlc_small``/``tpcds_small``: every intent's table over
  the row slice equal to the JAX executor's on the same slice and to the
  numpy oracle over ``Dataset.slice_rows``, with the same counters;
* the sub-executor of a delta scan: on the parent's device (here the CPU,
  where a sub on the default CUDA device would raise), sharing the parent
  mirror's dimension uploads, and a numpy parent's sub the numpy oracle;
* ``CacheService.advance_snapshot(delta=...)`` over three ticks of SSB
  deltas (``benchmarks/bench_refresh.py::make_delta``), on an unpartitioned
  and on a partitioned backend, with and without recompute fallbacks and
  with ``refresh=False``: the same ``RefreshReport`` per tick, then the
  same statuses and tables, each equal to the oracle over the appended
  dataset (``ResultTable.equals``, rtol 1e-4).
"""
import dataclasses

import numpy as np
import pytest

from benchmarks.bench_refresh import make_delta
from repro.core import SemanticCache as JSemanticCache
from repro.core.sql_canon import SQLCanonicalizer as JSQLCanonicalizer
from repro.olap.executor import OlapExecutor as JOlapExecutor
from repro.service import CacheService as JCacheService
from repro.service import QueryRequest as JQueryRequest
from repro.workloads import ssb as jssb
from repro_torch.core import SemanticCache
from repro_torch.core.sql_canon import SQLCanonicalizer
from repro_torch.olap.columnar import from_reference
from repro_torch.olap.executor import OlapExecutor
from repro_torch.service import CacheService, QueryRequest
from repro_torch.workloads import ssb

COUNTERS = ("executions", "rows_scanned", "batch_calls", "batch_groups")
N_FACT = 6000


@pytest.mark.parametrize("rows", [(0, 1000), (1500, 4000), (3999, 4000)])
@pytest.mark.parametrize("fixture", ["ssb_small", "tlc_small", "tpcds_small"])
def test_partition_scan_matches_jax_on_the_same_slice(fixture, rows, request):
    wl = request.getfixturevalue(fixture)
    ds = from_reference(wl.dataset)
    canon, jcanon = SQLCanonicalizer(ds.schema), JSQLCanonicalizer(wl.schema)
    sigs = [canon.canonicalize(i.sql) for i in wl.intents]
    jsigs = [jcanon.canonicalize(i.sql) for i in wl.intents]
    ex, jex = OlapExecutor(ds, device="cpu"), JOlapExecutor(wl.dataset, impl="xla")
    oracle = OlapExecutor(ds.slice_rows(*rows), impl="numpy")
    got, want = ex.execute_batch(sigs, partition=rows), jex.execute_batch(jsigs, partition=rows)
    for sig, g, w in zip(sigs, got, want):
        ordered = bool(sig.order_by)
        assert g.equals(w, ordered=ordered), sig.canonical_json()
        assert g.equals(oracle.execute(sig), ordered=ordered), sig.canonical_json()
    for name in COUNTERS:
        assert getattr(ex, name) == getattr(jex, name), name
    assert ex.rows_scanned % (rows[1] - rows[0]) == 0 < ex.rows_scanned


def test_delta_sub_executor_stays_on_the_parents_device(ssb_small):
    """The sub-executor of a delta scan takes the parent's device (not the
    default CUDA one, which raises here) and shares its dimension uploads;
    a numpy parent's sub is the numpy oracle and touches no device."""
    ds = from_reference(ssb_small.dataset)
    sig = SQLCanonicalizer(ds.schema).canonicalize(
        "SELECT c_nation, SUM(lo_revenue) AS r FROM lineorder "
        "JOIN customer ON lineorder.lo_custkey = customer.c_key "
        "WHERE c_region = 'ASIA' GROUP BY c_nation")
    ex = OlapExecutor(ds, device="cpu")
    ex.execute(sig)  # the parent mirror now holds the region column
    sub = ex._partition_executor(100, 900)
    assert sub.device == ex.device and sub.device.type == "cpu"
    assert sub.dev._dim_store is ex.dev._dim_store
    assert ("dimcol", "customer", "c_region") in sub.dev._dim_store
    assert sub.ds.fact.num_rows == 800 and sub.partitions == 1
    assert ex.execute_batch([sig], partition=(100, 900))[0].equals(
        OlapExecutor(ds.slice_rows(100, 900), impl="numpy").execute(sig))
    np_ex = OlapExecutor(ds, impl="numpy")
    np_sub = np_ex._partition_executor(0, 10)
    assert np_sub.impl == "numpy" and np_sub.device is None and not np_sub.fused
    chunked = OlapExecutor(ds, partitions=2, max_device_rows=700, device="cpu")
    chunked.execute(sig)
    assert chunked._chunk_sub((0, 512), None, resident=False).device == ex.device


DASHBOARD = [
    "SELECT c_region, SUM(lo_revenue) AS r, COUNT(*) AS n FROM lineorder "
    "JOIN customer ON lineorder.lo_custkey = customer.c_key GROUP BY c_region",
    "SELECT d_year, MIN(lo_supplycost) AS lo, MAX(lo_supplycost) AS hi FROM lineorder "
    "JOIN dates ON lineorder.lo_orderdate = dates.d_key GROUP BY d_year",
    "SELECT c_nation, SUM(lo_revenue) AS r FROM lineorder "
    "JOIN customer ON lineorder.lo_custkey = customer.c_key "
    "JOIN dates ON lineorder.lo_orderdate = dates.d_key WHERE d_year = 1998 "
    "GROUP BY c_nation",
    "SELECT c_region, SUM(lo_revenue) AS r FROM lineorder "
    "JOIN customer ON lineorder.lo_custkey = customer.c_key "
    "JOIN dates ON lineorder.lo_orderdate = dates.d_key WHERE d_year = 1993 "
    "GROUP BY c_region",
    # non-composable: AVG, ORDER BY + LIMIT
    "SELECT c_region, AVG(lo_quantity) AS q FROM lineorder "
    "JOIN customer ON lineorder.lo_custkey = customer.c_key GROUP BY c_region",
    "SELECT c_nation, SUM(lo_revenue) AS r FROM lineorder "
    "JOIN customer ON lineorder.lo_custkey = customer.c_key GROUP BY c_nation "
    "ORDER BY r DESC LIMIT 3",
]


@pytest.mark.parametrize("partitions", [1, 4])
@pytest.mark.parametrize("mode", ["refresh", "no_fallbacks", "drop"])
def test_advance_snapshot_with_delta_matches_jax(partitions, mode):
    jwl, wl = jssb.build(n_fact=N_FACT, seed=0), ssb.build(n_fact=N_FACT, seed=0)
    jsvc, svc = JCacheService(), CacheService()
    jbe = JOlapExecutor(jwl.dataset, impl="xla", partitions=partitions)
    be = OlapExecutor(wl.dataset, partitions=partitions, device="cpu")
    jsvc.register_tenant("t", schema=jwl.schema, backend=jbe,
                         cache=JSemanticCache(jwl.schema,
                                              level_mapper=jwl.dataset.level_mapper()))
    tenant = svc.register_tenant("t", schema=wl.schema, backend=be,
                                 cache=SemanticCache(wl.schema,
                                                     level_mapper=wl.dataset.level_mapper()))
    canon = SQLCanonicalizer(wl.schema)

    def replay():
        jres = jsvc.submit_batch([JQueryRequest(sql=q, tenant="t") for q in DASHBOARD])
        res = svc.submit_batch([QueryRequest(sql=q, tenant="t") for q in DASHBOARD])
        assert [r.status for r in res] == [r.status for r in jres]
        oracle = OlapExecutor(wl.dataset, impl="numpy")
        for q, r, jr in zip(DASHBOARD, res, jres):
            assert r.provenance == jr.provenance and r.table.equals(jr.table), q
            sig = canon.canonicalize(q)
            assert r.table.equals(oracle.execute(sig), ordered=bool(sig.order_by)), q
        return res

    assert {r.status for r in replay()} == {"miss"}
    kw = {"refresh": {}, "no_fallbacks": {"recompute_fallbacks": False},
          "drop": {"refresh": False}}[mode]
    rng = np.random.default_rng(3)
    for tick in range(3):
        delta = make_delta(jwl.dataset, 300 + 100 * tick, rng)
        jrep = jsvc.advance_snapshot("t", snapshot_id=f"snap{tick + 1}", delta=delta, **kw)
        rep = svc.advance_snapshot("t", snapshot_id=f"snap{tick + 1}", delta=delta, **kw)
        assert dataclasses.asdict(rep) == dataclasses.asdict(jrep), tick
        assert rep.appended_rows == 300 + 100 * tick
        if mode == "drop":
            assert rep.refreshed == rep.recomputed == 0 and rep.dropped > 0
        else:
            # the delta lands in 1998: the 1993 tile is unaffected
            assert rep.refreshed == 3 and rep.unaffected == 1
            assert rep.delta_rows_scanned > 0
            assert rep.recomputed == (2 if mode == "refresh" else 0)
        res = replay()
        assert res[3].status == "hit_exact"
        for name in COUNTERS:
            assert getattr(be, name) == getattr(jbe, name), (tick, name)
    assert wl.dataset.fact.num_rows == N_FACT + 300 + 400 + 500
    assert tenant.stats.failures == tenant.stats.degraded == 0
