"""The port's partition-parallel scan plane against the JAX package's, on
the CPU (plain PyTorch path).

* ``scan_plane.plan_scan``, ``partition_compatible`` and ``decompose`` and
  ``core.refresh.merge_partials``: the port's copies give the reference's
  plans, partial signatures and merged tables on the same inputs;
* ``OlapExecutor(partitions=2|4, max_device_rows=...)`` (streamed where the
  budget is below a partition) on ``ssb_small``/``tlc_small``/
  ``tpcds_small``: every intent's table equal to the port's unpartitioned
  executor and to the JAX executor at the same options
  (``ResultTable.equals``, rtol 1e-4), with the same ``stats()`` counters
  and per-partition accounting; the ``COUNT(DISTINCT)`` fallback; the
  resync after ``append_rows``; partitions pinned to two devices (the
  several-card branch, run here on two CPU "devices"); a staging error
  raised in the scanning thread; concurrent callers;
* the service tests of the reference's ``tests/test_scan_plane.py``
  (miss group through one partitioned scan, cluster leaders sharing it,
  the delta scan kept out of the plane), on JAX and port tenants side by
  side.
"""
import dataclasses
import sys
import threading

import numpy as np
import pytest
import torch

from benchmarks.bench_refresh import make_delta
from repro.core import Measure as JMeasure
from repro.core import SemanticCache as JSemanticCache
from repro.core import Signature as JSignature
from repro.core.refresh import merge_partials as jmerge_partials
from repro.core.sql_canon import SQLCanonicalizer as JSQLCanonicalizer
from repro.core.table import ResultTable as JResultTable
from repro.olap import scan_plane as jscan_plane
from repro.olap.executor import OlapExecutor as JOlapExecutor
from repro.service import CacheService as JCacheService
from repro.service import QueryRequest as JQueryRequest
from repro.workloads import ssb as jssb
from repro_torch.core import Measure, SemanticCache, Signature
from repro_torch.core.refresh import merge_partials
from repro_torch.core.sql_canon import SQLCanonicalizer
from repro_torch.core.table import ResultTable
from repro_torch.olap import scan_plane
from repro_torch.olap.columnar import from_reference
from repro_torch.olap.executor import OlapExecutor
from repro_torch.service import CacheService, QueryRequest
from repro_torch.workloads import ssb

COUNTERS = ("executions", "rows_scanned", "batch_calls", "batch_groups",
            "partitioned_scans", "partition_fallbacks", "streaming_chunks",
            "per_partition")
REGION = ("SELECT c_region, SUM(lo_revenue) AS r, COUNT(*) AS n FROM lineorder "
          "JOIN customer ON lineorder.lo_custkey = customer.c_key GROUP BY c_region")


def _same_stats(ex, jex):
    st, jst = ex.stats(), jex.stats()
    for name in COUNTERS:
        assert st[name] == jst[name], name


@pytest.mark.parametrize("n,p,mdr", [(10, 1, None), (10, 3, None), (4000, 4, None),
                                     (7, 16, None), (1, 1, None), (0, 2, None),
                                     (10_000, 2, 1000), (1000, 4, 250), (4000, 4, 512),
                                     (6_000_000, 4, 1 << 20)])
def test_plan_scan_matches_the_reference(n, p, mdr):
    plan, jplan = scan_plane.plan_scan(n, p, mdr), jscan_plane.plan_scan(n, p, mdr)
    assert (plan.n_rows, plan.chunks, plan.streaming) == \
        (jplan.n_rows, jplan.chunks, jplan.streaming)
    assert sum(e - s for part in plan.chunks for s, e in part) == max(n, 0)


@pytest.mark.parametrize("args", [(10, 0, None), (10, 2, 0)])
def test_plan_scan_rejects_what_the_reference_rejects(args):
    with pytest.raises(ValueError):
        jscan_plane.plan_scan(*args)
    with pytest.raises(ValueError):
        scan_plane.plan_scan(*args)


@pytest.mark.parametrize("fixture", ["ssb_small", "tlc_small", "tpcds_small"])
def test_decompose_matches_the_reference(fixture, request):
    wl = request.getfixturevalue(fixture)
    canon, jcanon = SQLCanonicalizer(from_reference(wl.dataset).schema), \
        JSQLCanonicalizer(wl.schema)
    sigs = [(canon.canonicalize(i.sql), jcanon.canonicalize(i.sql)) for i in wl.intents]
    sigs.append((Signature(wl.schema.name, (Measure("COUNT", "x", distinct=True),)),
                 JSignature(wl.schema.name, (JMeasure("COUNT", "x", distinct=True),))))
    for sig, jsig in sigs:
        ok = scan_plane.partition_compatible(sig)
        assert ok == jscan_plane.partition_compatible(jsig)
        if not ok:
            with pytest.raises(ValueError):
                scan_plane.decompose(sig)
            continue
        plan, jplan = scan_plane.decompose(sig), jscan_plane.decompose(jsig)
        assert plan.partial_sig.key() == jplan.partial_sig.key()
        assert plan.finalize == jplan.finalize


@pytest.mark.parametrize("seed", range(6))
def test_merge_partials_matches_the_reference(seed):
    """Random partial tables over region keys, NaN and empty partials
    included, merged by both packages' ``merge_partials`` and finalized."""
    rng = np.random.default_rng(seed)
    keys = np.asarray(["AFRICA", "AMERICA", "ASIA", "EUROPE", "MIDDLE EAST"])
    aggs = [("SUM", "lineorder.lo_revenue"), ("COUNT", "*"),
            ("MIN", "lineorder.lo_revenue"), ("MAX", "lineorder.lo_revenue")]
    sig = Signature("ssb", tuple(Measure(a, e) for a, e in aggs), levels=("customer.c_region",))
    jsig = JSignature("ssb", tuple(JMeasure(a, e) for a, e in aggs),
                      levels=("customer.c_region",))
    parts, jparts = [], []
    for _ in range(int(rng.integers(2, 6))):
        k = keys[rng.integers(0, 5, size=int(rng.integers(0, 5)))]
        k = np.unique(k)
        vals = rng.normal(0, 100, size=len(k))
        vals[rng.random(len(k)) < 0.2] = np.nan
        cols = {"customer.c_region": k, "m0": np.nan_to_num(vals), "m1": np.ones(len(k)),
                "m2": vals, "m3": vals}
        parts.append(ResultTable(dict(cols)))
        jparts.append(JResultTable(dict(cols)))
    got, want = merge_partials(sig, parts), jmerge_partials(jsig, jparts)
    assert list(got.columns) == list(want.columns)
    assert got.equals(want, ordered=True)
    # AVG finalized from merged SUM / COUNT(*) partials
    full = Signature("ssb", (Measure("AVG", "lineorder.lo_revenue"),), levels=sig.levels)
    jfull = JSignature("ssb", (JMeasure("AVG", "lineorder.lo_revenue"),), levels=sig.levels)
    sums = [ResultTable({n: t.columns[n] for n in ("customer.c_region", "m0", "m1")})
            for t in parts]
    jsums = [JResultTable(dict(t.columns)) for t in sums]
    got = scan_plane.merge_and_finalize(full, scan_plane.decompose(full), sums)
    want = jscan_plane.merge_and_finalize(jfull, jscan_plane.decompose(jfull), jsums)
    assert got.equals(want, ordered=True)


OPTIONS = [(2, 700), (4, None), (4, 512)]


@pytest.mark.parametrize("partitions,mdr", OPTIONS)
@pytest.mark.parametrize("fixture", ["ssb_small", "tlc_small", "tpcds_small"])
def test_every_intent_matches_unpartitioned_and_jax(fixture, partitions, mdr, request):
    """Each intent alone, then all in one batch: tables equal to the port's
    unpartitioned executor and to the JAX executor at the same options,
    counters and per-partition accounting equal to the JAX executor's."""
    wl = request.getfixturevalue(fixture)
    ds = from_reference(wl.dataset)
    canon, jcanon = SQLCanonicalizer(ds.schema), JSQLCanonicalizer(wl.schema)
    ex1 = OlapExecutor(ds, device="cpu")
    ex = OlapExecutor(ds, partitions=partitions, max_device_rows=mdr, device="cpu")
    jex = JOlapExecutor(wl.dataset, impl="xla", partitions=partitions, max_device_rows=mdr)
    sigs = [canon.canonicalize(i.sql) for i in wl.intents]
    jsigs = [jcanon.canonicalize(i.sql) for i in wl.intents]
    for intent, sig, jsig in zip(wl.intents, sigs, jsigs):
        got, ordered = ex.execute(sig), bool(sig.order_by)
        assert got.equals(ex1.execute(sig), ordered=ordered), intent.id
        assert got.equals(jex.execute(jsig), ordered=ordered), intent.id
    for sig, got, want in zip(sigs, ex.execute_batch(sigs), jex.execute_batch(jsigs)):
        assert got.equals(want, ordered=bool(sig.order_by)), sig.canonical_json()
    _same_stats(ex, jex)
    st = ex.stats()
    assert st["partitioned_scans"] == len(sigs) + 1
    assert (st["streaming_chunks"] > 0) == scan_plane.plan_scan(
        ds.fact.num_rows, partitions, mdr).streaming
    assert st["rows_scanned"] == sum(p["rows_scanned"] for p in st["per_partition"])


def test_rows_per_partition_add_up(ssb_small):
    """Each partition reads its own rows once per scan: per-partition rows
    are its size times the scans, and they sum to the table's rows times
    the scans."""
    ds = from_reference(ssb_small.dataset)
    canon = SQLCanonicalizer(ds.schema)
    sigs = [canon.canonicalize(i.sql) for i in ssb_small.intents[:5]]
    ex = OlapExecutor(ds, partitions=3, max_device_rows=500, device="cpu")
    for sig in sigs:
        ex.execute(sig)
    parts = ex.stats()["per_partition"]
    assert [(p["start"], p["end"]) for p in parts] == [(0, 1334), (1334, 2668), (2668, 4000)]
    for p, chunks in zip(parts, scan_plane.plan_scan(ds.fact.num_rows, 3, 500).chunks):
        assert p["rows_scanned"] == (p["end"] - p["start"]) * len(sigs)
        assert p["chunks"] == len(chunks) * len(sigs) == 6 * len(sigs)
    assert sum(p["rows_scanned"] for p in parts) == ds.fact.num_rows * len(sigs) \
        == ex.rows_scanned


def test_count_distinct_falls_back_as_the_reference(ssb_small):
    ds = from_reference(ssb_small.dataset)
    sig = Signature("ssb", (Measure("COUNT", "lineorder.lo_custkey", distinct=True),),
                    levels=("customer.c_region",))
    jsig = JSignature("ssb", (JMeasure("COUNT", "lineorder.lo_custkey", distinct=True),),
                      levels=("customer.c_region",))
    ex = OlapExecutor(ds, partitions=4, device="cpu")
    jex = JOlapExecutor(ssb_small.dataset, impl="xla", partitions=4)
    got = ex.execute(sig)
    assert got.equals(jex.execute(jsig))
    assert got.equals(OlapExecutor(ds, impl="numpy").execute(sig))
    sum_sig = SQLCanonicalizer(ds.schema).canonicalize(REGION)
    out = ex.execute_batch([sig, sum_sig])
    jout = jex.execute_batch([jsig, JSQLCanonicalizer(ssb_small.schema).canonicalize(REGION)])
    assert all(a.equals(b) for a, b in zip(out, jout))
    _same_stats(ex, jex)
    assert ex.stats()["partition_fallbacks"] == 2 and ex.stats()["partitioned_scans"] == 1


def test_numpy_impl_partitions_through_the_host_oracle(ssb_small):
    ds = from_reference(ssb_small.dataset)
    canon = SQLCanonicalizer(ds.schema)
    ex1 = OlapExecutor(ds, impl="numpy")
    ex3 = OlapExecutor(ds, impl="numpy", partitions=3, max_device_rows=700)
    for intent in ssb_small.intents[:6]:
        sig = canon.canonicalize(intent.sql)
        assert ex1.execute(sig).equals(ex3.execute(sig), ordered=bool(sig.order_by))
    assert ex3.device is None and ds._device is None  # the oracle touches no device


def test_append_resyncs_the_partition_layout():
    """A delta append bumps the dataset version: the scan plan, resident
    subs and per-partition stats rebuild over the grown table, in both
    packages alike."""
    jwl, wl = jssb.build(n_fact=3000, seed=0), ssb.build(n_fact=3000, seed=0)
    sig = SQLCanonicalizer(wl.schema).canonicalize(REGION)
    jsig = JSQLCanonicalizer(jwl.schema).canonicalize(REGION)
    ex1 = OlapExecutor(wl.dataset, device="cpu")
    ex = OlapExecutor(wl.dataset, partitions=4, device="cpu")
    jex = JOlapExecutor(jwl.dataset, impl="xla", partitions=4)
    assert ex.execute(sig).equals(jex.execute(jsig))
    delta = make_delta(jwl.dataset, 500, np.random.default_rng(7))
    wl.dataset.append_rows(delta)
    jwl.dataset.append_rows(delta)
    got = ex.execute(sig)
    assert got.equals(ex1.execute(sig)) and got.equals(jex.execute(jsig))
    _same_stats(ex, jex)
    assert ex.stats()["per_partition"][-1]["end"] == wl.dataset.fact.num_rows == 3500


def test_partitions_pinned_to_devices_get_their_own_dims(ssb_small):
    """The several-card branch: partitions pinned to devices in turn, each
    device with its own pool of dimension tensors and its sub-executors on
    it.  Run here on two CPU "devices"; on one card ``_scan_devices`` gives
    None and the partitions run on streams instead."""
    ds = from_reference(ssb_small.dataset)
    canon = SQLCanonicalizer(ds.schema)
    ex1 = OlapExecutor(ds, device="cpu")
    ex = OlapExecutor(ds, partitions=4, device="cpu")
    assert ex._scan_devices() is None
    cpus = [torch.device("cpu"), torch.device("cpu", 0)]
    ex._devices = cpus
    for intent in ssb_small.intents:
        sig = canon.canonicalize(intent.sql)
        assert ex.execute(sig).equals(ex1.execute(sig), ordered=bool(sig.order_by))
    assert set(ex._dim_pools) == set(cpus)
    assert all(pool is not ex.dev._dim_store for pool in ex._dim_pools.values())
    subs = list(ex._subs.values())
    assert len(subs) == 4 and all(s.device.type == "cpu" and s.partitions == 1 for s in subs)
    assert {id(s.dev._dim_store) for s in subs} == {id(p) for p in ex._dim_pools.values()}


def test_a_staging_error_is_raised_in_the_scanning_thread(ssb_small, monkeypatch):
    """The stager of a streamed scan keeps its error and the scan raises
    it after the join, where the reference's stager drops it."""
    ds = from_reference(ssb_small.dataset)
    sig = SQLCanonicalizer(ds.schema).canonicalize(REGION)
    ex = OlapExecutor(ds, partitions=2, max_device_rows=700, device="cpu")

    def broken(sub, psigs):
        raise RuntimeError("CUDA error: an illegal memory access was encountered")

    monkeypatch.setattr(ex, "_stage_arrays", broken)
    with pytest.raises(RuntimeError, match="illegal memory access"):
        ex.execute(sig)
    monkeypatch.undo()
    assert ex.execute(sig).equals(OlapExecutor(ds, impl="numpy").execute(sig))


def test_concurrent_callers_share_one_partitioned_executor(ssb_small):
    """Eight threads (more than the cores this runs on) send batches to one
    streamed, partitioned executor at once, with a short switch interval:
    every table equals the oracle's and no counter loses an update."""
    ds = from_reference(ssb_small.dataset)
    canon = SQLCanonicalizer(ds.schema)
    sigs = [canon.canonicalize(i.sql) for i in ssb_small.intents]
    oracle = OlapExecutor(ds, impl="numpy")
    want = [oracle.execute(s) for s in sigs]
    ex = OlapExecutor(ds, partitions=4, max_device_rows=512, device="cpu")
    batches = {k: [[(k + i + j) % len(sigs) for j in range(4)] for i in range(3)]
               for k in range(8)}
    errors: list = []

    def caller(k):
        try:
            for batch in batches[k]:
                for j, t in zip(batch, ex.execute_batch([sigs[j] for j in batch])):
                    assert t.equals(want[j], ordered=bool(sigs[j].order_by)), j
        except Exception as e:  # re-raised below in the test's thread
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=caller, args=(k,)) for k in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors[0]
    alone = OlapExecutor(ds, partitions=4, max_device_rows=512, device="cpu")
    for batch in (b for k in range(8) for b in batches[k]):
        alone.execute_batch([sigs[j] for j in batch])
    st, want_st = ex.stats(), alone.stats()
    assert st["executions"] == 8 * 3 * 4
    for name in ("executions", "rows_scanned", "batch_groups", "partitioned_scans",
                 "streaming_chunks", "per_partition"):
        assert st[name] == want_st[name], name
    assert st["rows_scanned"] == sum(p["rows_scanned"] for p in st["per_partition"])


# ------------------------------------------------------- service plumbing


def _services(wl, partitions, shards=None):
    """A JAX and a port ``CacheService``, tenant ``t`` each, over
    ``OlapExecutor(partitions=...)`` on the same data."""
    ds = from_reference(wl.dataset)
    jbe = JOlapExecutor(wl.dataset, impl="xla", partitions=partitions)
    be = OlapExecutor(ds, partitions=partitions, device="cpu")
    jsvc, svc = JCacheService(), CacheService()
    jsvc.register_tenant("t", schema=wl.schema, backend=jbe, shards=shards,
                         cache=JSemanticCache(wl.schema,
                                              level_mapper=wl.dataset.level_mapper()))
    svc.register_tenant("t", schema=ds.schema, backend=be, shards=shards,
                        cache=SemanticCache(ds.schema, level_mapper=ds.level_mapper()))
    return (jsvc, jbe), (svc, be)


def _same(jres, res):
    assert [r.status for r in res] == [r.status for r in jres]
    for r, jr in zip(res, jres):
        assert r.provenance == jr.provenance
        assert (r.table is None) == (jr.table is None)
        if jr.table is not None:
            assert r.table.equals(jr.table)


def test_miss_group_executes_partitioned(ssb_small):
    (jsvc, jbe), (svc, be) = _services(ssb_small, 4)
    _, (svc1, _) = _services(ssb_small, 1)
    sqls = [i.sql for i in ssb_small.intents[:6]]
    jres = jsvc.submit_batch([JQueryRequest(sql=q, tenant="t") for q in sqls])
    res = svc.submit_batch([QueryRequest(sql=q, tenant="t") for q in sqls])
    res1 = svc1.submit_batch([QueryRequest(sql=q, tenant="t") for q in sqls])
    _same(jres, res)
    for a, b in zip(res1, res):
        assert a.status == b.status == "miss"
        assert a.table.equals(b.table)
        assert "execute:partitioned" in b.provenance
        assert "execute:partitioned" not in a.provenance
    assert be.partitioned_scans == jbe.partitioned_scans == 1
    st = svc.stats("t")["backend"]
    assert st["partitions"] == 4 and len(st["per_partition"]) == 4
    assert st["per_partition"] == jsvc.stats("t")["backend"]["per_partition"]


def test_cluster_leaders_share_one_partitioned_scan(ssb_small):
    """With a partition-parallel backend the cluster pipeline does not nest
    its shard pool on top of the partition pool: all miss leaders go
    through one cross-family ``execute_batch``."""
    (jsvc, jbe), (svc, be) = _services(ssb_small, 4, shards=4)
    sqls = [i.sql for i in ssb_small.intents[:6]]
    for _ in range(2):
        jres = jsvc.submit_batch([JQueryRequest(sql=q, tenant="t") for q in sqls])
        res = svc.submit_batch([QueryRequest(sql=q, tenant="t") for q in sqls])
        _same(jres, res)
    assert [r.status for r in res] == ["hit_exact"] * 6
    assert be.partitioned_scans == jbe.partitioned_scans == 1
    assert be.batch_calls == jbe.batch_calls == 1


def test_advance_snapshot_keeps_the_delta_scan_out_of_the_plane():
    """The refresh's delta scan stays partition-bounded:
    ``execute_batch(partition=...)`` does not route through the scan plane
    on a partitioned backend, and the refreshed table equals the oracle."""
    wl = jssb.build(n_fact=3000, seed=0)
    (jsvc, jbe), (svc, be) = _services(wl, 4)
    first = svc.submit(QueryRequest(sql=REGION, tenant="t"))
    assert first.status == jsvc.submit(JQueryRequest(sql=REGION, tenant="t")).status == "miss"
    scans = be.partitioned_scans
    delta = make_delta(wl.dataset, 400, np.random.default_rng(11))
    jrep = jsvc.advance_snapshot("t", delta=delta, snapshot_id="snap1")
    rep = svc.advance_snapshot("t", delta=delta, snapshot_id="snap1")
    assert dataclasses.asdict(rep) == dataclasses.asdict(jrep) and rep.refreshed == 1 and rep.delta_rows_scanned == 400
    assert be.partitioned_scans == scans == jbe.partitioned_scans
    again = svc.submit(QueryRequest(sql=REGION, tenant="t"))
    assert again.status.startswith("hit")
    assert again.table.equals(jsvc.submit(JQueryRequest(sql=REGION, tenant="t")).table)
    oracle = OlapExecutor(be.ds, impl="numpy")
    assert again.table.equals(oracle.execute(SQLCanonicalizer(be.ds.schema).canonicalize(REGION)))
