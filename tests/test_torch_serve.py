"""The port's SQL pipeline against the JAX ``CacheService`` end to end: the
SSB SQL stream (13 intents x 21 variants) and the hierarchical drill stream
at n_fact 4000, in batches of 8, through a plain ``SemanticCache`` with the
dataset's level mapper.  Per-request statuses, provenance and tables, and
the cache's counters, must be identical."""
import dataclasses

import pytest

from repro.core import SemanticCache as JSemanticCache
from repro.olap.executor import OlapExecutor as JOlapExecutor
from repro.service import CacheService, QueryRequest as JQueryRequest
from repro.workloads import hierarchical as jhier
from repro_torch.core.cache import SemanticCache
from repro_torch.kernels.seg_agg import ops as seg_ops
from repro_torch.launch import serve
from repro_torch.olap.columnar import from_reference
from repro_torch.olap.executor import OlapExecutor
from repro_torch.service.pipeline import Tenant
from repro_torch.workloads import ssb


@pytest.fixture(scope="module")
def streams(ssb_small):
    return {"ssb_sql": [q.text for q in ssb_small.queries(nl_paraphrases=0)],
            "drill": [q.text for q in jhier.build_stream(20)]}


def test_port_workload_generates_the_same_streams(streams):
    wl = ssb.build(n_fact=4000, seed=0)
    assert serve.sql_streams(wl) == streams
    assert len(streams["ssb_sql"]) == 273 and len(streams["drill"]) == 200


def _jax_replay(wl, sqls):
    svc = CacheService()
    cache = JSemanticCache(wl.schema, level_mapper=wl.dataset.level_mapper())
    tenant = svc.register_tenant("ssb", schema=wl.schema, cache=cache,
                                 backend=JOlapExecutor(wl.dataset, impl="xla"))
    out = []
    for i in range(0, len(sqls), 8):
        out += svc.submit_batch([JQueryRequest(sql=q, tenant="ssb")
                                 for q in sqls[i:i + 8]])
    return out, cache, tenant


def test_pipeline_matches_jax_service(ssb_small, streams):
    sqls = streams["ssb_sql"] + streams["drill"]
    jres, jcache, jtenant = _jax_replay(ssb_small, sqls)
    ds = from_reference(ssb_small.dataset)
    tenant = Tenant.create(ds.schema, OlapExecutor(ds, device="cpu"),
                           SemanticCache(ds.schema, level_mapper=ds.level_mapper()))
    seg_ops.reset_launch_count()
    res = serve.replay(tenant, sqls, batch=8)
    assert seg_ops.launch_count() > 0
    assert [r.status for r in res] == [r.status for r in jres]
    assert {"miss", "hit_exact", "hit_rollup"} <= {r.status for r in res}
    for i, (r, jr) in enumerate(zip(res, jres)):
        assert r.provenance == jr.provenance, (i, sqls[i])
        assert (r.batched, r.deduped) == (jr.batched, jr.deduped), i
        if jr.table is None:
            assert r.table is None, i
        else:
            assert r.table.equals(jr.table), (i, sqls[i])
    assert dataclasses.asdict(tenant.cache.stats) == dataclasses.asdict(jcache.stats)
    for name in ("requests", "batches", "bypasses", "backend_executions",
                 "batched_misses", "deduped_misses", "stores"):
        assert getattr(tenant.stats, name) == getattr(jtenant.stats, name), name
    assert tenant.backend.executions == jtenant.backend.executions
    assert tenant.backend.rows_scanned == jtenant.backend.rows_scanned


def test_serve_main_on_cpu(capsys):
    serve.main(["--n-fact", "3000", "--queries", "42", "--device", "cpu",
                "--simulated-llm"])
    out = capsys.readouterr().out
    assert '"requests": 242' in out and "hit_rate" in out
