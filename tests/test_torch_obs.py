"""The port's tracing on the CPU: the executor's phases (``execute.prepare``,
``execute.fetch``, ``execute.assemble``) in ``QueryResult.timings_ms``
for a single execution, a shared scan and a partitioned scan; the spans of
sampled requests at their real starts, on the clock ``torch.profiler``
stamps its events with; and the phases' collector itself."""
import pytest

from repro_torch.examples.data import DASHBOARD
from repro_torch.obs import ObsConfig, trace_completeness
from repro_torch.obs.trace import Phases, adopt_phases, phase
from repro_torch.olap.executor import OlapExecutor
from repro_torch.core import SafetyPolicy, SemanticCache
from repro_torch.core.sql_canon import SQLCanonicalizer
from repro_torch.launch import serve
from repro_torch.service import CacheService, QueryRequest
from repro_torch.service.pipeline import STAGES
from repro_torch.workloads import ssb

PHASES = ("execute.prepare", "execute.fetch", "execute.assemble")
# seven tiles of one grouping (c_region; SUM, COUNT, MIN, MAX), differing
# only in their filters: one shared scan with a SUM and a MIN/MAX block
TILES = DASHBOARD[:7]


@pytest.fixture(scope="module")
def wl():
    return ssb.build(n_fact=20_000, seed=0)


def service(wl, partitions=1, sample_rate=1.0):
    svc = CacheService(obs=ObsConfig(tracing=True, sample_rate=sample_rate))
    backend = OlapExecutor(wl.dataset, device="cpu", partitions=partitions)
    cache = SemanticCache(wl.schema, level_mapper=wl.dataset.level_mapper())
    tenant = svc.register_tenant(serve.TENANT, schema=wl.schema, backend=backend,
                                 cache=cache,
                                 policy=SafetyPolicy.balanced(wl.spatial_ambiguous))
    return svc, tenant


def submit(svc, sqls):
    return svc.submit_batch([QueryRequest(sql=q, tenant=serve.TENANT) for q in sqls])


def spans_of(tenant, result) -> dict:
    return {s["name"]: s for s in tenant.obs.tracer.spans(result.trace_id)}


def end_s(span) -> float:
    return span["start_s"] + span["dur_ms"] / 1e3


@pytest.mark.parametrize("case", ["single", "shared", "partitioned"])
def test_phase_timings_of_each_execution(wl, case):
    """Each phase is timed (> 0), a shared scan's sums go to each of its
    requests alike, and together they fit inside ``execute``."""
    svc, _ = service(wl, partitions=2 if case == "partitioned" else 1)
    results = submit(svc, TILES[:1] if case == "single" else TILES)
    want = {"single": "execute:single", "shared": "execute:batched",
            "partitioned": "execute:partitioned"}[case]
    for r in results:
        assert r.status == "miss" and want in r.provenance, r.provenance
        t = r.timings_ms
        assert all(t[k] > 0 for k in PHASES), t
        assert sum(t[k] for k in PHASES) <= t["execute"]
    first = results[0].timings_ms
    assert all({k: r.timings_ms[k] for k in PHASES + ("execute",)}
               == {k: first[k] for k in PHASES + ("execute",)} for r in results)


def test_stage_histograms_keep_to_the_stages(wl):
    """``stats()`` and ``metrics()`` see the pipeline's stages alone: the
    phases are children of ``execute``, not stages."""
    svc, tenant = service(wl)
    submit(svc, TILES)
    assert set(tenant.stats.stage_histograms()) <= set(STAGES)
    assert "execute.prepare" not in svc.metrics()


def test_every_stage_in_provenance_has_a_span(wl):
    svc, tenant = service(wl)
    results = []
    for i in range(0, 4 * len(TILES), 5):  # misses, exact hits, shared scans
        results += submit(svc, [TILES[j % len(TILES)] for j in range(i, i + 5)])
    report = trace_completeness(results, tenant.obs.tracer)
    assert report["ok"], report["missing"]
    assert report["traces_checked"] == len(results)


def test_spans_start_where_their_work_started(wl):
    """Stage spans sit at their recorded starts (no longer end to end from
    the request's start): ``execute`` lies inside the live
    ``execute.backend`` span that wraps it, and so does each phase, a child
    of ``execute.backend`` with its counts."""
    svc, tenant = service(wl)
    results = submit(svc, TILES)
    sp = spans_of(tenant, results[0])
    backend = sp["execute.backend"]
    # execute.backend reads time.time() itself, the others are the trace's
    # anchor plus a perf_counter offset: the two agree far within 0.1 ms
    slack = 1e-4
    for name in ("execute",) + PHASES:
        s = sp[name]
        assert backend["start_s"] - slack <= s["start_s"], name
        assert end_s(s) <= end_s(backend) + slack, name
    for name in PHASES:
        assert sp[name]["parent"] == backend["span"]
        assert sp[name]["attrs"]["signatures"] == len(TILES)
        assert sp[name]["attrs"]["groups"] > 0
    assert sp["execute.fetch"]["attrs"]["bytes"] > 0
    assert sp["execute.prepare"]["start_s"] < sp["execute.fetch"]["start_s"] \
        < sp["execute.assemble"]["start_s"]
    stages = sorted((s for s in sp.values() if s["name"] in STAGES),
                    key=lambda s: s["start_s"])
    assert [s["name"] for s in stages] == [n for n in STAGES if n in sp]
    gaps = [b["start_s"] - end_s(a) for a, b in zip(stages, stages[1:])]
    assert all(g > -slack for g in gaps) and any(g > 1e-6 for g in gaps), gaps


def test_spans_share_the_profilers_clock(wl):
    """A torch op that the plain ``seg_agg`` path runs inside
    ``execute.prepare`` has its profiler start and end inside that span,
    within 1 ms: both clocks are the Unix epoch's."""
    from torch.profiler import ProfilerActivity, profile

    svc, tenant = service(wl)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        results = submit(svc, TILES[:1])
    prep = spans_of(tenant, results[0])["execute.prepare"]
    ops = [e for e in prof.profiler.kineto_results.events() if e.name() == "aten::index_add_"]
    assert ops
    lo, hi = prep["start_s"] * 1e9 - 1e6, end_s(prep) * 1e9 + 1e6
    assert any(lo <= e.start_ns() <= e.end_ns() <= hi for e in ops), (
        [(e.start_ns() - prep["start_s"] * 1e9) / 1e6 for e in ops], prep["dur_ms"])


def test_executor_without_a_collector_gives_the_same_table(wl):
    """Called directly (no collector installed, as tests and examples call
    it) the executor times nothing and returns the table it returns under
    a collector."""
    sig = SQLCanonicalizer(wl.schema).canonicalize(TILES[3])
    ex = OlapExecutor(wl.dataset, device="cpu")
    with phase("execute.prepare") as col:
        assert col is None
    plain = ex.execute(sig)
    with adopt_phases(Phases()) as phases:
        timed = ex.execute(sig)
    assert plain.equals(timed)
    assert set(phases.sums()) == set(PHASES) and phases.counts["signatures"] == 1


def test_overlapping_phases_share_their_time():
    """Phases of several threads that overlap share each instant: the sums
    add up to the union of the intervals, and one thread's are plain."""
    ph = Phases()
    ph.add("a", 0.0, 0.002)
    ph.add("a", 0.001, 0.003)  # a second thread's "a"
    ph.add("b", 0.002, 0.004)
    sums = ph.sums()
    assert list(sums) == ["a", "b"]
    assert sums["a"][0] == pytest.approx(2.5) and sums["b"][0] == pytest.approx(1.5)
    assert sums["a"][1] == 0.0 and sums["b"][1] == 0.002
    one = Phases()
    one.add("a", 0.0, 0.001)
    one.add("b", 0.001, 0.003)
    one.add("a", 0.003, 0.004)
    assert {k: v[0] for k, v in one.sums().items()} == pytest.approx({"a": 2.0, "b": 2.0})


def test_unsampled_requests_get_phase_timings_and_no_spans(wl):
    """At a sample rate of 0 no trace and no span is made; the phase
    timings are there all the same."""
    svc, tenant = service(wl, sample_rate=0.0)
    results = submit(svc, TILES)
    assert all(r.trace_id is None and r.timings_ms["execute.fetch"] > 0 for r in results)
    assert tenant.obs.tracer.spans() == []
