"""One run of one cell: set-up, the measured window, the traced reading and
the comparison with the plain reference.

``run_cell`` does everything but the look for a card, so that the tests
drive it on the CPU at a small size; ``bench/run.py`` looks for the card
and calls it on CUDA.  The program under test is ``repro_torch``: its
``CacheService`` with one tenant over ``OlapExecutor`` and a
``SemanticCache`` (a one-shard ``CacheCluster``: locked, with single-flight
misses, because several callers submit at once), wired as
``repro_torch.launch.serve.build_tenant`` wires it.  The harness hands the
service SQL text, or in a mix of ``"form": "nl"`` natural-language text.

What belongs to one configuration is found through its file: the data
come from its ``generator`` module (``generate(scale_factor, seed,
sizes)``, ``port_dataset(data)``), the answers from its ``reference``
module (``Reference(data).answer(intent)``), and its optional
``canonicalizer`` entry names the module that builds the tenant's NL
canonicalizer and checks what the model produced (``build``, ``replay``,
``judge``: ``bench/README.md``).  ``yardstick/modules.py`` loads them by
their paths under ``bench/``.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import gc
import json
import queue
import random
import statistics
import sys
import threading
import time
from pathlib import Path

import numpy as np

from . import compare, devtrace, modules, traffic
from .flights import Intent
from .reference import gap, table_answer

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent
TENANT = "bench"
OK_STATUSES = ("hit_exact", "hit_rollup", "hit_filterdown", "hit_compose", "miss", "bypass")
BANNED = ("jax", "jaxlib", "flax", "repro")  # top-level module names


def banned_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's, Flax's or the JAX
    package's (compared whole: ``repro_torch`` is not ``repro``)."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(BANNED))


@dataclasses.dataclass
class Served:
    """One request's outcome, with the host clock's readings (seconds since
    the window opened)."""

    event: int
    req: traffic.Request
    due: float
    start: float  # submit_batch called
    end: float  # submit_batch returned
    status: str
    table: object
    timings: dict
    provenance: tuple
    deduped: bool
    signature: object = None  # the intent signature the service executed


@dataclasses.dataclass
class Run:
    """What the end-to-end metrics and the per-layer readers read."""

    cell: dict
    config: dict
    mix: dict
    served: list[Served]
    window_s: float  # the measured window (closed loop: to the last batch's end)
    cache_delta: dict  # CacheStats fields over the window
    trace: devtrace.Reduction | None = None
    shapes: collections.Counter = dataclasses.field(default_factory=collections.Counter)
    opened: float = 0.0  # the host clock (perf_counter) when the window opened
    # the program's counters over the window (``window_counters``, read at
    # its two ends): ``launch.<kernel>``, and ``nl.<name>`` of the
    # canonicalizer module's ``counters`` where it has one
    counters: dict = dataclasses.field(default_factory=dict)

    def calls(self) -> dict[int, list[Served]]:
        """The requests of each ``submit_batch`` call."""
        out: dict[int, list[Served]] = {}
        for s in self.served:
            out.setdefault(s.event, []).append(s)
        return out

    def executions(self) -> list[float]:
        """Wall ms of each backend execution in the window: a shared scan
        once, a single execution once, deduplicated and coalesced requests
        not at all."""
        out = []
        for reqs in self.calls().values():
            batched = [s for s in reqs if "execute:batched" in s.provenance and not s.deduped]
            if batched:
                out.append(batched[0].timings["execute"])
            out += [s.timings["execute"] for s in reqs
                    if "execute:single" in s.provenance and not s.deduped]
        return out


def load_cell(name: str) -> tuple[dict, dict, dict]:
    """(cell, configuration, mix) of cell ``name``: a cell of
    ``BENCHMARK.json``, or ``<config>.<mix>`` of files under ``bench/``
    that no cell uses yet (a mix left out, run by hand or by the tests)."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cells = {c["name"]: c for c in bench["workloads"]}
    if name not in cells:
        cfg, _, mix = name.partition(".")
        if not ((BENCH_DIR / "configs" / f"{cfg}.json").exists()
                and (traffic.TRAFFIC_DIR / f"{mix}.json").exists()):
            raise SystemExit(f"unknown workload {name!r}: {sorted(cells)}")
        cells[name] = {"name": name, "config": cfg, "traffic": mix, "chips": 1}
    cell = cells[name]
    config = json.loads((BENCH_DIR / "configs" / f"{cell['config']}.json").read_text())
    return cell, config, traffic.load(cell["traffic"])


def metric_specs(cell: dict, trace: bool) -> list[dict]:
    """The metrics this cell reports: its end-to-end ones, or with a traced
    run its per-layer ones."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    key = "per_layer" if trace else "end_to_end"
    return [m for m in bench[key] if cell["name"] in m.get("workloads", [cell["name"]])]


# ------------------------------------------------------------ the program

def build_service(data, config: dict, device: str, nl=None):
    """The service under test over ``data``, wired as the port's
    ``launch.serve.build_tenant`` wires a tenant, with the configuration's
    cache capacity, shards and executor settings and the NL canonicalizer
    ``nl``."""
    from repro_torch.core.cache import SemanticCache
    from repro_torch.core.safety import SafetyPolicy
    from repro_torch.olap.executor import OlapExecutor
    from repro_torch.service import CacheService

    ds = modules.load(config["generator"]).port_dataset(data)
    ex = config["executor"]
    backend = OlapExecutor(ds, device=device, memo_cap=int(ex["memo_cap"]),
                           partitions=int(ex["partitions"]))
    cache = SemanticCache(ds.schema, capacity=int(config["cache"]["capacity"]),
                          level_mapper=ds.level_mapper())
    svc = CacheService()
    ambiguous = tuple((k, tuple(v)) for k, v in config["spatial_ambiguous"])
    tenant = svc.register_tenant(TENANT, schema=ds.schema, backend=backend, cache=cache, nl=nl,
                                 policy=SafetyPolicy.balanced(ambiguous),
                                 shards=int(config["cache"]["shards"]))
    return svc, tenant


def _requests(reqs, fresh: bool = False):
    """The service's requests: SQL or NL text, and with ``fresh`` the forced
    freshness of a scheduled refresh (the cache is not read; the result is
    stored anew)."""
    from repro_torch.service import QueryRequest

    return [QueryRequest(sql=r.sql, tenant=TENANT, refresh=fresh) if r.nl is None
            else QueryRequest(nl=r.nl, tenant=TENANT, refresh=fresh) for r in reqs]


def _cache_stats(tenant) -> dict:
    st = tenant.cache.stats
    return {f.name: getattr(st, f.name) for f in dataclasses.fields(st)}


def window_counters(canon, nl) -> dict:
    """The program's counters as they stand: every kernel's launches
    (``repro_torch.kernels.binding.launch_counts``, keyed
    ``launch.<kernel>``) and, where the configuration's canonicalizer
    module has ``counters(nl)``, its numbers (keyed ``nl.<name>``)."""
    from repro_torch.kernels.binding import launch_counts

    out = {f"launch.{k}": v for k, v in launch_counts().items()}
    if canon is not None and hasattr(canon, "counters"):
        out.update({f"nl.{k}": v for k, v in canon.counters(nl).items()})
    return out


@contextlib.contextmanager
def _range(name: str, on: bool):
    if not on:
        yield
        return
    from torch.profiler import record_function

    with record_function(name):
        yield


# -------------------------------------------------------------- the window

def _open_loop(svc, events, callers: int, seconds: float, traced: bool, fresh: bool, log):
    """Events handed to ``callers`` threads at their due times; returns
    (served, the generator's lateness per event in s)."""
    q: queue.Queue = queue.Queue()
    served: list[Served] = []
    lock = threading.Lock()
    late: list[float] = []
    stop = threading.Event()  # set a minute past the close: what is left goes unanswered
    t0 = time.perf_counter()

    def caller():
        while True:
            with _range("bench.wait", traced):
                item = q.get()
            if item is None or stop.is_set():
                return
            i, ev = item
            start = time.perf_counter() - t0
            with _range("bench.submit_batch", traced):
                results = svc.submit_batch(_requests(ev.requests, fresh))
            end = time.perf_counter() - t0
            with lock:
                served.extend(_outcomes(i, ev, ev.due_s, start, end, results))

    threads = [threading.Thread(target=caller, name=f"caller-{k}", daemon=True)
               for k in range(callers)]
    for th in threads:
        th.start()
    try:
        for i, ev in enumerate(events):
            wait = ev.due_s - (time.perf_counter() - t0)
            if wait > 0:
                time.sleep(wait)
            with _range("bench.generate", traced):
                late.append(time.perf_counter() - t0 - ev.due_s)
                q.put((i, ev))
        left = seconds - (time.perf_counter() - t0)
        if left > 0:
            time.sleep(left)
    finally:
        for _ in threads:
            q.put(None)
        deadline = time.perf_counter() + 60.0  # a minute past the close for the backlog
        for th in threads:
            th.join(max(0.0, deadline - time.perf_counter()))
        stop.set()
        for th in threads:
            th.join()  # each ends after the call it is in
    with lock:
        unanswered = len(events) - len({s.event for s in served})
    if unanswered:
        log(f"[window] {unanswered} events unanswered a minute after the window closed")
    return served, late


def _closed_loop(svc, events, seconds: float, clients: int, traced: bool, fresh: bool):
    """``clients`` threads, each submitting the next event as soon as its
    last returned, until ``seconds`` have passed; returns (served, the
    seconds from the start to the last call's end)."""
    served: list[Served] = []
    lock = threading.Lock()
    order = iter(enumerate(events))
    t0 = time.perf_counter()

    def client():
        while True:
            with lock:
                start = time.perf_counter() - t0
                item = next(order, None) if start < seconds else None
            if item is None:
                return
            i, ev = item
            with _range("bench.submit_batch", traced):
                results = svc.submit_batch(_requests(ev.requests, fresh))
            end = time.perf_counter() - t0
            with lock:
                served.extend(_outcomes(i, ev, start, start, end, results))

    threads = [threading.Thread(target=client, name=f"client-{k}") for k in range(clients)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    if len({s.event for s in served}) == len(events):
        raise RuntimeError(f"the mix's {len(events)} events ran out before {seconds} s: "
                           f"raise max_events")
    return served, max(s.end for s in served)


def _outcomes(i, ev, due, start, end, results) -> list[Served]:
    return [Served(i, req, due, start, end, r.status, r.table, dict(r.timings_ms),
                   tuple(r.provenance), bool(r.deduped), r.signature)
            for req, r in zip(ev.requests, results)]


# ------------------------------------------------------------------ a run

def run_cell(name: str, seed: int, seconds: float, trace: bool, device: str,
             t_start: float, rate: float | None = None, sizes: dict | None = None,
             fault: str | None = None, mix_overrides: dict | None = None,
             log=None) -> dict:
    """One run of cell ``name``: the result line's dict (``correct``,
    ``attempted``, ``failed``, ``metrics``, ``device``, ``breakdown`` when
    traced, ``compared``).  ``t_start`` is the host clock when the process
    started (set-up is counted from it).  ``rate`` overrides an open-loop
    mix's rate (the knee's sweep), ``sizes`` the tables' rows (the tests),
    ``fault`` plants one of ``compare.FAULTS`` under the service, or one of
    the canonicalizer module's ``FAULTS`` in the model, and
    ``mix_overrides`` replaces parameters of the mix (the tests).

    A configuration with a ``canonicalizer`` entry has its module build the
    NL canonicalizer after the data (set-up), ``replay`` a sample of the
    window's batches through it once the window has closed and before the
    program is torn down, and ``judge`` those records after the teardown,
    when the card is free for a reference; its optional ``counters(nl)``
    joins ``Run.counters``."""
    log = log or (lambda msg: print(msg, file=sys.stderr, flush=True))
    import torch

    cell, config, mix = load_cell(name)
    mix = {**mix, **(mix_overrides or {})}
    cuda = device == "cuda"
    phases = {"start": time.perf_counter() - t_start}
    if cuda:
        from repro_torch.kernels.build import library_path, load

        built = not library_path("seg_agg").exists()
        load("seg_agg")  # built into build/kernels on a checkout's first run
        phases["kernels"] = time.perf_counter() - t_start
        # the build stays in setup_s (a run that compiles counts its
        # compilation); its seconds are printed apart
        log(f"[setup] seg_agg {'built' if built else 'loaded, built before'} in "
            f"{phases['kernels'] - phases['start']:.3f} s")
    data = modules.load(config["generator"]).generate(int(config["scale_factor"]), seed,
                                                      sizes=sizes)
    phases["data"] = time.perf_counter() - t_start
    canon = nl = None
    if "canonicalizer" in config:
        canon = modules.load(config["canonicalizer"]["module"])
        nl = canon.build(config, data, seed, device)
        phases["canonicalizer"] = time.perf_counter() - t_start
    svc, tenant = build_service(data, config, device, nl)
    undo = None
    if fault:
        undo = compare.plant(fault, tenant.backend) if canon is None or \
            fault in compare.FAULTS else canon.plant(fault, nl)

    # set-up: every grouping the mix can ask for, each executed (forced
    # fresh, so that no derivation from another answers it), then the mix's
    # own warm-up stream, its events submitted a batch of them at a time
    fresh = bool(mix.get("fresh"))
    warm = traffic.Generator(mix, seed, "warmup")
    for it in traffic.level_space(mix):
        svc.submit_batch(_requests([warm._request(it, "setup", form="sql")], fresh=True))
    phases["groupings"] = time.perf_counter() - t_start
    stream = warm.warmup()
    step = int(mix.get("warmup_batch", 1))
    for i in range(0, len(stream), step):
        svc.submit_batch(_requests([r for ev in stream[i:i + step] for r in ev.requests], fresh))
    phases["warmup"] = time.perf_counter() - t_start
    events = traffic.Generator(mix, seed, "window").schedule(seconds, rate)
    if cuda:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t_start
    phases["schedule"] = setup_s
    rows = {t: data.rows(t) for t in data.tables}
    log(f"[setup] {setup_s:.3f} s: rows {rows}, {len(events)} events "
        f"({sum(len(e.requests) for e in events)} requests) drawn; s since start at the end "
        f"of each phase: " + ", ".join(f"{k} {v:.3f}" for k, v in phases.items()))

    stats0 = _cache_stats(tenant)
    counters0 = window_counters(canon, nl)
    prof = shapes = None
    if trace:
        shapes = devtrace.LaunchShapes().__enter__()
        prof = devtrace.start(cuda)
    late: list[float] = []
    opened = time.perf_counter()
    if mix["loop"] == "open":
        served, late = _open_loop(svc, events, int(mix["callers"]), seconds, trace, fresh, log)
        window_s = seconds
    else:
        served, window_s = _closed_loop(svc, events, seconds, int(mix.get("clients", 1)),
                                        trace, fresh)
    if cuda:
        torch.cuda.synchronize()
    reduction = None
    if trace:
        reduction = devtrace.stop(prof, cuda)
        shapes.__exit__(None, None, None)
    stats1 = _cache_stats(tenant)
    counters1 = window_counters(canon, nl)
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    run = Run(cell, config, mix, served, window_s,
              {k: stats1[k] - stats0[k] for k in stats0}, reduction,
              shapes.counts if shapes else collections.Counter(), opened,
              {k: counters1.get(k, 0) - counters0.get(k, 0)
               for k in sorted(counters0.keys() | counters1.keys())})

    attempted = sum(len(e.requests) for e in (
        events if mix["loop"] == "open" else [events[i] for i in run.calls()]))
    failed = attempted - len(served) + sum(1 for s in served if s.status not in OK_STATUSES)
    metrics = _metrics(run, setup_s, trace, log)
    _log_window(run, late, log)

    # the model's outputs are taken from the program before it goes, and
    # the program's state goes before a reference runs
    records = canon.replay(nl, run, seed, log) if canon else None
    if undo:
        undo()
    del svc, tenant, nl
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    model = canon.judge(records, config, seed, device) if canon else None
    checks, compared = check(run, data, seed, log, model)

    out = {
        "correct": compared["correct"],
        "attempted": attempted,
        "failed": failed,
        "metrics": metrics,
        "device": _device(cuda, peak, reduction),
    }
    if reduction is not None:
        out["breakdown"] = reduction.breakdown()
    for k, v in compared["numbers"].items():
        log(f"[compare] {k} {v['value']!r} limit {v['limit']!r}")
    out["compared"] = compared["numbers"]
    return out


def _device(cuda: bool, peak: int, red) -> dict:
    if cuda:
        import torch

        d = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": 1,
             "memory_peak_bytes": int(peak)}
    else:
        d = {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    if red is not None:
        d["busy_s"], d["window_s"] = red.busy_s, red.window_s
    return d


def _percentile(xs, q: float) -> float:
    return float(np.percentile(np.asarray(xs, dtype=np.float64), q))


def _metrics(run: Run, setup_s: float, trace: bool, log) -> dict:
    out = {}
    for spec in metric_specs(run.cell, trace):
        name = spec["name"]
        if trace:
            value = read_metric(name, run)
            if value is None:
                log(f"[metrics] {name}: nothing to read in this run")
                continue
        elif name == "setup_s":
            value = setup_s
        elif name == "latency_p50_ms":
            value = _percentile([(s.end - s.due) * 1e3 for s in run.served], 50)
        elif name == "latency_p95_ms":
            value = _percentile([(s.end - s.due) * 1e3 for s in run.served], 95)
        elif name == "queries_per_s":
            value = len(run.served) / run.window_s
        else:
            raise SystemExit(f"no measurement for end-to-end metric {name!r}")
        out[name] = {"value": float(value), "unit": spec["unit"]}
    return out


def read_metric(name: str, run: Run):
    """The per-layer metric ``name`` from its reader,
    ``bench/metrics/<name>.py`` (``read(run)``, None where it finds
    nothing)."""
    return modules.load(f"metrics/{name}.py").read(run)


def _log_window(run: Run, late: list[float], log) -> None:
    st = collections.Counter(s.status for s in run.served)
    lat = [(s.end - s.due) * 1e3 for s in run.served]
    log(f"[window] {run.window_s:.3f} s, {len(run.served)} requests in {len(run.calls())} "
        f"calls; statuses {dict(sorted(st.items()))}")
    log(f"[window] counters {run.counters}")
    if lat:
        log(f"[window] latency ms p50 {_percentile(lat, 50):.4f} p95 {_percentile(lat, 95):.4f} "
            f"p99 {_percentile(lat, 99):.4f} max {max(lat):.4f}")
        quarters = np.array_split(np.asarray(sorted(((s.due, (s.end - s.due) * 1e3)
                                                        for s in run.served)))[:, 1], 4)
        log("[window] latency ms by quarter of the window (p50/p95): " + ", ".join(
            f"{_percentile(q, 50):.3f}/{_percentile(q, 95):.3f}" for q in quarters if len(q)))
        slowest = {}
        for s in sorted(run.served, key=lambda s: s.due - s.end):
            slowest.setdefault(s.event, s)
        for s in list(slowest.values())[:5]:
            it = s.req.intent
            log(f"[window] slow: {(s.end - s.due) * 1e3:.3f} ms (queued "
                f"{(s.start - s.due) * 1e3:.3f}) at {s.due:.3f} s, {s.status} {it.flight} "
                f"{list(it.levels)} host_mask {it.host_mask}, stages "
                f"{ {k: round(v, 3) for k, v in s.timings.items()} }")
    if late:
        log(f"[window] generator late ms p50 {statistics.median(late) * 1e3:.4f} max "
            f"{max(late) * 1e3:.4f}")
        calls = run.calls()
        waits = [calls[i][0].start - calls[i][0].due for i in sorted(calls)]
        if waits:
            q = max(1, len(waits) // 4)
            log(f"[window] queue wait ms, first quarter {np.mean(waits[:q]) * 1e3:.4f}, "
                f"last quarter {np.mean(waits[-q:]) * 1e3:.4f} (a backlog that grows "
                f"shows as the second far above the first)")


# --------------------------------------------------------- the comparison

def sample(run: Run, seed: int) -> list[Served]:
    """The answers the comparison takes: per class (status, and for misses
    the kernel the intent takes; ``compare.answer_class``) up to the mix's
    ``check.per_class``, drawn from the seed, and the answer with the most
    groups.  NL requests that the gate bypassed with no table
    (``nl.gated``) have no answer to take."""
    per = int(run.mix["check"]["per_class"])
    classes: dict[str, list[Served]] = {}
    for s in run.served:
        k = compare.answer_class(s)
        if k != "nl.gated":
            classes.setdefault(k, []).append(s)
    rng = random.Random(f"{seed}|check")
    out = []
    for k in sorted(classes):
        xs = classes[k]
        out += xs if len(xs) <= per else rng.sample(xs, per)
    with_table = [s for s in run.served if s.table is not None]
    if with_table:
        out.append(max(with_table, key=lambda s: s.table.num_rows))
    return out


def check(run: Run, data, seed: int, log, model: dict | None = None) -> tuple[list, dict]:
    """Every sampled answer against the configuration's plain reference: a
    SQL answer against its question's intent, an NL answer against the
    signature that the service executed for it (the reference's
    ``intent_of``), counting those that differ from the question's intent
    (no limit) and those that the reference cannot express (not compared;
    ``nl_unmapped``), and the window's NL requests gated with no table
    (``nl_gated_share``).  ``model`` holds the canonicalizer module's
    numbers, each with its limit."""
    t0 = time.perf_counter()
    ref = modules.load(run.config["reference"]).Reference(data)
    limit = run.config["limits"]["widest_gap"]
    answers: dict[Intent, dict] = {}

    def answer(it: Intent) -> dict:
        if it not in answers:
            answers[it] = ref.answer(it)
        return answers[it]

    rows = []
    nl = collections.Counter()
    for s in sample(run, seed):
        it = s.req.intent
        if s.req.nl is not None:
            it = ref.intent_of(s.signature) if s.signature is not None else None
            if it is None:
                nl["unmapped"] += 1
                continue
            asked = dataclasses.replace(s.req.intent, levels=tuple(sorted(s.req.intent.levels)))
            d, w = gap(answer(it), answer(asked)) if asked.levels == it.levels else (True, 0.0)
            nl["compared"] += 1
            nl["not_the_question"] += int(d or w > limit)
        served = None if s.table is None else table_answer(s.table, it.levels)
        differ, widest = gap(served, answer(it))
        rows.append((compare.answer_class(s), differ, widest))
        if differ or widest > limit:
            _log_mismatch(s, served, answer(it), widest, log)
    asked = [s for s in run.served if s.req.nl is not None]
    gated = sum(1 for s in asked if compare.answer_class(s) == "nl.gated")
    compared = compare.judge(rows, run.config["limits"], model, {
        "gated_share": gated / len(asked), "unmapped": nl["unmapped"]} if asked else None)
    by_class = collections.Counter(c for c, _, _ in rows)
    log(f"[compare] {len(rows)} answers against the reference in "
        f"{time.perf_counter() - t0:.3f} s ({len(answers)} distinct intents): "
        f"{dict(sorted(by_class.items()))}")
    if asked:
        log(f"[compare] NL: {gated} of {len(asked)} "
            f"gated with no table (not compared); of the sample, {nl['compared']} compared on "
            f"the executed signature, {nl['not_the_question']} of them not the question's "
            f"intent, {nl['unmapped']} not expressible by the reference (not compared)")
    return rows, compared


def _log_mismatch(s: Served, served, ref: dict, widest: float, log) -> None:
    """What a wrong answer was, for the record of a run that is not
    correct."""
    log(f"[mismatch] {compare.answer_class(s)} event {s.event} ({s.req.kind}, form "
        f"{s.req.form}) provenance {list(s.provenance)} intent {s.req.intent}")
    log(f"[mismatch] {'nl' if s.req.nl else 'sql'} {' '.join((s.req.nl or s.req.sql).split())}")
    if served is None:
        log("[mismatch] no table in the served shape")
        return
    extra, missing = sorted(set(served) - set(ref)), sorted(set(ref) - set(served))
    log(f"[mismatch] {len(served)} groups served, {len(ref)} in the reference; served only "
        f"{extra[:5]}, reference only {missing[:5]}; widest gap {widest!r}")
    for k in sorted(set(served) & set(ref))[:3]:
        log(f"[mismatch]   {k}: served {served[k]!r}, reference {ref[k]!r}")
