"""The executor's per-layer readers (``prepare_ms``, ``fetch_ms``,
``assemble_ms``) on a traced run of the refresh cell on the CPU at a small
size: each reads a number, their sum stays within ``execute_ms``, and a
run with no execution, or from a program that records no phases, gives
none."""
import dataclasses
import time

import pytest

from yardstick import executions, harness

SMALL = {"lineorder": 20_000, "customer": 1_500, "supplier": 200, "part": 4_000}
READERS = ("prepare_ms", "fetch_ms", "assemble_ms")
PHASES = ("execute.prepare", "execute.fetch", "execute.assemble")


@pytest.fixture(scope="module")
def traced(request):
    """(result line, the run its readers read) of one traced run."""
    runs = []
    real = harness._metrics

    def keep(run, *args):
        runs.append(run)
        return real(run, *args)

    mp = pytest.MonkeyPatch()
    mp.setattr(harness, "_metrics", keep)
    try:
        out = harness.run_cell("ssb-sf10.refresh", 2**32 + 11, 1.5, True, "cpu",
                               time.perf_counter(), sizes=SMALL,
                               mix_overrides={"warmup_events": 2}, log=lambda _: None)
    finally:
        mp.undo()
    return out, runs[0]


def test_each_reader_reads_a_number(traced):
    out, _ = traced
    assert out["correct"]
    for name in READERS:
        assert out["metrics"][name]["unit"] == "ms" and out["metrics"][name]["value"] > 0


def test_the_phases_fit_inside_execute_ms(traced):
    out, run = traced
    assert sum(out["metrics"][n]["value"] for n in READERS) <= out["metrics"]["execute_ms"]["value"]
    each = [executions.readings(run, k) for k in PHASES]
    assert all(len(xs) == len(run.executions()) > 0 for xs in each)
    for total, *parts in zip(run.executions(), *each):
        assert sum(parts) <= total


@pytest.mark.parametrize("name", READERS)
def test_nothing_to_read(traced, name):
    """No execution in the window (every request a hit), or timings without
    the phases (a program from before them): the reader gives None."""
    _, run = traced
    hits = dataclasses.replace(run, served=[dataclasses.replace(s, provenance=("lookup:hit",))
                                            for s in run.served])
    assert harness.read_metric(name, hits) is None
    bare = dataclasses.replace(run, served=[
        dataclasses.replace(s, timings={k: v for k, v in s.timings.items() if "." not in k})
        for s in run.served])
    assert harness.read_metric(name, bare) is None
    assert harness.read_metric("execute_ms", bare) == harness.read_metric("execute_ms", run)
