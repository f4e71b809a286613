"""The SQL mixes draw what they drew before the harness took NL traffic
and a configuration's own modules: at seed 7, digests of the window's
schedule (each event's kind, due time and requests: intent, form index and
SQL text), of the set-up's and the warm-up's requests, and of the check's
sample over a window whose every answer is a miss, as taken from the
harness before that change."""
import hashlib
import types

import pytest

from yardstick import harness, traffic

PINNED = {
    # cell: (window events, schedule, set-up, warm-up, sample size, sample)
    "ssb-sf10.refresh": (4000, "d17c3f7d85d07f58", "5a45bcd874ab34ba", "a21f188ca3a21948",
                         33, "de320489b407a42e"),
    "ssb-sf1.adhoc": (20000, "ff4f75b808fca102", "7d2706f3ea3540fd", "38619273b2672785",
                      97, "b876e70baf8901e2"),
    "ssb-sf1.dashboard": (518, "9f138efaf197ac56", "7d2706f3ea3540fd", "cd584dd17780a8dc",
                          49, "b52cffbea2665b1b"),
}


def _digest(lines) -> str:
    h = hashlib.sha256()
    for line in lines:
        h.update(line.encode() + b"\n")
    return h.hexdigest()[:16]


def _requests(reqs) -> str:
    return "||".join(f"{r.intent!r}|{r.form}|{r.sql}" for r in reqs)


def _schedule(events) -> str:
    return _digest(f"{e.kind}|{e.due_s!r}|{_requests(e.requests)}" for e in events)


@pytest.mark.parametrize("cell", sorted(PINNED))
def test_the_sql_mixes_draw_as_before(cell):
    n, window, setup, warmup, n_sample, sample = PINNED[cell]
    spec, config, mix = harness.load_cell(cell)
    events = traffic.Generator(mix, 7, "window").schedule(5.0 if mix["loop"] == "open" else 51.0)
    warm = traffic.Generator(mix, 7, "warmup")
    assert (len(events), _schedule(events)) == (n, window)
    assert _digest(_requests([warm._request(it, "setup", form="sql")])
                   for it in traffic.level_space(mix)) == setup
    assert _schedule(warm.warmup()) == warmup
    served = [harness.Served(event=i, req=r, due=0.0, start=0.0, end=0.0, status="miss",
                             table=types.SimpleNamespace(num_rows=(i * 7 + j) % 1000),
                             timings={}, provenance=("execute:batched",), deduped=False)
              for i, e in enumerate(events[:1700]) for j, r in enumerate(e.requests)]
    picked = harness.sample(harness.Run(spec, config, mix, served, 51.0, {}), 7)
    assert (len(picked), _digest(f"{s.event}|{s.req.intent!r}|{s.req.form}"
                                 for s in picked)) == (n_sample, sample)
