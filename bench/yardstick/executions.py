"""Readings of one ``timings_ms`` key per backend execution in the window,
with the selection of ``harness.Run.executions``: a shared scan once (its
first request not deduplicated), a single execution once, deduplicated and
coalesced requests not at all.  A run whose program records no such key
(one before the executor's phases) gives none."""


def readings(run, key: str) -> list[float]:
    out = []
    for reqs in run.calls().values():
        batched = [s for s in reqs if "execute:batched" in s.provenance and not s.deduped]
        if batched and key in batched[0].timings:
            out.append(batched[0].timings[key])
        out += [s.timings[key] for s in reqs
                if "execute:single" in s.provenance and not s.deduped and key in s.timings]
    return out


def mean(run, key: str):
    """The mean of ``readings``, or None where there are none."""
    xs = readings(run, key)
    return sum(xs) / len(xs) if xs else None
