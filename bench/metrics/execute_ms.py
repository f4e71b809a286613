"""Executor (``olap/executor.py``): the mean wall time of one backend
execution in the window, from the ``execute`` stage of
``QueryResult.timings_ms``: a shared scan counted once, deduplicated and
coalesced requests not at all (milliseconds)."""


def read(run):
    xs = run.executions()
    return sum(xs) / len(xs) if xs else None
