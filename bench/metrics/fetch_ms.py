"""Executor (``olap/executor.py``): the mean time of one backend execution
in the window spent fetching its results (the wait for the kernel, the
copy to the host and the widening to float64), from the ``execute.fetch``
key of ``QueryResult.timings_ms``, executions selected as ``execute_ms``
selects them (milliseconds)."""
from yardstick import executions


def read(run):
    return executions.mean(run, "execute.fetch")
