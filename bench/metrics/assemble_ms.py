"""Executor (``olap/executor.py``): the mean time of one backend execution
in the window spent assembling its tables on the host (``_finalize`` to
the finished table, and a partitioned scan's merge), from the
``execute.assemble`` key of ``QueryResult.timings_ms``, executions
selected as ``execute_ms`` selects them (milliseconds)."""
from yardstick import executions


def read(run):
    return executions.mean(run, "execute.assemble")
