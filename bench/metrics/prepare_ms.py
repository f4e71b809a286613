"""Executor (``olap/executor.py``): the mean time of one backend execution
in the window spent before the kernels run (level plans, group ids,
predicate bounds, every upload to the device, a host mask too, and the
kernels' enqueue), from the ``execute.prepare`` key of
``QueryResult.timings_ms``, executions selected as ``execute_ms`` selects
them (milliseconds)."""
from yardstick import executions


def read(run):
    return executions.mean(run, "execute.prepare")
