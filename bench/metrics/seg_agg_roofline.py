"""Kernels (``kernels/seg_agg``): the share of their bound that the
window's ``seg_agg`` launches (kernels A and B) reached.  The bound is the
bytes each launch must move (``devtrace.seg_agg_bytes`` of its recorded
shape) over the card's HBM rate; the time is the profiler's device time
of every kernel whose name holds ``seg_agg`` (percent)."""

from yardstick.devtrace import seg_agg_bytes
from yardstick.peaks import HBM_BYTES_PER_S


def read(run):
    if run.trace is None or not run.shapes:
        return None
    spent = run.trace.seconds_of("seg_agg")
    if spent <= 0:
        return None
    bound = sum(seg_agg_bytes(shape) * n for shape, n in run.shapes.items()) / HBM_BYTES_PER_S
    return 100.0 * bound / spent
