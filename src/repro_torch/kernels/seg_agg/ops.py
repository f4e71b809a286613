"""Dispatching wrappers for grouped aggregation.

Dispatch is by the device of the tensors: CUDA tensors go to the
hand-written kernels of ``kernel.py``, CPU tensors to the plain PyTorch
versions of ``ref.py``.  There is no switch that sends CUDA tensors to the
plain versions.

Five entry points, with the shapes and return contracts of the JAX
package's ``repro/kernels/seg_agg/ops.py``:

* ``seg_agg``        — (N, M) grouped aggregation with an explicit mask,
  multiply contract (the legacy per-measure path);
* ``seg_agg_masked`` — explicit mask, select contract (host-evaluated
  predicates on the fused path);
* ``seg_agg_fused``  — the mask is built from encoded predicate range
  bounds inside the kernel;
* ``seg_agg_batch``  — S signatures' bounds against one value block, one
  pass over the rows, returns (S, num_groups, M);
* ``seg_agg_batch_blocks`` — a whole shared-scan group: the SUM block plus
  the optional MIN/MAX block, one kernel launch each.

Every dispatcher call counts in a module-level probe
(``launch_count``/``reset_launch_count``) so tests can assert the
executor's single-launch property; on CUDA each count is one kernel launch.
"""
from __future__ import annotations

import torch

from . import kernel, ref

_LAUNCHES = {"n": 0}


def launch_count() -> int:
    """Number of seg_agg dispatches since the last reset (test probe)."""
    return _LAUNCHES["n"]


def reset_launch_count() -> None:
    _LAUNCHES["n"] = 0


def _record_launch() -> None:
    _LAUNCHES["n"] += 1


def _on_cuda(*tensors) -> bool:
    """True for CUDA tensors, False for CPU tensors; raises on mixed or
    other devices."""
    dev = tensors[0].device
    for t in tensors[1:]:
        if t.device != dev:
            raise ValueError(f"seg_agg: tensors on {dev} and {t.device}")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"seg_agg: unsupported device {dev}")
    return dev.type == "cuda"


def _f32(t):
    return t.to(torch.float32).contiguous()


def _i32(t):
    return t.to(torch.int32).contiguous()


def _aligned(t):
    """``t``, copied where its data does not start on a 16-byte boundary:
    the kernels stage their row columns with 16-byte copies."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def seg_agg(values, ids, mask, num_groups: int, op: str = "sum"):
    """Grouped aggregation: (N, M) values + (N,) ids -> (num_groups, M)."""
    _record_launch()
    if _on_cuda(values, ids, mask):
        return kernel.seg_agg_cuda(_aligned(_f32(values)), _aligned(_i32(ids)),
                                   _aligned(_f32(mask)), num_groups, op, select=False)
    return ref.seg_agg_ref(values, ids, mask, num_groups, op)


def seg_agg_masked(values, ids, mask, num_groups: int, op: str = "sum"):
    """Grouped aggregation with an explicit row mask, select contract:
    masked-out rows contribute the op identity, so NaNs stay in their own
    group (unlike ``seg_agg``, whose mask-multiply lets masked-out NaNs
    poison their group).  Used when predicates need exact host-side
    evaluation but the aggregation stays one device launch."""
    _record_launch()
    if _on_cuda(values, ids, mask):
        return kernel.seg_agg_cuda(_aligned(_f32(values)), _aligned(_i32(ids)),
                                   _aligned(_f32(mask)), num_groups, op, select=True)
    return ref.seg_agg_masked_ref(values, ids, mask, num_groups, op)


def seg_agg_fused(values, ids, pred_cols, bounds, num_groups: int,
                  op: str = "sum"):
    """Filter-fused grouped aggregation (single launch).

    values (N, M), ids (N,), pred_cols (N, P) f32, bounds (P, K, 2) f32
    inclusive [lo, hi] ranges (OR over K, AND over P) -> (num_groups, M).
    With P == 0 (no predicates) every row qualifies.
    """
    _record_launch()
    if _on_cuda(values, ids, pred_cols, bounds):
        return kernel.seg_agg_fused_cuda(
            _aligned(_f32(values)), _aligned(_i32(ids)), _aligned(_f32(pred_cols)),
            _f32(bounds)[None], num_groups, op)[0]
    return ref.seg_agg_fused_ref(values, ids, pred_cols, bounds, num_groups, op)


def _batch(values, ids, pred_cols, bounds, num_groups, op):
    if _on_cuda(values, ids, pred_cols, bounds):
        return kernel.seg_agg_fused_cuda(_aligned(_f32(values)), _aligned(_i32(ids)),
                                         _aligned(_f32(pred_cols)), _f32(bounds),
                                         num_groups, op)
    return ref.seg_agg_batch_ref(values, ids, pred_cols, bounds, num_groups, op)


def seg_agg_batch(values, ids, pred_cols, bounds, num_groups: int,
                  op: str = "sum"):
    """Shared-scan batched aggregation for S signatures (one launch).

    values (N, M), ids (N,), pred_cols (N, P) over the union of the batch's
    predicate columns, bounds (S, P, K, 2) per-signature ranges ->
    (S, num_groups, M).  Rows are read once; each signature's mask selects
    the rows it adds (masked-out rows reach no group, NaN-safe).
    """
    _record_launch()
    return _batch(values, ids, pred_cols, bounds, num_groups, op)


def seg_agg_batch_blocks(sum_block, mm_block, ids, pred_cols, bounds,
                         num_groups: int):
    """A whole shared-scan group: the SUM/COUNT/AVG block plus the optional
    MIN/MAX block, one launch each (two recorded launches when ``mm_block``
    is given).

    Returns ``(sums (S, G, 1+Ms), mm (S, G, Mm) | None)``; MAX columns are
    pre-negated by the caller so the mm reduce is always a min.
    """
    _record_launch()
    sums = _batch(sum_block, ids, pred_cols, bounds, num_groups, "sum")
    mm = None
    if mm_block is not None:
        _record_launch()
        mm = _batch(mm_block, ids, pred_cols, bounds, num_groups, "min")
    return sums, mm
