"""Plain PyTorch versions of the grouped-aggregation kernels.

``ops`` takes these for tensors on the CPU, and the CUDA kernels in
``csrc/seg_agg.cu`` are held against them on the card.  They keep the NaN
contract of the JAX package's jnp oracle (``repro/kernels/seg_agg/ref.py``):

* ``seg_agg_ref`` multiplies SUM values by the mask, so a NaN in a
  masked-out row still poisons its own group (0 * NaN);
* every other entry point *selects*: masked-out rows take the op identity
  before the reduce, so a NaN reaches a group only through a qualifying row;
* a NaN reaching a group makes that group's SUM, MIN or MAX NaN and leaves
  every other group alone.
"""
from __future__ import annotations

import math

import torch

IDENTITY = {"sum": 0.0, "min": math.inf, "max": -math.inf}
_SCATTER = {"min": "amin", "max": "amax"}


def segment_reduce(values, ids, num_groups: int, op: str):
    """(N, M) f32 values reduced by (N,) group ids into (num_groups, M) f32,
    empty groups holding the op identity: ``index_add_`` for SUM,
    ``scatter_reduce_`` for MIN/MAX (both propagate NaN per group).  SUM
    accumulates in float64 and rounds once: a float32 ``index_add_`` on a
    GPU adds every row of a group into one accumulator, whose error at
    millions of rows per group would swamp the tolerance the kernels are
    held to."""
    if op not in IDENTITY:
        raise ValueError(f"unknown op {op!r}")
    values = values.to(torch.float32)
    idx = ids.to(torch.int64)
    if op == "sum":
        out = torch.zeros((num_groups, values.shape[1]), dtype=torch.float64,
                          device=values.device)
        return out.index_add_(0, idx, values.to(torch.float64)).to(torch.float32)
    out = torch.full((num_groups, values.shape[1]), IDENTITY[op],
                     dtype=torch.float32, device=values.device)
    return out.scatter_reduce_(0, idx[:, None].expand_as(values), values,
                               reduce=_SCATTER[op], include_self=True)


def masked_values(values, mask, op: str):
    """Select contract: rows outside ``mask`` (bool (N,)) take the op
    identity, so they reach no group."""
    values = values.to(torch.float32)
    return torch.where(mask[:, None], values,
                       torch.tensor(IDENTITY[op], dtype=torch.float32,
                                    device=values.device))


def seg_agg_ref(values, ids, mask, num_groups: int, op: str = "sum"):
    """Grouped aggregation oracle.

    values: (N, M) float; ids: (N,) int group ids in [0, num_groups);
    mask: (N,) {0,1} row validity.  Returns (num_groups, M).  Empty groups
    hold the op identity (0 / +inf / -inf); callers use a COUNT column to
    drop them, matching SQL semantics where empty groups are absent.
    """
    values = values.to(torch.float32)
    mask = mask.to(torch.float32)
    if op == "sum":
        return segment_reduce(values * mask[:, None], ids, num_groups, "sum")
    return segment_reduce(masked_values(values, mask > 0.5, op), ids,
                          num_groups, op)


def seg_agg_masked_ref(values, ids, mask, num_groups: int, op: str = "sum"):
    """Explicit-mask aggregation with the select contract (``mask > 0.5``
    qualifies a row)."""
    sel = mask.to(torch.float32) > 0.5
    return segment_reduce(masked_values(values, sel, op), ids, num_groups, op)


def bounds_mask_ref(pred_cols, bounds):
    """Predicate mask from encoded range bounds (the filter-fused oracle).

    pred_cols: (N, P) f32 fact-aligned physical predicate columns;
    bounds: (P, K, 2) f32, a disjunction of K inclusive [lo, hi] ranges per
    predicate.  A row qualifies iff every predicate has some range containing
    its value.  Special ranges:

    * pad (lo=+inf, hi=-inf): never matches;
    * NaN sentinel (lo=hi=NaN): matches exactly the NaN column values;
    * ordinary comparison ranges reject NaN values, matching numpy.
    """
    pred_cols = pred_cols.to(torch.float32)
    if pred_cols.shape[1] == 0:
        return torch.ones(pred_cols.shape[0], dtype=torch.bool,
                          device=pred_cols.device)
    bounds = bounds.to(torch.float32)
    x = pred_cols[:, :, None]  # (N, P, 1)
    lo = bounds[None, :, :, 0]  # (1, P, K)
    hi = bounds[None, :, :, 1]
    within = ((x >= lo) & (x <= hi)) | (torch.isnan(x) & torch.isnan(lo))
    return within.any(dim=-1).all(dim=-1)


def seg_agg_fused_ref(values, ids, pred_cols, bounds, num_groups: int,
                      op: str = "sum"):
    """Filter-fused oracle: build the mask from encoded bounds, then a
    select-contract segment reduce."""
    mask = bounds_mask_ref(pred_cols, bounds)
    return segment_reduce(masked_values(values, mask, op), ids, num_groups, op)


def seg_agg_batch_ref(values, ids, pred_cols, bounds, num_groups: int,
                      op: str = "sum"):
    """S signatures' (S, P, K, 2) bounds against one value block ->
    (S, num_groups, M); each signature is the filter-fused oracle on its
    own bounds."""
    return torch.stack([
        seg_agg_fused_ref(values, ids, pred_cols, bounds[s], num_groups, op)
        for s in range(bounds.shape[0])])
