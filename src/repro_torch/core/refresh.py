"""Incremental maintenance of cached aggregates (§6.2 refresh as a merge).

The composable-aggregate algebra that powers roll-up (derivations.py) also
makes cached results mergeable across *disjoint row partitions*: for
SUM/COUNT the partition aggregates add, for MIN/MAX they combine, and the
group-by key space of the union is the union of the partitions' key spaces.
So when a delta partition arrives, an affected cached entry can be brought
current by

    refresh(entry) = merge(cached table, aggregate of the delta rows)

costing one scan of the delta instead of a drop-and-recompute over the full
fact table.  The merge is exact — bit-for-bit the same selection results for
MIN/MAX, float-tolerance-identical sums — because grouped aggregation over a
disjoint row union decomposes per group.

Not everything is mergeable.  ``refreshable`` gates the algebra to

* composable measures only (SUM / COUNT / MIN / MAX, no DISTINCT): AVG and
  COUNT DISTINCT lose the information needed to merge (the cached table has
  no separate sum/count, and distinct sets don't add);
* no post-aggregation: HAVING changes group survival and ORDER BY / LIMIT
  change membership, so the cached rows are not the full group space.

Callers fall back to drop-and-recompute for the rest.  NaN semantics follow
the executors: a NaN that reached a cached or delta group value keeps
poisoning that group through the merge, exactly as a full rescan would.

Numpy-only on purpose: cached tables are small aggregates (§2), and the
merge must work on the oracle path without importing PyTorch.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np

from .derivations import _group_inverse, _reaggregate
from .signature import Signature
from .table import ResultTable


def refreshable(sig: Signature) -> bool:
    """True when ``merge_tables`` is exact for this signature: composable
    measures only and no HAVING / ORDER BY / LIMIT."""
    return (sig.all_composable() and not sig.having and not sig.order_by
            and sig.limit is None)


def merge_tables(sig: Signature, base: ResultTable, delta: ResultTable) -> ResultTable:
    """Merge a cached aggregate with the same signature's aggregate over a
    disjoint delta partition.

    Both tables must be in the executor's canonical layout: one column per
    grouping level (decoded values), measures as ``m0..mK`` in signature
    order.  Group keys are unioned via the roll-up machinery
    (``_group_inverse``); appended rows can only add groups, never empty
    existing ones, so the union is the full recompute's group space.
    """
    return merge_partials(sig, (base, delta))


def merge_partials(sig: Signature, tables: Sequence[ResultTable]) -> ResultTable:
    """K-way generalization of :func:`merge_tables`: merge the signature's
    aggregates over any number of disjoint row partitions in one pass.

    This is the partition-parallel scan plane's combiner: each table is the
    fused scan of one fact partition (or streaming chunk), and one composite
    factorization over the concatenated key columns unions the group spaces.
    Because ``_group_inverse`` canonicalizes groups by *sorted value order* —
    independent of which partition contributed them or in what order the
    partials arrive — the merged table is invariant under permutation of
    ``tables``, and its row order matches the unpartitioned fused scan (whose
    dense group ids are also sorted-unique order).
    """
    if not refreshable(sig):
        raise ValueError(
            f"signature is not mergeable (non-composable measures or "
            f"post-aggregation): {sig.canonical_json()}")
    if not tables:
        raise ValueError("merge_partials requires at least one partial table")
    if len(tables) == 1:
        return tables[0]
    if not sig.levels:
        # global aggregate: one row per partial, combine directly
        cols = {}
        for i, m in enumerate(sig.measures):
            acc = np.asarray(tables[0].columns[f"m{i}"], np.float64)
            for t in tables[1:]:
                acc = _combine(m.agg, acc,
                               np.asarray(t.columns[f"m{i}"], np.float64))
            cols[f"m{i}"] = acc
        return ResultTable(cols)
    # partitions that matched no rows contribute no groups
    live = [t for t in tables if t.num_rows > 0]
    if not live:
        return tables[0]
    if len(live) == 1:
        return live[0]
    key_cols = [
        np.concatenate([np.asarray(t.columns[lv]) for t in live])
        for lv in sig.levels
    ]
    n = sum(t.num_rows for t in live)
    inverse, uniques = _group_inverse(key_cols, n)
    n_groups = len(uniques[0])
    out: dict[str, np.ndarray] = {lv: u for lv, u in zip(sig.levels, uniques)}
    for i, m in enumerate(sig.measures):
        vals = np.concatenate([
            np.asarray(t.columns[f"m{i}"], np.float64) for t in live])
        # partition values re-aggregate exactly like roll-up child groups:
        # SUM/COUNT add, MIN/MAX combine NaN-aware
        out[f"m{i}"] = _reaggregate(m.agg, vals, inverse, n_groups)
    return ResultTable(out)


def _combine(agg: str, a: np.ndarray, b: np.ndarray) -> np.ndarray:
    if agg in ("SUM", "COUNT"):
        return a + b
    red = np.minimum if agg == "MIN" else np.maximum
    with np.errstate(invalid="ignore"):  # NaN operands must poison, silently
        out = red(a, b)
    return np.where(np.isnan(a) | np.isnan(b), np.nan, out)
