"""Partition-parallel scan plane: planning and merge algebra glue.

The cache only pays off when misses are survivable — at the paper's 82% hit
rate, one in five dashboard tiles still runs a full fact-table scan.  This
module holds the *pure* half of the partition-parallel miss path that
:class:`repro_torch.olap.executor.OlapExecutor` drives:

* **Chunk planning** — :func:`plan_scan` splits the fact row space into
  ``partitions`` contiguous row-range partitions (scanned concurrently by
  per-partition sub-executors, pinned to distinct CUDA devices when the
  host exposes several, else each on a CUDA stream of its own).  A
  ``max_device_rows`` budget further splits each partition into *streaming
  chunks* scanned sequentially with double-buffered uploads; chunk sizes
  are powers of two so every interior chunk of every partition launches
  the kernels at the same shapes.

* **Signature decomposition** — :func:`decompose` rewrites a signature into
  its partition-*composable* form: SUM/COUNT/MIN/MAX pass through, AVG is
  decomposed into SUM + COUNT(*) partials (finalized as SUM/COUNT after the
  merge, exactly how the executor itself finalizes AVG from its fused count
  column), and post-aggregation (HAVING / ORDER BY / LIMIT) is stripped from
  the partial signature and re-applied to the merged table.  COUNT DISTINCT
  does not decompose — :func:`partition_compatible` gates it back to
  single-partition execution.

* **Finalization** — :func:`finalize_partials` maps the merged partial table
  (produced by :func:`repro_torch.core.refresh.merge_partials`, the k-way
  generalization of the incremental-refresh merge algebra) back to the
  original signature's ``m0..mK`` measure columns.

The correctness contract mirrors the refresh merge: grouped aggregation
over a disjoint row union decomposes per group, so the merged table equals
the unpartitioned fused scan — ``partitions=1`` is kept as the differential
oracle by the executor and the benchmarks.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np

from ..core.signature import Measure, Signature
from ..core.table import ResultTable

# Aggregations the scan plane can split across row partitions.  AVG rides on
# the SUM/COUNT decomposition; COUNT DISTINCT genuinely does not compose
# (distinct sets don't add) and falls back to a single-partition scan.
PARTITIONABLE_AGGS = ("SUM", "COUNT", "MIN", "MAX", "AVG")


# ------------------------------------------------------------- chunk planning


@dataclasses.dataclass(frozen=True)
class ScanPlan:
    """Row-range layout of one partition-parallel scan.

    ``chunks[p]`` is partition ``p``'s ordered list of ``[start, end)`` fact
    row ranges.  Partitions are scanned concurrently; the chunks *within* a
    partition are scanned sequentially (the streaming mode), chunk ``k+1``'s
    columns staged while chunk ``k`` scans.
    """

    n_rows: int
    chunks: tuple[tuple[tuple[int, int], ...], ...]

    @property
    def num_partitions(self) -> int:
        return len(self.chunks)

    @property
    def num_chunks(self) -> int:
        return sum(len(c) for c in self.chunks)

    @property
    def streaming(self) -> bool:
        return any(len(c) > 1 for c in self.chunks)


def _pow2_floor(x: int) -> int:
    return 1 << (int(x).bit_length() - 1) if x >= 1 else 0


def plan_scan(n_rows: int, partitions: int,
              max_device_rows: Optional[int] = None) -> ScanPlan:
    """Split ``[0, n_rows)`` into a :class:`ScanPlan`.

    Partitions are contiguous equal-size row ranges (the last takes the
    remainder; empty trailing partitions are dropped) so same-size partitions
    share kernel launch shapes.  When a partition exceeds ``max_device_rows``
    it is further cut into power-of-two-sized streaming chunks — every
    interior chunk of every partition then has the *same* row count, so the
    whole streamed scan launches at one shape.  Chunks are disjoint and exactly
    cover the row space: ``sum(chunk rows) == n_rows`` (the
    no-double-count-at-chunk-boundaries accounting invariant).
    """
    if partitions < 1:
        raise ValueError(f"partitions must be >= 1, got {partitions}")
    if max_device_rows is not None and max_device_rows < 1:
        raise ValueError(f"max_device_rows must be >= 1, got {max_device_rows}")
    if n_rows <= 0:
        return ScanPlan(n_rows, (((0, n_rows),),) if n_rows == 0 else ())
    q = -(-n_rows // partitions)  # ceil: first partitions equal, last smaller
    ranges = [(s, min(s + q, n_rows)) for s in range(0, n_rows, q)]
    chunk = None
    if max_device_rows is not None and q > max_device_rows:
        chunk = _pow2_floor(max_device_rows)
    parts = []
    for s, e in ranges:
        if chunk is None:
            parts.append(((s, e),))
        else:
            parts.append(tuple((c, min(c + chunk, e))
                               for c in range(s, e, chunk)))
    return ScanPlan(n_rows, tuple(parts))


# ----------------------------------------------------- signature decomposition


def partition_compatible(sig: Signature) -> bool:
    """True when the signature's measures can be computed per row partition
    and merged (HAVING / ORDER BY / LIMIT are fine — they are stripped from
    the partials and applied to the merged table).  COUNT DISTINCT is the one
    aggregate that cannot be split."""
    return all(m.agg in PARTITIONABLE_AGGS and not m.distinct
               for m in sig.measures)


@dataclasses.dataclass(frozen=True)
class PartialPlan:
    """Composable rewrite of one signature for partition-parallel execution.

    ``partial_sig`` carries only SUM/COUNT/MIN/MAX measures and no
    post-aggregation; ``finalize`` maps each *original* measure back to the
    merged partial columns: ``('direct', j)`` reads partial column ``mj``,
    ``('avg', sum_j, count_j)`` divides merged SUM by merged COUNT(*).
    """

    partial_sig: Signature
    finalize: tuple[tuple, ...]


def decompose(sig: Signature) -> PartialPlan:
    if not partition_compatible(sig):
        raise ValueError(
            f"signature is not partitionable (COUNT DISTINCT present): "
            f"{sig.canonical_json()}")
    partial: list[Measure] = []
    index: dict[Measure, int] = {}

    def add(m: Measure) -> int:
        j = index.get(m)
        if j is None:
            j = index[m] = len(partial)
            partial.append(m)
        return j

    finalize: list[tuple] = []
    for m in sig.measures:
        if m.agg == "AVG":
            # the executor finalizes AVG as fused-SUM / COUNT(*); decompose
            # identically so the merged result matches it bit-for-bit
            finalize.append(("avg", add(Measure("SUM", m.expr)),
                             add(Measure("COUNT", "*"))))
        else:
            finalize.append(("direct", add(m)))
    return PartialPlan(
        sig.replace(measures=tuple(partial), having=(), order_by=(),
                    limit=None),
        tuple(finalize))


def finalize_partials(sig: Signature, plan: PartialPlan,
                      merged: ResultTable) -> ResultTable:
    """Assemble the original signature's measure columns from the merged
    partial table (post-aggregation is the caller's tail, exactly as on the
    unpartitioned path)."""
    cols: dict[str, np.ndarray] = {lv: merged.columns[lv] for lv in sig.levels}
    for i, spec in enumerate(plan.finalize):
        if spec[0] == "direct":
            cols[f"m{i}"] = np.asarray(merged.columns[f"m{spec[1]}"],
                                       np.float64)
        else:  # ('avg', sum_j, count_j)
            s = np.asarray(merged.columns[f"m{spec[1]}"], np.float64)
            c = np.asarray(merged.columns[f"m{spec[2]}"], np.float64)
            with np.errstate(invalid="ignore", divide="ignore"):
                cols[f"m{i}"] = np.where(c > 0, s / c, np.nan)
    return ResultTable(cols)


def merge_and_finalize(sig: Signature, plan: PartialPlan,
                       partials: Sequence[ResultTable]) -> ResultTable:
    """Merge per-chunk partial tables and finalize (one factorization pass,
    fold-order independent group space).  Post-aggregation still pending."""
    from ..core.refresh import merge_partials

    return finalize_partials(sig, plan, merge_partials(plan.partial_sig,
                                                       partials))
