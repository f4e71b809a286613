"""OLAP backend executor — a device-resident execution engine for intent
signatures over columnar data, on PyTorch.

The counterpart of the JAX package's ``repro/olap/executor.py``:

* **Storage** — ``Dataset.device(device)`` yields a :class:`DeviceDataset`
  that uploads fact columns / FK gathers once per dataset and memoizes every
  derived tensor (measure blocks, predicate stacks, group ids).
* **Plan compiler** — a signature's measures are split into one fused
  ``(N, M)`` SUM/COUNT/AVG block executed by a **single** ``seg_agg`` launch
  (COUNT rides along as a ones column, COUNT(expr) as a finite-indicator
  column, AVG as SUM/COUNT at post-aggregation) plus one fused MIN/MAX block
  (MAX columns are negated so both share a single ``min`` launch).
* **Predicates** — filters and the time window are encoded as per-column
  range bounds ``(P, K, 2)`` (OR over K inclusive [lo, hi] ranges, AND over
  P columns); the CUDA kernel builds the mask per row as it reads it.
  Predicates a float32 compare cannot decide exactly are evaluated on the
  host and passed as an explicit mask.
* **Batch API** — :meth:`OlapExecutor.execute_batch` shares one scan (and a
  single kernel launch per agg block) across signatures that differ only in
  filters/time-window — the dashboard-refresh scenario (§7).

On a CUDA device every ``seg_agg`` call launches a hand-written kernel; on
the CPU it runs the plain PyTorch version.  ``impl='numpy'`` gives a fully
independent numpy oracle; ``fused=False`` keeps the legacy per-measure path
(one seg_agg launch per measure, host-side numpy masks/expressions).
Post-aggregation (HAVING/ORDER BY/LIMIT), group decoding, and COUNT
DISTINCT remain host-side — they touch only the small aggregate, never the
fact table.

* **Delta partition** — ``execute_batch(sigs, partition=(start, end))``
  scans only fact rows [start, end) (the incremental refresh's delta) on a
  fresh sub-executor over a row-slice view of the dataset, on this
  executor's device, sharing its dimension uploads.
* **Scan plane** — ``OlapExecutor(partitions=N, max_device_rows=...)``
  activates the partition-parallel miss path: the fact table is split into
  contiguous row-range partitions (``scan_plane.plan_scan``), each scanned by
  a per-partition sub-executor on a thread pool, and the partial tables are
  merged with the refresh merge algebra (``core.refresh.merge_partials``).
  On one CUDA device each partition launches on a stream of its own (a
  pool of ``partitions`` streams per executor and device); with several
  devices the partitions are pinned to them in turn.  ``max_device_rows``
  adds streaming: partitions larger than the budget are scanned as a
  sequence of pow2-sized chunks, the next chunk's columns staged on another
  stream while the current one scans.  ``partitions=1`` (the default) is
  the unpartitioned oracle the merged tables are differential-tested
  against.

Streams and tensors: ``DeviceDataset.cache`` stores a tensor only after
the stream that produced it has finished, so a tensor found in a mirror's
store is complete for every stream; a streaming chunk's tensors are
released only after its scan's stream has drained.
"""
from __future__ import annotations

import collections
import dataclasses
import threading as _threading
from concurrent.futures import ThreadPoolExecutor, wait
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from ..analysis.sanitizer import make_lock
from ..core import sqlparse as sp
from ..core.derivations import _extreme_at
from ..core.refresh import merge_partials
from ..core.signature import Signature
from ..core.sql_canon import CanonicalizationError, SQLCanonicalizer
from ..core.sqlparse import SQLSyntaxError, UnsupportedQuery
from ..core.table import ResultTable, eval_predicate
from ..kernels.seg_agg.ops import (seg_agg, seg_agg_batch_blocks,
                                   seg_agg_fused, seg_agg_masked)
from ..obs.trace import adopt, child_span, current_ctx
from ..resilience import faults
from . import scan_plane
from .columnar import Dataset, date_to_days, resolve_device

MAX_DENSE_GROUPS = 1 << 20  # dense group-space cap for the segment-reduce path

DEFAULT_MEMO_CAP = 64  # per-executor LRU bound on plan/index memo dicts

_NEVER = (np.inf, -np.inf)  # pad range that matches nothing

_UNSET = object()


def scan_devices(device: torch.device) -> Optional[list]:
    """The CUDA devices a partitioned scan on ``device`` pins its partitions
    to in turn: every card where there are several; None where there is
    one (the partitions run unpinned, each on a stream of its own) or
    ``device`` is the CPU."""
    if device.type == "cuda" and torch.cuda.device_count() > 1:
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return None


class _LRU:
    """Bounded memo dict: get/set bump recency, inserts past ``cap`` evict
    the least-recently-used entry through ``on_evict`` (which drops the
    entry's device-store tensors, so a long-lived executor's device
    footprint is bounded along with the host dicts).  A small lock keeps the
    recency list coherent under concurrent callers."""

    def __init__(self, cap: int,
                 on_evict: Optional[Callable[[object, object], None]] = None):
        self.cap = int(cap)
        self._d: collections.OrderedDict = collections.OrderedDict()  # guarded-by: self._lock
        self._on_evict = on_evict
        self._lock = make_lock("_LRU._lock")

    def get(self, key, default=None):
        with self._lock:
            if key not in self._d:
                return default
            self._d.move_to_end(key)
            return self._d[key]

    def __contains__(self, key) -> bool:
        with self._lock:
            return key in self._d

    def __getitem__(self, key):
        with self._lock:
            v = self._d[key]
            self._d.move_to_end(key)
            return v

    def __setitem__(self, key, value) -> None:
        evicted = []
        with self._lock:
            self._d[key] = value
            self._d.move_to_end(key)
            while len(self._d) > self.cap:
                evicted.append(self._d.popitem(last=False))
        if self._on_evict is not None:
            for k, v in evicted:  # outside the lock: callbacks touch stores
                self._on_evict(k, v)

    def __len__(self) -> int:
        with self._lock:
            return len(self._d)

    def clear(self) -> None:
        with self._lock:
            self._d.clear()


@dataclasses.dataclass
class _LevelPlan:
    name: str  # 'table.column'
    codes: np.ndarray  # compact codes aligned to fact rows
    uniques: np.ndarray  # physical uniques (code -> physical value)
    card: int


@dataclasses.dataclass
class _MeasurePlan:
    """Device-compiled aggregation plan for one measure tuple.

    ``sum_block`` is the fused (N, 1+S) f32 block — column 0 is the hidden
    COUNT(*) ones column; ``minmax_block`` is (N, Mm) with MAX columns
    negated (one ``min`` launch covers both).  ``out_spec`` maps each
    requested measure to its block column: ('count',) | ('sumcol', j) |
    ('avg', j) | ('mincol', j) | ('maxcol', j) | ('distinct', expr).
    """

    sum_block: object
    minmax_block: Optional[object]
    out_spec: list[tuple]
    # device-store keys of the blocks, so LRU eviction of the plan can also
    # release the device tensors it pinned
    sum_key: Optional[tuple] = None
    mm_key: Optional[tuple] = None


def _host(t) -> np.ndarray:
    """Device result -> float64 numpy (the host tail works in float64)."""
    return t.cpu().numpy().astype(np.float64)


class OlapExecutor:
    def __init__(self, dataset: Dataset, impl: str = "auto", fused: bool = True,
                 partitions: int = 1, max_device_rows: Optional[int] = None,
                 memo_cap: int = DEFAULT_MEMO_CAP, device="cuda"):
        """impl: 'auto' (seg_agg dispatch on ``device``: the CUDA kernels on
        a CUDA device, the plain PyTorch versions on the CPU) or 'numpy'
        (independent oracle, touches no device).  ``fused=False`` keeps the
        legacy per-measure host path.  ``device`` defaults to CUDA; asking
        for CUDA where there is none raises.

        ``partitions=N`` activates the partition-parallel scan plane (N
        concurrent row-range scans merged with the refresh algebra);
        ``max_device_rows`` bounds per-scan device residency and turns
        larger partitions into streamed chunk sequences.  ``memo_cap``
        bounds every plan/index memo dict (LRU)."""
        if impl not in ("auto", "numpy"):
            raise ValueError(f"unknown impl {impl!r}: expected 'auto' or 'numpy'")
        if partitions < 1:
            raise ValueError(f"partitions must be >= 1, got {partitions}")
        if memo_cap < 1:
            raise ValueError(f"memo_cap must be >= 1, got {memo_cap}")
        self.ds = dataset
        self.impl = impl
        self.fused = bool(fused) and impl != "numpy"
        self.partitions = int(partitions)
        self.max_device_rows = max_device_rows
        self.device = None if impl == "numpy" else resolve_device(device)
        self._memo_cap = int(memo_cap)
        self._canon = SQLCanonicalizer(dataset.schema)
        self._level_cache: _LRU = _LRU(memo_cap)  # guarded-by: external[_LRU synchronizes internally via _LRU._lock]
        self._gids_cache: _LRU = _LRU(memo_cap, self._evict_gids)  # guarded-by: external[_LRU synchronizes internally via _LRU._lock]
        self._mplans: _LRU = _LRU(memo_cap, self._evict_mplan)  # guarded-by: external[_LRU synchronizes internally via _LRU._lock]
        # per-column predicate probes: idempotent memos (the value is a pure
        # function of the column)
        self._exact_cols: dict[str, bool] = {}
        self._nan_cols: dict[str, bool] = {}
        # version only changes while the tenant's exclusive write gate is
        # held (advance_snapshot), so _sync's clears never race a scan
        self._ds_version = getattr(dataset, "version", 0)  # guarded-by: external[tenant ReadWriteGate.write serializes version changes]
        self.executions = 0  # guarded-by: self._count_lock
        self.rows_scanned = 0  # guarded-by: self._count_lock
        # execute_batch invocations (service miss planner)
        self.batch_calls = 0  # guarded-by: self._count_lock
        # shared-scan groups actually fused across those
        self.batch_groups = 0  # guarded-by: self._count_lock
        # scan-plane invocations
        self.partitioned_scans = 0  # guarded-by: self._count_lock
        # sigs routed to single-partition scan
        self.partition_fallbacks = 0  # guarded-by: self._count_lock
        # chunk scans beyond the first per partition
        self.streaming_chunks = 0  # guarded-by: self._count_lock
        # the cluster miss planner runs shard groups on concurrent threads;
        # bare '+=' on shared counters would drop increments
        self._count_lock = make_lock("OlapExecutor._count_lock")
        # serializes scans on this executor when it acts as a resident
        # per-partition sub (keeps counter deltas attributable per scan)
        self._scan_mutex = make_lock("OlapExecutor._scan_mutex")
        self._subs_lock = make_lock("OlapExecutor._subs_lock")
        self._subs: dict[tuple[int, int], "OlapExecutor"] = {}  # guarded-by: self._subs_lock
        # device -> shared dimcol store dict
        self._dim_pools: dict = {}  # guarded-by: self._subs_lock
        # CUDA device -> (scan streams, staging streams), one of each per
        # partition, created once: the seg_agg kernels keep scratch per
        # (device, stream), so streams made per call would grow it
        self._streams: dict = {}  # guarded-by: self._subs_lock
        self._pool_obj: Optional[ThreadPoolExecutor] = None  # guarded-by: self._subs_lock
        self._plan_cache: Optional[scan_plane.ScanPlan] = None  # guarded-by: self._subs_lock
        self._pstats: list[dict] = []  # guarded-by: self._count_lock
        self._devices = _UNSET

    def _count(self, executions: int = 0, rows_scanned: int = 0,
               batch_calls: int = 0, batch_groups: int = 0) -> None:
        with self._count_lock:
            self.executions += executions
            self.rows_scanned += rows_scanned
            self.batch_calls += batch_calls
            self.batch_groups += batch_groups

    # ------------------------------------------------------- memo LRU bounds
    def _dev_drop(self, *keys) -> None:
        dev = self.ds._device
        if dev is None:
            return
        for k in keys:
            if k is not None:
                dev.drop(k)

    def _evict_gids(self, key, value) -> None:
        self._dev_drop(("gids", key))

    def _evict_mplan(self, key, plan) -> None:
        self._dev_drop(plan.sum_key, plan.mm_key)

    def memo_sizes(self) -> dict[str, int]:
        """Current entry counts of every per-executor memo (all LRU-bounded
        by ``memo_cap`` except the per-column predicate probes, which are
        naturally bounded by the schema's column count)."""
        return {
            "level_plans": len(self._level_cache),
            "gids": len(self._gids_cache),
            "measure_plans": len(self._mplans),
            "pred_exact_cols": len(self._exact_cols),
            "pred_nan_cols": len(self._nan_cols),
        }

    def stats(self) -> dict:
        """Executor counters: totals, memo sizes, the device, and — when
        the scan plane is active — per-partition rows/executions/chunk
        accounting."""
        with self._count_lock:
            return {
                "executions": self.executions,
                "rows_scanned": self.rows_scanned,
                "batch_calls": self.batch_calls,
                "batch_groups": self.batch_groups,
                "partitions": self.partitions,
                "max_device_rows": self.max_device_rows,
                "partitioned_scans": self.partitioned_scans,
                "partition_fallbacks": self.partition_fallbacks,
                "streaming_chunks": self.streaming_chunks,
                "device": None if self.device is None else str(self.device),
                "memo_sizes": self.memo_sizes(),
                "per_partition": [dict(p) for p in self._pstats],
            }

    @property
    def dev(self):
        return self.ds.device(self.device)

    def _put(self, a, dtype=None):
        """Host array -> tensor on this executor's device."""
        t = torch.from_numpy(np.ascontiguousarray(a))
        return t.to(device=self.device, dtype=dtype or t.dtype)

    def _sync(self) -> None:
        """Resynchronize with the dataset after appends: every memoized plan
        (level codes, group ids, measure blocks, predicate exactness/NaN
        probes) is row-aligned or value-dependent, so a version bump
        invalidates all of them.  The device mirror itself was already
        trimmed by ``Dataset.append_rows``."""
        v = getattr(self.ds, "version", 0)
        if v != self._ds_version:
            self._level_cache.clear()
            self._gids_cache.clear()
            self._mplans.clear()
            self._exact_cols.clear()
            self._nan_cols.clear()
            with self._subs_lock:
                # partition layout and row slices are stale; dim pools
                # survive (dimension tables are immutable across appends)
                self._subs.clear()
                self._plan_cache = None
            with self._count_lock:
                self._pstats = []
            self._ds_version = v

    # ------------------------------------------------------------------ api
    def execute(self, sig: Signature) -> ResultTable:
        self._sync()
        if self._scan_active():
            if scan_plane.partition_compatible(sig):
                self._count(executions=1)
                return self._execute_partitioned([sig])[0]
            with self._count_lock:
                self.partition_fallbacks += 1
        self._count(executions=1, rows_scanned=self.ds.fact.num_rows)
        if self.fused:
            return self._execute_fused(sig)
        return self._execute_host(sig)

    def execute_batch(
        self,
        sigs: Sequence[Signature],
        partition: Optional[tuple[int, int]] = None,
    ) -> list[ResultTable]:
        """Shared-scan batched execution (the dashboard-refresh scenario).

        Signatures are grouped by (levels, measures); each group that differs
        only in filters/time-window shares its level codes, group ids, and
        fused measure blocks, and is executed with a **single** ``seg_agg``
        launch per agg block for the whole group (masks for all S signatures
        are built per row from one (S, P, K, 2) bounds tensor against the
        union of predicate columns).  ``rows_scanned`` advances once per
        shared scan, not once per signature.  Results match ``execute`` per
        signature; COUNT DISTINCT, host-mask predicates or singleton groups
        fall back to the single-query path.

        ``partition=(start, end)`` bounds the scan to that fact row range
        (the incremental-refresh delta scan): execution is delegated to a
        sub-executor over a row-slice view of the dataset, on this
        executor's device, so only the delta rows are uploaded and reduced —
        cost proportional to the delta, not the table.
        """
        sigs = list(sigs)
        if not sigs:
            return []
        self._sync()
        if partition is not None:
            sub = self._partition_executor(*partition)
            out = sub.execute_batch(sigs)
            # the sub-executor is fresh: its counters are exactly this call's
            self._count(executions=sub.executions,
                        rows_scanned=sub.rows_scanned,
                        batch_calls=sub.batch_calls,
                        batch_groups=sub.batch_groups)
            return out
        if self._scan_active():
            return self._execute_batch_partitioned(sigs)
        self._count(batch_calls=1)
        out: list[Optional[ResultTable]] = [None] * len(sigs)
        if not self.fused:
            return [self.execute(s) for s in sigs]
        groups: dict[tuple, list[int]] = {}
        for i, s in enumerate(sigs):
            groups.setdefault((s.levels, s.measures), []).append(i)
        for (lvls, measures), idxs in groups.items():
            distinct = any(m.agg == "COUNT_DISTINCT" for m in measures)
            if not distinct:
                # predicates that need exact host masks can't share the
                # encoded-bounds scan; run those signatures individually
                exact = [i for i in idxs if self._sig_ranges(sigs[i]) is not None]
            else:
                exact = []
            for i in idxs:
                if i not in exact:
                    out[i] = self.execute(sigs[i])
            idxs = exact
            if len(idxs) == 1:
                out[idxs[0]] = self.execute(sigs[idxs[0]])
                continue
            if not idxs:
                continue
            self._count(batch_groups=1, executions=len(idxs),
                        rows_scanned=self.ds.fact.num_rows)  # one shared scan
            levels = [self._level_plan(lv) for lv in lvls]
            gids_np, n_groups, sparse_uniq = self._group_ids(levels)
            gids_dev = self._device_gids(lvls, gids_np)
            plan = self._measure_plan(measures)
            group_sigs = [sigs[i] for i in idxs]
            pred_block, bounds = self._batch_predicates(group_sigs)
            sums_dev, mms_dev = seg_agg_batch_blocks(
                plan.sum_block, plan.minmax_block, gids_dev, pred_block,
                self._put(bounds), n_groups)
            sums = _host(sums_dev)  # (S, G, 1+Ms)
            mms = None if mms_dev is None else _host(mms_dev)
            for s_i, i in enumerate(idxs):
                out[i] = self._finalize(
                    sigs[i], levels, plan, sums[s_i],
                    None if mms is None else mms[s_i],
                    gids_np, n_groups, sparse_uniq)
        return out  # type: ignore[return-value]

    def _partition_executor(self, start: int, end: int) -> "OlapExecutor":
        """Fresh executor over fact rows [start, end), on this executor's
        device.  Each delta partition is scanned once per refresh, so the
        executor itself is not memoized — the tick shares the parent
        mirror's dimension uploads and uploads only delta-sized fact
        columns."""
        sub = OlapExecutor(self.ds.slice_rows(start, end), impl=self.impl,
                           fused=self.fused, device=self.device)
        mirror = self.ds._device
        if self.fused and mirror is not None and mirror.device == sub.device:
            sub.dev.share_dim_arrays(mirror)
        return sub

    # ------------------------------------------------ partition-parallel scan
    def _scan_active(self) -> bool:
        """True when the scan plane handles full-table scans: multiple
        partitions requested, or the table exceeds the per-scan device-row
        budget (streaming).  Sub-executors are built with ``partitions=1``
        and no budget, so they never re-enter this path."""
        n = self.ds.fact.num_rows
        if n <= 0:
            return False
        if self.partitions > 1:
            return True
        return self.max_device_rows is not None and n > self.max_device_rows

    def _scan_plan(self) -> scan_plane.ScanPlan:
        with self._subs_lock:
            plan = self._plan_cache
            if plan is None:
                plan = scan_plane.plan_scan(
                    self.ds.fact.num_rows, self.partitions,
                    self.max_device_rows)
                self._plan_cache = plan
                with self._count_lock:
                    self._pstats = [
                        {"start": c[0][0], "end": c[-1][1], "rows_scanned": 0,
                         "executions": 0, "batch_groups": 0, "chunks": 0}
                        for c in plan.chunks]
            return plan

    def _scan_devices(self):
        """CUDA devices for partition pinning (``scan_devices``) on the
        fused path; None elsewhere."""
        if self._devices is _UNSET:
            self._devices = scan_devices(self.device) if self.fused else None
        return self._devices

    def _pool(self) -> ThreadPoolExecutor:
        with self._subs_lock:
            if self._pool_obj is None:
                self._pool_obj = ThreadPoolExecutor(
                    max_workers=self.partitions,
                    thread_name_prefix="scan-part")
            return self._pool_obj

    def _partition_streams(self, device: torch.device, p: int):
        """Partition ``p``'s (scan stream, staging stream) on ``device``:
        bound to the partition, not to the pool thread that runs it, so a
        resident sub's tensors are always used on the stream that made
        them."""
        with self._subs_lock:
            pair = self._streams.get(device)
            if pair is None:
                pair = self._streams[device] = tuple(
                    [torch.cuda.Stream(device) for _ in range(self.partitions)]
                    for _ in range(2))
        return pair[0][p % self.partitions], pair[1][p % self.partitions]

    def _execute_batch_partitioned(self, sigs: list) -> list:
        """Batch entry of the scan plane: partition-compatible signatures go
        through one partitioned scan (sharing per-partition scans exactly as
        the plain batch shares the full-table scan), the rest fall back to
        single-partition execution."""
        self._count(batch_calls=1)
        out: list[Optional[ResultTable]] = [None] * len(sigs)
        par = [i for i, s in enumerate(sigs)
               if scan_plane.partition_compatible(s)]
        rest = [i for i in range(len(sigs)) if i not in set(par)]
        if rest:
            with self._count_lock:
                self.partition_fallbacks += len(rest)
            for i in rest:
                self._count(executions=1,
                            rows_scanned=self.ds.fact.num_rows)
                out[i] = (self._execute_fused(sigs[i]) if self.fused
                          else self._execute_host(sigs[i]))
        if par:
            self._count(executions=len(par))
            for i, t in zip(par, self._execute_partitioned(
                    [sigs[i] for i in par])):
                out[i] = t
        return out  # type: ignore[return-value]

    def _execute_partitioned(self, sigs: list) -> list[ResultTable]:
        """Partition-parallel fused scan: decompose each signature into its
        composable partial form, scan every partition concurrently (streaming
        chunks sequentially inside each partition), merge the per-partition
        partial tables with the refresh algebra, finalize AVG from merged
        SUM/COUNT, and apply post-aggregation on the merged result.  Every
        partition job is waited for before an error is raised, so no scan of
        a failed batch is still running when the caller retries it."""
        plan = self._scan_plan()
        pplans = [scan_plane.decompose(s) for s in sigs]
        psigs = [p.partial_sig for p in pplans]
        with self._count_lock:
            self.partitioned_scans += 1
        devices = self._scan_devices()
        # capture the submitting thread's trace context so each partition
        # worker's span hangs off the request's execute span (obs plane);
        # None when the request is unsampled — adopt() is then a no-op
        obs_ctx = current_ctx()
        jobs = [
            self._pool().submit(
                self._scan_partition, p, chunks, psigs,
                devices[p % len(devices)] if devices else None, obs_ctx)
            for p, chunks in enumerate(plan.chunks)]
        wait(jobs)
        partials = [j.result() for j in jobs]  # [partition][sig] tables
        out = []
        for i, (sig, pplan) in enumerate(zip(sigs, pplans)):
            merged = merge_partials(
                pplan.partial_sig, [part[i] for part in partials])
            out.append(self._post_aggregate(
                sig, scan_plane.finalize_partials(sig, pplan, merged)))
        return out

    def _scan_partition(self, p: int, chunks, psigs, dev,
                        obs_ctx=None) -> list[ResultTable]:
        """One partition job: scan its chunks in order, pre-merging the
        per-chunk partial tables (merge is associative and fold-order
        independent, so two-level partition-then-global merging is exact).
        ``dev`` pins the partition's uploads and launches to one of several
        CUDA devices (None: this executor's device).  On a CUDA device the
        job runs under the partition's own stream; on the CPU the plain
        versions run in the pool thread."""
        with adopt(obs_ctx), child_span(
                "execute.partition",
                attrs={"partition": p, "chunks": len(chunks),
                       "sigs": len(psigs)}):
            # chaos: one partition worker fails while its siblings succeed —
            # the whole batch must error (a merge over missing partials would
            # be a silent wrong answer), and the caller's retry machinery
            # re-runs it
            faults.fire("backend.partial")
            target = dev or self.device
            if target is None or target.type != "cuda":
                return self._scan_chunks(p, chunks, psigs, dev, None)
            scan, stage = self._partition_streams(target, p)
            with torch.cuda.device(target), torch.cuda.stream(scan):
                return self._scan_chunks(p, chunks, psigs, dev, stage)

    def _scan_chunks(self, p: int, chunks, psigs, dev,
                     stage_stream) -> list[ResultTable]:
        streaming = len(chunks) > 1
        per_sig: list[list[ResultTable]] = [[] for _ in psigs]
        sub = self._chunk_sub(chunks[0], dev, resident=not streaming)
        for k in range(len(chunks)):
            stager = None
            next_sub = None
            if k + 1 < len(chunks):
                # double buffer: stage chunk k+1's device tensors while
                # chunk k scans
                next_sub = self._chunk_sub(chunks[k + 1], dev, resident=False)
                stager = _Stager(self._prestage, next_sub, psigs, stage_stream)
                stager.start()
            try:
                with sub._scan_mutex:
                    before = (sub.executions, sub.rows_scanned, sub.batch_groups)
                    tables = sub.execute_batch(psigs)
                    delta = (sub.executions - before[0],
                             sub.rows_scanned - before[1],
                             sub.batch_groups - before[2])
                for i, t in enumerate(tables):
                    per_sig[i].append(t)
                self._note_partition(p, rows=delta[1], executions=delta[0],
                                     groups=delta[2], chunk_no=k)
                if streaming:
                    self._release_chunk(sub)
            finally:
                if stager is not None:
                    stager.join()
            if stager is not None:
                stager.raise_error()
            if next_sub is not None:
                sub = next_sub
        return [tl[0] if len(tl) == 1 else merge_partials(ps, tl)
                for ps, tl in zip(psigs, per_sig)]

    def _chunk_sub(self, rng: tuple[int, int], dev,
                   resident: bool) -> "OlapExecutor":
        """Sub-executor over fact rows [start, end), on ``dev`` (None: this
        executor's device).  Non-streaming partitions keep a resident sub
        (its memos and device tensors are the warm-scan fast path);
        streaming chunks get ephemeral subs whose device tensors are
        released after the scan.  Dimension uploads are shared through a
        per-device pool — dims never cross devices, but within a device every
        chunk of every partition reuses one upload."""
        if resident:
            with self._subs_lock:
                hit = self._subs.get(rng)
            if hit is not None:
                return hit
        sub = OlapExecutor(self.ds.slice_rows(*rng), impl=self.impl,
                           fused=self.fused, memo_cap=self._memo_cap,
                           device=dev or self.device)
        if self.fused:
            self._share_dims(sub, dev)
        if resident:
            with self._subs_lock:
                sub = self._subs.setdefault(rng, sub)
        return sub

    def _share_dims(self, sub: "OlapExecutor", dev) -> None:
        with self._subs_lock:
            pool = self._dim_pools.get(dev)
            if pool is None:
                # unpinned scans can share the parent mirror's live dimcol
                # store; pinned devices each get their own (tensors must not
                # cross devices)
                pool = self.dev._dim_store if dev is None else {}
                self._dim_pools[dev] = pool
        mirror = sub.dev
        for k, v in mirror._dim_store.items():
            pool.setdefault(k, v)
        mirror._dim_store = pool

    def _release_chunk(self, sub: "OlapExecutor") -> None:
        """Drop an ephemeral streaming chunk's device tensors (its share of
        the dim pool survives — the pool dict is aliased, not owned).  The
        chunk's kernels ran on this thread's current stream, which is
        drained first: the allocator may then hand the memory to a new
        tensor on any stream without a kernel still reading it."""
        mirror = sub.ds._device
        if mirror is not None:
            if mirror.device.type == "cuda":
                torch.cuda.current_stream(mirror.device).synchronize()
            mirror._store.clear()
        sub.ds._device = None

    def _note_partition(self, p: int, rows: int, executions: int,
                        groups: int, chunk_no: int) -> None:
        with self._count_lock:
            self.rows_scanned += rows
            if chunk_no > 0:
                self.streaming_chunks += 1
            if p < len(self._pstats):
                st = self._pstats[p]
                st["rows_scanned"] += rows
                st["executions"] += executions
                st["batch_groups"] += groups
                st["chunks"] += 1

    def _prestage(self, sub: "OlapExecutor", psigs, stream) -> None:
        """Stager thread body: force the next chunk's fact-column uploads
        (level alignments, measure expressions, predicate columns) while the
        current chunk scans, on ``stream`` (the partition's staging stream,
        so they overlap the scan; None on the CPU).  ``DeviceDataset.cache``
        finishes each upload before storing it, so the scan reads complete
        tensors whatever its stream.  An error is kept and raised in the
        scanning thread (``_Stager.raise_error``)."""
        if stream is None:
            self._stage_arrays(sub, psigs)
            return
        with torch.cuda.device(stream.device), torch.cuda.stream(stream):
            self._stage_arrays(sub, psigs)

    def _stage_arrays(self, sub: "OlapExecutor", psigs) -> None:
        if not sub.fused:
            return
        mirror = sub.dev
        n = sub.ds.fact.num_rows
        mirror.cache(("ones",), lambda: np.ones(n, np.float32))
        date_col = sub.ds.schema.fact.date_column
        for s in psigs:
            for lv in s.levels:
                mirror.fact_aligned(lv)
            for m in s.measures:
                if m.expr != "*":
                    sub._dev_expr(m.expr)
            for f in s.filters:
                mirror.fact_aligned_f32(f.col)
            if s.time_window is not None and date_col is not None:
                mirror.fact_aligned_f32(f"{sub.ds.fact.name}.{date_col}")

    def execute_raw(self, sql: str) -> Optional[ResultTable]:
        """Bypass path: out-of-scope requests run directly on the backend.
        We execute what we can canonicalize; genuinely out-of-scope SQL is
        acknowledged (None) — its cost is still a backend execution."""
        try:
            sig = self._canon.canonicalize(sql)
        except (UnsupportedQuery, SQLSyntaxError, CanonicalizationError):
            self._count(executions=1, rows_scanned=self.ds.fact.num_rows)
            return None
        return self.execute(sig)

    # ------------------------------------------------------- fused (device)
    def _execute_fused(self, sig: Signature) -> ResultTable:
        levels = [self._level_plan(lv) for lv in sig.levels]
        gids_np, n_groups, sparse_uniq = self._group_ids(levels)
        gids_dev = self._device_gids(sig.levels, gids_np)
        plan = self._measure_plan(sig.measures)
        enc = self._predicate_plan(sig)
        if enc is None:
            # some predicate can't be evaluated exactly in f32: build the
            # mask on host (exact, oracle-identical) and keep the fused
            # single-launch device aggregation
            mask = self._put(self._filter_mask(sig), torch.float32)
            sums = _host(seg_agg_masked(plan.sum_block, gids_dev, mask,
                                        n_groups, "sum"))
            mm = None
            if plan.minmax_block is not None:
                mm = _host(seg_agg_masked(plan.minmax_block, gids_dev, mask,
                                          n_groups, "min"))
        else:
            pred_block, bounds = enc
            bounds = self._put(bounds)
            sums = _host(seg_agg_fused(plan.sum_block, gids_dev, pred_block,
                                       bounds, n_groups, "sum"))
            mm = None
            if plan.minmax_block is not None:
                mm = _host(seg_agg_fused(plan.minmax_block, gids_dev,
                                         pred_block, bounds, n_groups, "min"))
        return self._finalize(sig, levels, plan, sums, mm, gids_np, n_groups,
                              sparse_uniq)

    def _finalize(self, sig, levels, plan, sums, mm, gids_np, n_groups,
                  sparse_uniq) -> ResultTable:
        """Assemble measures from the fused blocks and apply the shared
        host-side tail (empty-group drop, decode, HAVING/ORDER/LIMIT)."""
        count_col = sums[:, 0]
        host_mask = None  # built at most once, shared by all distinct specs
        out_measures: list[np.ndarray] = []
        for spec in plan.out_spec:
            kind = spec[0]
            if kind == "count":
                out_measures.append(count_col.copy())
            elif kind == "sumcol":
                out_measures.append(sums[:, spec[1]])
            elif kind == "avg":
                with np.errstate(invalid="ignore", divide="ignore"):
                    out_measures.append(
                        np.where(count_col > 0, sums[:, spec[1]] / count_col, np.nan))
            elif kind == "mincol":
                out_measures.append(mm[:, spec[1]])
            elif kind == "maxcol":
                out_measures.append(-mm[:, spec[1]])
            else:  # ('distinct', expr): host-side exact, rare
                if host_mask is None:
                    host_mask = self._filter_mask(sig)
                out_measures.append(self._count_distinct(
                    self._expr_values(spec[1]), gids_np, host_mask, n_groups))
        return self._build_result(sig, levels, count_col, out_measures, sparse_uniq)

    def _build_result(self, sig, levels, count_col, out_measures,
                      sparse_uniq) -> ResultTable:
        """Shared result tail for the fused and host paths: drop empty groups
        (SQL semantics: they are absent; global aggregates keep their single
        row), decode surviving group ids, then HAVING/ORDER/LIMIT."""
        keep = count_col > 0
        if not sig.levels:
            keep = np.ones(1, dtype=bool)
        cols: dict[str, np.ndarray] = {}
        if levels:
            group_idx = np.nonzero(keep)[0]
            decoded = self._decode_groups(levels, group_idx, sparse_uniq)
            for lv, vals in zip(levels, decoded):
                cols[lv.name] = vals
        for i, mvals in enumerate(out_measures):
            cols[f"m{i}"] = mvals[keep] if sig.levels else mvals
        return self._post_aggregate(sig, ResultTable(cols))

    def _device_gids(self, levels_key: tuple, gids_np: np.ndarray):
        return self.dev.cache(("gids", levels_key), lambda: gids_np)

    def _measure_plan(self, measures: tuple) -> _MeasurePlan:
        plan = self._mplans.get(measures)
        if plan is not None:
            return plan
        n = self.ds.fact.num_rows
        ones = self.dev.cache(("ones",), lambda: np.ones(n, np.float32))
        sum_cols = [ones]
        sum_keys: list[tuple] = [("ones",)]
        mm_cols: list = []
        mm_keys: list[tuple] = []
        out_spec: list[tuple] = []
        for m in measures:
            if m.agg == "COUNT_DISTINCT":
                out_spec.append(("distinct", m.expr))
            elif m.agg == "COUNT":
                if m.expr == "*":
                    out_spec.append(("count",))
                else:
                    out_spec.append(("sumcol", len(sum_cols)))
                    sum_keys.append(("finite", m.expr))
                    sum_cols.append(self.dev.cache(
                        ("finite", m.expr),
                        lambda e=m.expr: torch.isfinite(self._dev_expr(e)).to(torch.float32)))
            elif m.agg in ("SUM", "AVG"):
                out_spec.append(("sumcol" if m.agg == "SUM" else "avg", len(sum_cols)))
                sum_keys.append(("expr", m.expr))
                sum_cols.append(self._dev_expr(m.expr))
            elif m.agg == "MIN":
                out_spec.append(("mincol", len(mm_cols)))
                mm_keys.append(("expr", m.expr))
                mm_cols.append(self._dev_expr(m.expr))
            else:  # MAX: negate so MIN and MAX share one 'min' launch
                out_spec.append(("maxcol", len(mm_cols)))
                mm_keys.append(("negexpr", m.expr))
                mm_cols.append(self.dev.cache(
                    ("negexpr", m.expr), lambda e=m.expr: -self._dev_expr(e)))
        sum_key = ("sumblock", tuple(sum_keys))
        sum_block = self.dev.cache(sum_key, lambda: torch.stack(sum_cols, dim=1))
        mm_block, mm_key = None, None
        if mm_cols:
            mm_key = ("mmblock", tuple(mm_keys))
            mm_block = self.dev.cache(
                mm_key, lambda: torch.stack(mm_cols, dim=1))
        plan = _MeasurePlan(sum_block, mm_block, out_spec, sum_key, mm_key)
        self._mplans[measures] = plan
        return plan

    def _dev_expr(self, expr: str):
        """Measure expression evaluated on-device (f32) from uploaded base
        columns, memoized per canonical expression string."""

        def build():
            ast = sp.parse_expr(expr)

            def ev(e):
                if isinstance(e, sp.ColRef):
                    q = f"{e.table}.{e.column}" if e.table else e.column
                    return self.dev.fact_aligned_f32(q)
                if isinstance(e, sp.Literal):
                    return float(e.value)
                if isinstance(e, sp.BinOp):
                    left, right = ev(e.left), ev(e.right)
                    if e.op == "+":
                        return left + right
                    if e.op == "-":
                        return left - right
                    if e.op == "*":
                        return left * right
                    return left / right
                raise ValueError(f"unexpected node in measure expression: {e}")

            v = ev(ast)
            if np.isscalar(v):
                return np.full(self.ds.fact.num_rows, v, dtype=np.float32)
            return v.to(torch.float32)

        return self.dev.cache(("expr", expr), build)

    # ----------------------------------------------------- predicate encode
    def _f32_exact_col(self, qualified: str) -> bool:
        """True when every physical value of the column round-trips through
        f32 exactly (dictionary codes and date-days always do; int/float
        columns are checked once and cached).  Predicates over inexact
        columns fall back to the host-evaluated mask — the encoded-bounds
        comparison runs in f32 on device and must never diverge from the
        oracle's exact comparisons."""
        hit = self._exact_cols.get(qualified)
        if hit is None:
            data = self.ds.column(qualified).data
            if data.dtype.kind in "iu":
                hit = bool(np.all(np.abs(data) <= (1 << 24)))
            else:
                v32 = data.astype(np.float32).astype(data.dtype)
                hit = bool(np.all(v32 == data))  # NaN present -> inexact
            self._exact_cols[qualified] = hit
        return hit

    @staticmethod
    def _f32_exact_value(v: float) -> bool:
        return bool(np.isfinite(v)) and float(np.float32(v)) == float(v)

    def _filter_ranges(self, f) -> Optional[list[tuple[float, float]]]:
        """Encode one filter as a disjunction of inclusive f32 [lo, hi]
        ranges over the column's physical domain (str -> dictionary code,
        date -> days).  Open endpoints use f32 nextafter, which is exact
        because both column values and literals are gated to the f32 lattice
        — None when the column or a literal is not exactly representable
        (caller falls back to the host mask)."""
        if not self._f32_exact_col(f.col):
            return None
        col = self.ds.column(f.col)

        def enc(v) -> Optional[float]:
            pv = float(col.encode_value(v))
            return pv if self._f32_exact_value(pv) else None

        def down(v: float) -> float:
            return float(np.nextafter(np.float32(v), np.float32(-np.inf)))

        def up(v: float) -> float:
            return float(np.nextafter(np.float32(v), np.float32(np.inf)))

        if f.op == "in":
            vals = f.val if isinstance(f.val, (list, tuple)) else [f.val]
            encs = [enc(v) for v in vals]
            if any(e is None for e in encs):
                return None
            return [(e, e) for e in encs]
        v = enc(f.val)
        if v is None:
            return None
        if f.op == "=":
            return [(v, v)]
        if f.op == "!=":
            # NaN sentinel range: numpy semantics keep NaN rows (NaN != v)
            return [(-np.inf, down(v)), (up(v), np.inf), (np.nan, np.nan)]
        if f.op == "<":
            return [(-np.inf, down(v))]
        if f.op == "<=":
            return [(-np.inf, v)]
        if f.op == ">":
            return [(up(v), np.inf)]
        return [(v, np.inf)]  # >=

    def _window_range(self, tw) -> Optional[tuple[str, tuple[float, float]]]:
        date_col = self.ds.schema.fact.date_column
        if date_col is None:
            return None
        qualified = f"{self.ds.fact.name}.{date_col}"
        # [start, end) on int days -> inclusive [start, end-1]
        return qualified, (float(date_to_days(tw.start)),
                           float(date_to_days(tw.end) - 1))

    def _sig_ranges(self, sig: Signature) -> Optional[list[tuple[str, list]]]:
        """Per-predicate (column, ranges) pairs for one signature; None when
        any predicate can't be encoded exactly in f32 (the caller evaluates
        the mask on host instead)."""
        out = []
        for f in sig.filters:
            r = self._filter_ranges(f)
            if r is None:
                return None
            out.append((f.col, r))
        if sig.time_window is not None:
            wr = self._window_range(sig.time_window)
            if wr is not None:
                out.append((wr[0], [wr[1]]))
        return out

    def _accept_all(self, qualified: str) -> list[tuple[float, float]]:
        """Range disjunction matching every row of a column (batch filler
        for signatures that don't constrain it)."""
        hit = self._nan_cols.get(qualified)
        if hit is None:
            data = self.ds.column(qualified).data
            hit = bool(data.dtype.kind == "f" and np.isnan(data).any())
            self._nan_cols[qualified] = hit
        if hit:
            return [(-np.inf, np.inf), (np.nan, np.nan)]
        return [(-np.inf, np.inf)]

    def _pred_block(self, cols: tuple):
        n = self.ds.fact.num_rows
        if not cols:
            return self.dev.cache(
                ("preds", ()), lambda: np.zeros((n, 0), np.float32))
        return self.dev.cache(
            ("preds", cols),
            lambda: torch.stack([self.dev.fact_aligned_f32(c) for c in cols], dim=1))

    def _predicate_plan(self, sig: Signature):
        """Device predicate-column stack (cached per column tuple) plus this
        query's (P, K, 2) host bounds (tiny, encoded per query); None when
        the predicates need exact host evaluation."""
        pairs = self._sig_ranges(sig)
        if pairs is None:
            return None
        cols = tuple(c for c, _ in pairs)
        return self._pred_block(cols), _pack_bounds([r for _, r in pairs])

    def _batch_predicates(self, sigs: list[Signature]):
        """Union predicate columns across the batch; per-signature bounds
        with multiple predicates on one column intersected into a single
        range disjunction, unconstrained columns spanning everything."""
        per_sig: list[dict[str, list]] = []
        union: list[str] = []
        for s in sigs:
            d: dict[str, list] = {}
            for col, ranges in self._sig_ranges(s):
                d[col] = _intersect_ranges(d[col], ranges) if col in d else ranges
                if col not in union:
                    union.append(col)
            per_sig.append(d)
        cols = tuple(union)
        if not cols:
            # no predicates anywhere: one always-true pseudo-predicate over a
            # zeros column (zeros are never NaN, a plain full range suffices)
            bounds = np.empty((len(sigs), 1, 1, 2), np.float32)
            bounds[..., 0], bounds[..., 1] = -np.inf, np.inf
            block = self.dev.cache(
                ("preds", ("__zeros__",)),
                lambda: np.zeros((self.ds.fact.num_rows, 1), np.float32))
            return block, bounds
        # a column some other signature filters must accept *every* row here:
        # full range, plus the NaN sentinel only when the column can actually
        # hold NaNs
        packed = [_pack_bounds([d.get(c, self._accept_all(c)) for c in cols])
                  for d in per_sig]
        k = max(b.shape[1] for b in packed)
        bounds = np.empty((len(sigs), len(cols), k, 2), np.float32)
        bounds[..., 0], bounds[..., 1] = _NEVER
        for s_i, b in enumerate(packed):
            bounds[s_i, :, : b.shape[1]] = b
        return self._pred_block(cols), bounds

    # ------------------------------------------------- legacy host baseline
    def _execute_host(self, sig: Signature) -> ResultTable:
        """Seed per-measure path: host numpy masks/expressions, one seg_agg
        launch per measure (plus the COUNT column).  ``impl='numpy'`` makes
        this the independent oracle."""
        n = self.ds.fact.num_rows
        mask = self._filter_mask(sig)
        levels = [self._level_plan(lv) for lv in sig.levels]
        gids, n_groups, sparse_uniq = self._group_ids(levels)

        count_col = self._aggregate(np.ones((n, 1), np.float32), gids, mask, n_groups, "sum")[:, 0]
        out_measures: list[np.ndarray] = []
        for m in sig.measures:
            if m.agg == "COUNT" and not m.distinct:
                if m.expr == "*":
                    out_measures.append(count_col.copy())
                else:
                    vals = np.isfinite(self._expr_values(m.expr)).astype(np.float32)
                    out_measures.append(
                        self._aggregate(vals[:, None], gids, mask, n_groups, "sum")[:, 0]
                    )
                continue
            if m.distinct:  # COUNT(DISTINCT expr): host-side exact
                out_measures.append(
                    self._count_distinct(self._expr_values(m.expr), gids, mask, n_groups)
                )
                continue
            vals = self._expr_values(m.expr).astype(np.float32)
            if m.agg == "AVG":
                s = self._aggregate(vals[:, None], gids, mask, n_groups, "sum")[:, 0]
                with np.errstate(invalid="ignore", divide="ignore"):
                    out_measures.append(np.where(count_col > 0, s / count_col, np.nan))
            elif m.agg == "SUM":
                out_measures.append(
                    self._aggregate(vals[:, None], gids, mask, n_groups, "sum")[:, 0].astype(np.float64)
                )
            else:  # MIN / MAX
                out_measures.append(
                    self._aggregate(vals[:, None], gids, mask, n_groups, m.agg.lower())[:, 0]
                )

        return self._build_result(sig, levels, count_col, out_measures, sparse_uniq)

    # ------------------------------------------------------------ internals
    def _aggregate(self, values, gids, mask, n_groups, op):
        if self.impl == "numpy":
            return _np_segment(values, gids, mask, n_groups, op)
        out = seg_agg(self._put(values, torch.float32), self._put(gids),
                      self._put(mask, torch.float32), n_groups, op)
        return out.cpu().numpy()

    def _filter_mask(self, sig: Signature) -> np.ndarray:
        n = self.ds.fact.num_rows
        mask = np.ones(n, dtype=bool)
        for f in sig.filters:
            col = self.ds.column(f.col)
            vals = self.ds.fact_aligned(f.col)
            if f.op == "in":
                phys = [col.encode_value(v) for v in (f.val if isinstance(f.val, (list, tuple)) else [f.val])]
                mask &= np.isin(vals, phys)
                continue
            pv = col.encode_value(f.val)
            if f.op == "=":
                mask &= vals == pv
            elif f.op == "!=":
                mask &= vals != pv
            elif f.op == "<":
                mask &= vals < pv
            elif f.op == "<=":
                mask &= vals <= pv
            elif f.op == ">":
                mask &= vals > pv
            elif f.op == ">=":
                mask &= vals >= pv
        tw = sig.time_window
        if tw is not None:
            date_col = self.ds.schema.fact.date_column
            if date_col is not None:
                days = self.ds.fact.columns[date_col].data
                mask &= (days >= date_to_days(tw.start)) & (days < date_to_days(tw.end))
        return mask

    def _level_plan(self, level: str) -> _LevelPlan:
        lp = self._level_cache.get(level)
        if lp is not None:
            return lp
        aligned = self.ds.fact_aligned(level)
        t, c = level.split(".", 1)
        table_col = self.ds.table(t).columns[c]
        uniques = np.unique(table_col.data)
        codes = np.searchsorted(uniques, aligned).astype(np.int32)
        lp = _LevelPlan(level, codes, uniques, len(uniques))
        self._level_cache[level] = lp
        return lp

    def _group_ids(self, levels: list[_LevelPlan]) -> tuple[np.ndarray, int, Optional[np.ndarray]]:
        """Dense (or compacted-sparse) group ids for a level combination.

        Returns ``(gids, n_groups, sparse_uniq)`` — ``sparse_uniq`` is the
        observed-group compaction table (None on the dense path) and is
        threaded through to ``_decode_groups`` by the caller.  Memoized per
        level combination: the mapping depends only on the dataset, not on
        the query's filters.
        """
        n = self.ds.fact.num_rows
        if not levels:
            return np.zeros(n, dtype=np.int32), 1, None
        cache_key = tuple(lp.name for lp in levels)
        hit = self._gids_cache.get(cache_key)
        if hit is not None:
            return hit
        g = 1
        gids = np.zeros(n, dtype=np.int64)
        for lp in levels:
            gids = gids * lp.card + lp.codes
            g *= lp.card
        if g > MAX_DENSE_GROUPS:
            # compact the observed group space (rare for dashboard queries)
            uniq, gids = np.unique(gids, return_inverse=True)
            result = (gids.astype(np.int32), len(uniq), uniq)
        else:
            result = (gids.astype(np.int32), g, None)
        self._gids_cache[cache_key] = result
        return result

    def _decode_groups(self, levels: list[_LevelPlan], group_idx: np.ndarray,
                       sparse_uniq: Optional[np.ndarray] = None):
        """Map surviving dense group ids back to per-level decoded values."""
        if sparse_uniq is not None:
            group_idx = sparse_uniq[group_idx]
        out = []
        rem = group_idx.astype(np.int64)
        cards = [lp.card for lp in levels]
        comps: list[np.ndarray] = []
        for card in reversed(cards):
            comps.append(rem % card)
            rem = rem // card
        comps.reverse()
        for lp, comp in zip(levels, comps):
            t, c = lp.name.split(".", 1)
            col = self.ds.table(t).columns[c]
            out.append(col.decode(lp.uniques[comp]))
        return out

    def _expr_values(self, expr: str) -> np.ndarray:
        ast = sp.parse_expr(expr)

        def ev(e) -> np.ndarray | float:
            if isinstance(e, sp.ColRef):
                q = f"{e.table}.{e.column}" if e.table else e.column
                return self.ds.fact_aligned(q).astype(np.float64)
            if isinstance(e, sp.Literal):
                return float(e.value)
            if isinstance(e, sp.BinOp):
                l, r = ev(e.left), ev(e.right)
                if e.op == "+":
                    return l + r
                if e.op == "-":
                    return l - r
                if e.op == "*":
                    return l * r
                return l / r
            raise ValueError(f"unexpected node in measure expression: {e}")

        v = ev(ast)
        if np.isscalar(v):
            v = np.full(self.ds.fact.num_rows, v, dtype=np.float64)
        return v

    def _count_distinct(self, vals, gids, mask, n_groups) -> np.ndarray:
        sel = mask
        pairs = np.stack([gids[sel].astype(np.int64), vals[sel].astype(np.int64)], axis=1)
        uniq = np.unique(pairs, axis=0)
        out = np.zeros(n_groups, dtype=np.float64)
        np.add.at(out, uniq[:, 0], 1.0)
        return out

    def _post_aggregate(self, sig: Signature, table: ResultTable) -> ResultTable:
        for h in sig.having:
            col = table.columns[f"m{h.measure}"]
            table = table.mask(eval_predicate(col, h.op, h.val))
        if sig.order_by:
            keys = []
            for o in sig.order_by:
                name = f"m{o.key.split(':', 1)[1]}" if o.key.startswith("measure:") else o.key
                keys.append((name, o.desc))
            table = table.sort(keys)
        if sig.limit is not None:
            table = table.head(sig.limit)
        return table


class _Stager(_threading.Thread):
    """A streaming chunk's staging thread.  Where the reference's stager
    drops its errors, this one keeps its error and ``raise_error`` raises
    it in the scanning thread after ``join``: a device error while staging
    must not vanish."""

    def __init__(self, target, *args):
        super().__init__(name="scan-stage", daemon=True)
        self._call = (target, args)
        self.error: Optional[Exception] = None

    def run(self) -> None:
        target, args = self._call
        try:
            target(*args)
        except Exception as e:  # raised again by raise_error in the scanning thread
            self.error = e

    def raise_error(self) -> None:
        if self.error is not None:
            raise self.error


def _pack_bounds(ranges: list[list[tuple[float, float]]]) -> np.ndarray:
    """Pack per-predicate range lists into a (P, K, 2) f32 bounds tensor,
    K padded to a power of two with never-match pad ranges."""
    p = len(ranges)
    if p == 0:
        return np.zeros((0, 1, 2), np.float32)
    k = max(1, max(len(r) for r in ranges))
    k = 1 << (k - 1).bit_length()
    out = np.empty((p, k, 2), np.float32)
    out[..., 0], out[..., 1] = _NEVER
    for i, r in enumerate(ranges):
        for j, (lo, hi) in enumerate(r):
            out[i, j] = (lo, hi)
    return out


def _intersect_ranges(a: list, b: list) -> list:
    """Intersection of two inclusive range disjunctions (AND of ORs back to
    one OR list); empty result means the conjunction is unsatisfiable.
    NaN-sentinel ranges (see ``bounds_mask_ref``) survive only when both
    sides carry one — NaN passes a conjunction iff every predicate admits
    NaN."""

    def split(rs):
        return ([r for r in rs if not np.isnan(r[0])],
                [r for r in rs if np.isnan(r[0])])

    a_num, a_nan = split(a)
    b_num, b_nan = split(b)
    out = []
    for lo1, hi1 in a_num:
        for lo2, hi2 in b_num:
            lo, hi = max(lo1, lo2), min(hi1, hi2)
            if lo <= hi:
                out.append((lo, hi))
    if a_nan and b_nan:
        out.append((np.nan, np.nan))
    return out


def _np_segment(values, gids, mask, n_groups, op) -> np.ndarray:
    """Independent numpy oracle for the segment reduce (no torch involved).

    MIN/MAX are NaN-aware the same way the kernels are (via the shared
    numpy-only ``_extreme_at``): NaN rows are masked out of the ``.at``
    scatter and their groups re-poisoned afterwards — a qualifying NaN row
    still yields a NaN group, matching the device path's NaN propagation,
    warning-free."""
    values = np.asarray(values, np.float64)
    m = values.shape[1]
    sel = np.asarray(mask, bool)
    g = gids[sel]
    v = values[sel]
    if op == "sum":
        out = np.zeros((n_groups, m))
        for j in range(m):
            np.add.at(out[:, j], g, v[:, j])
        return out
    out = np.full((n_groups, m), np.inf if op == "min" else -np.inf)
    for j in range(m):
        _extreme_at(op.upper(), v[:, j], g, out[:, j])
    return out
