"""Columnar star-schema datasets (the backend's storage layer).

Every column is a flat numpy array; string columns are dictionary-encoded
(int32 codes + vocab) so the executor works purely on integer/float arrays;
dates are int32 days-since-epoch.  Dimension primary keys are row positions
(0..n-1) by construction, so a fact->dimension join is a single gather by
the foreign-key column.  :class:`DeviceDataset` mirrors the columns into
torch tensors on the executor's device.
"""
from __future__ import annotations

import dataclasses
import datetime as _dt
import threading
import time
from typing import Optional

import numpy as np
import torch

from ..analysis.sanitizer import make_lock
from ..core.schema import Column, Dimension, FactTable, Hierarchy, StarSchema

_EPOCH = _dt.date(1970, 1, 1)


def date_to_days(iso: str) -> int:
    return (_dt.date.fromisoformat(str(iso)) - _EPOCH).days


def days_to_date(days: int) -> str:
    return (_EPOCH + _dt.timedelta(days=int(days))).isoformat()


@dataclasses.dataclass
class ColumnData:
    dtype: str  # 'int' | 'float' | 'str' | 'date'
    data: np.ndarray  # numeric values, int32 codes (str), int32 days (date)
    vocab: Optional[np.ndarray] = None  # str columns: code -> string

    def __post_init__(self):
        if self.dtype == "str" and self.vocab is None:
            # dictionary-encode on construction
            vocab, codes = np.unique(np.asarray(self.data, dtype=str), return_inverse=True)
            self.vocab = vocab
            self.data = codes.astype(np.int32)
        elif self.dtype == "date" and self.data.dtype.kind in ("U", "O"):
            self.data = np.asarray([date_to_days(d) for d in self.data], dtype=np.int32)

    @property
    def n(self) -> int:
        return len(self.data)

    def encode_value(self, v):
        """Map a literal to the physical domain (string->code, date->days)."""
        if self.dtype == "str":
            idx = np.searchsorted(self.vocab, str(v))
            if idx < len(self.vocab) and self.vocab[idx] == str(v):
                return int(idx)
            return -1  # value absent: matches nothing
        if self.dtype == "date":
            return date_to_days(v)
        return v

    def _appended(self, values: np.ndarray) -> tuple[np.ndarray, Optional[np.ndarray]]:
        """Pure form of :meth:`append`: the (data, vocab) this column would
        hold after appending ``values`` — nothing is assigned, so callers can
        stage every column's conversion (which may raise on bad input)
        before committing any of them."""
        values = np.asarray(values)
        if self.dtype == "str":
            new = np.asarray(values, dtype=str)
            if len(self.vocab):
                codes = np.searchsorted(self.vocab, new)
                codes = np.clip(codes, 0, len(self.vocab) - 1)
                if bool(np.all(self.vocab[codes] == new)):
                    return (np.concatenate([self.data, codes.astype(np.int32)]),
                            self.vocab)
            # unseen values: re-encode everything, because ``encode_value``
            # binary-searches a *sorted* vocab
            decoded = self.vocab[self.data] if len(self.vocab) else self.data.astype(str)
            vocab, codes = np.unique(np.concatenate([decoded, new]), return_inverse=True)
            return codes.astype(np.int32), vocab
        if self.dtype == "date" and values.dtype.kind in ("U", "O"):
            values = np.asarray([date_to_days(d) for d in values], dtype=np.int32)
        cast = values.astype(self.data.dtype, copy=False)
        if self.data.dtype.kind in "iu" and values.dtype.kind in "fiu" \
                and not np.array_equal(cast.astype(values.dtype), values):
            # fractional/NaN/overflowing values for an int column: reject
            # like every other malformed delta instead of silently
            # truncating or wrapping
            raise ValueError(
                f"lossy cast: {values.dtype} values do not fit the column's "
                f"{self.data.dtype} domain exactly")
        return np.concatenate([self.data, cast]), self.vocab

    def append(self, values: np.ndarray) -> None:
        """Append raw (decoded-domain) values in place — the streaming-ingest
        path.  Dates accept ISO strings or int days; strings re-encode the
        whole column when the delta carries unseen values."""
        self.data, self.vocab = self._appended(values)

    def decode(self, physical: np.ndarray) -> np.ndarray:
        if self.dtype == "str":
            return self.vocab[physical]
        if self.dtype == "date":
            return np.asarray([days_to_date(d) for d in physical])
        return physical


@dataclasses.dataclass
class TableData:
    name: str
    columns: dict[str, ColumnData]

    @property
    def num_rows(self) -> int:
        return next(iter(self.columns.values())).n if self.columns else 0


@dataclasses.dataclass(frozen=True)
class Partition:
    """Row-range metadata for one ingest batch of the fact table.

    ``[start_row, end_row)`` are fact row positions; ``[date_start,
    date_end)`` is the batch's time extent on the schema's date column (ISO,
    end exclusive; None when the schema has no date column).  The cache's
    §6.2 refresh rule keys off the date extent; the executor's delta scan
    keys off the row range.
    """

    start_row: int
    end_row: int
    date_start: Optional[str] = None
    date_end: Optional[str] = None
    snapshot_id: str = ""

    @property
    def num_rows(self) -> int:
        return self.end_row - self.start_row


@dataclasses.dataclass
class Dataset:
    schema: StarSchema
    fact: TableData
    dims: dict[str, TableData]
    snapshot_id: str = "snap0"
    version: int = 0  # bumped on every append; executors resync caches on it
    partitions: list[Partition] = dataclasses.field(default_factory=list)
    _device: Optional["DeviceDataset"] = dataclasses.field(
        default=None, repr=False, compare=False)

    def device(self, device="cuda") -> "DeviceDataset":
        """The shared device-resident mirror on ``device`` (created on first
        use, so the numpy-oracle path never touches a device).  Asking for
        another device replaces the mirror."""
        dev = resolve_device(device)
        if self._device is None or self._device.device != dev:
            self._device = DeviceDataset(self, dev)
        return self._device

    # ---------------------------------------------------------------- append
    def append_rows(
        self, rows: dict[str, np.ndarray], snapshot_id: Optional[str] = None
    ) -> Partition:
        """Append a batch of fact rows (streaming/delta ingest).

        ``rows`` maps every fact column name to an equal-length array of raw
        (decoded-domain) values; dimension tables are immutable — FK values
        must reference existing dimension rows.  Records a :class:`Partition`
        with the batch's row range and date extent, bumps ``version`` (so
        executors resynchronize their row-aligned caches), and drops the
        mirror's fact-aligned device arrays (rebuilt lazily; dimension
        uploads survive).  The input arrays are never mutated.
        """
        missing = set(self.fact.columns) - set(rows)
        extra = set(rows) - set(self.fact.columns)
        if missing or extra:
            raise ValueError(
                f"delta columns must match the fact table exactly: "
                f"missing {sorted(missing)}, unexpected {sorted(extra)}")
        lengths = {len(np.asarray(v)) for v in rows.values()}
        if len(lengths) != 1:
            raise ValueError(f"ragged delta: column lengths {sorted(lengths)}")
        if lengths == {0}:
            raise ValueError("empty delta: nothing to append")
        start = self.fact.num_rows
        # stage every column's conversion before committing any of it: a bad
        # value (e.g. an unparseable date) must raise with the dataset fully
        # intact, never leave it ragged mid-append
        staged = {name: col._appended(np.asarray(rows[name]))
                  for name, col in self.fact.columns.items()}
        # FK bounds are part of the contract (dimension pk == row position):
        # an out-of-range key would commit fine and then crash every later
        # scan's gather, far from the producer bug — reject it here instead
        for dim in self.schema.dimensions:
            td = self.dims.get(dim.name)
            if td is None or dim.fact_fk not in rows:
                continue
            fk = np.asarray(rows[dim.fact_fk])
            if len(fk) and (int(fk.min()) < 0 or int(fk.max()) >= td.num_rows):
                raise ValueError(
                    f"delta {dim.fact_fk} values [{int(fk.min())}, "
                    f"{int(fk.max())}] fall outside dimension "
                    f"{dim.name!r} (rows 0..{td.num_rows - 1})")
        if not self.partitions:
            # retroactive base partition so row provenance covers every row
            self.partitions.append(Partition(
                0, start, *self._date_extent(0, start), self.snapshot_id))
        for name, col in self.fact.columns.items():
            col.data, col.vocab = staged[name]
        end = self.fact.num_rows
        if snapshot_id:
            self.snapshot_id = snapshot_id
        part = Partition(start, end, *self._date_extent(start, end),
                         self.snapshot_id)
        self.partitions.append(part)
        self.version += 1
        if self._device is not None:
            # fact-aligned device arrays are stale (rebuilt lazily); the
            # dimension uploads survive — dimension tables are immutable
            # across appends, and keeping them is what lets a delta tick
            # upload only delta-sized fact data
            self._device.drop_fact_arrays()
        return part

    def _date_extent(self, start: int, end: int):
        """[start, end) date coverage of a fact row range on the schema's
        date column — ISO inclusive start / exclusive end, (None, None) when
        the schema has no date column or the range is empty."""
        date_col = self.schema.fact.date_column
        if date_col is None or end <= start:
            return None, None
        days = self.fact.columns[date_col].data[start:end]
        return days_to_date(int(days.min())), days_to_date(int(days.max()) + 1)

    def slice_rows(self, start: int, end: int) -> "Dataset":
        """View dataset over fact rows [start, end) sharing the dimension
        tables — the delta-scan storage for incremental refresh.  Column
        arrays are numpy views (no copies); the slice gets its own device
        mirror, which uploads only delta-sized fact columns (dimension
        uploads can be shared from the parent's mirror via
        ``DeviceDataset.share_dim_arrays``)."""
        fact = TableData(self.fact.name, {
            n: ColumnData(c.dtype, c.data[start:end], c.vocab)
            for n, c in self.fact.columns.items()})
        return Dataset(self.schema, fact, self.dims, snapshot_id=self.snapshot_id)

    # ------------------------------------------------------------- accessors
    def table(self, name: str) -> TableData:
        if name == self.fact.name:
            return self.fact
        return self.dims[name]

    def column(self, qualified: str) -> ColumnData:
        t, c = qualified.split(".", 1)
        return self.table(t).columns[c]

    def fact_aligned(self, qualified: str) -> np.ndarray:
        """Physical values of ``table.column`` aligned to fact rows (dimension
        columns are gathered through the FK; pk == row position)."""
        t, c = qualified.split(".", 1)
        if t == self.fact.name:
            return self.fact.columns[c].data
        dim = self.schema.dimension(t)
        fk = self.fact.columns[dim.fact_fk].data
        return self.dims[t].columns[c].data[fk]

    # --------------------------------------------------------- hierarchy map
    def level_mapper(self):
        """Build the LevelMapper used by roll-up derivations: maps fine-level
        *decoded* values to coarse-level decoded values via the dim table.

        The fine->coarse LUT for each (dim, fine, coarse) edge of the level
        lattice is built once and memoized on the closure: dimension tables
        are immutable after build (``append_rows`` only grows the fact), so
        re-deriving the mapping on every roll-up probe was pure waste.
        ``None`` (non-summarizable / unknown column) memoizes too."""
        luts: dict[tuple[str, str, str], Optional[dict]] = {}

        def _lut(dim_name: str, fine: str, coarse: str) -> Optional[dict]:
            dim = self.dims.get(dim_name)
            if dim is None:
                return None
            fc, cc = dim.columns.get(fine), dim.columns.get(coarse)
            if fc is None or cc is None:
                return None
            fine_dec = fc.decode(fc.data)
            coarse_dec = cc.decode(cc.data)
            lut: dict = {}
            for f, c in zip(fine_dec, coarse_dec):
                prev = lut.get(f)
                if prev is not None and prev != c:
                    return None  # not summarizable: child with two parents
                lut[f] = c
            return lut

        def mapper(dim_name: str, fine: str, coarse: str, fine_values: np.ndarray):
            edge = (dim_name, fine, coarse)
            if edge not in luts:
                luts[edge] = _lut(dim_name, fine, coarse)
            lut = luts[edge]
            if lut is None:
                return None
            try:
                return np.asarray([lut[v] for v in fine_values])
            except KeyError:
                return None

        return mapper

    def upload_time_ms(self) -> float:
        """Milliseconds spent so far uploading/deriving device arrays."""
        return self._device.upload_ms if self._device is not None else 0.0

    def validate_hierarchies(self) -> list[str]:
        """Check declared-summarizable hierarchies are functional in the data."""
        problems = []
        for d in self.schema.dimensions:
            td = self.dims.get(d.name)
            if td is None:
                continue
            for h in d.hierarchies:
                if not h.summarizable:
                    continue
                for fine, coarse in zip(h.levels, h.levels[1:]):
                    fc, cc = td.columns.get(fine), td.columns.get(coarse)
                    if fc is None or cc is None:
                        continue
                    pairs = {}
                    for f, c in zip(fc.data, cc.data):
                        if pairs.setdefault(int(f), int(c)) != int(c):
                            problems.append(f"{d.name}: {fine}->{coarse} not functional")
                            break
        return problems




def resolve_device(device) -> torch.device:
    """``torch.device`` for ``device``, with a CUDA device pinned to its
    index.  Raises when CUDA is asked for and absent: the port never falls
    back to the CPU on its own."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {device!r} requested but CUDA is not available; "
                "pass device='cpu' to run the plain PyTorch path")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def _to_tensor(v, device: torch.device):
    """Host or device array -> tensor on ``device``, narrowed to 32 bits
    as the JAX mirror does with x64 off (ints -> int32, floats -> float32;
    bools stay bool)."""
    t = torch.from_numpy(np.ascontiguousarray(v)) if isinstance(v, np.ndarray) \
        else torch.as_tensor(v)
    if t.dtype.is_floating_point:
        t = t.to(torch.float32)
    elif t.dtype != torch.bool:
        t = t.to(torch.int32)
    return t.to(device)


class DeviceDataset:
    """Device-resident mirror of a :class:`Dataset` — the executor's storage
    layer.

    Fact columns, dimension columns, and FK gathers are uploaded to the
    device *once per dataset* and memoized; derived tensors (fact-aligned
    f32 casts, group-id vectors, fused measure blocks, predicate column
    stacks) are computed on-device and memoized under caller-chosen keys via
    :meth:`cache`.  The host numpy ``Dataset`` is untouched and remains the
    input of the independent numpy oracle (``OlapExecutor(impl='numpy')``).
    """

    def __init__(self, dataset: Dataset, device: torch.device):
        self.ds = dataset
        self.device = device
        self._store: dict = {}  # guarded-by: external[idempotent memo; cleared between requests]
        # dimension-column uploads live in their own store so it can be
        # *aliased* between mirrors (see ``share_dim_arrays``)
        self._dim_store: dict = {}  # guarded-by: external[idempotent memo; aliased before first use]
        self.upload_ms = 0.0  # guarded-by: self._upload_lock
        self._upload_lock = make_lock("DeviceDataset._upload_lock")
        # cache() nesting depth, per thread: the service's shard threads
        # upload concurrently, and one thread's nested build must not keep
        # another's outermost upload out of upload_ms.  upload_ms is then a
        # sum of per-thread times, not wall time: where threads upload at
        # once (shards > 1) their times overlap, and each includes a
        # device-wide synchronize, so the sum can exceed the wall time
        self._depth = threading.local()

    @property
    def num_rows(self) -> int:
        return self.ds.fact.num_rows

    def _map(self, key) -> dict:
        return self._dim_store if key and key[0] == "dimcol" else self._store

    def cache(self, key, build):
        """Memoized device tensor: ``build()`` may return a host numpy array
        (uploaded) or a tensor (moved to the device if needed).  Integer data
        is stored as int32 and float data as float32.  Keys are
        caller-namespaced tuples, e.g. ``('aligned', 'customer.c_region')``.
        Concurrent builders (the service's shard threads) may race on a
        cold key; both build the same value, last write wins — benign for
        pure uploads."""
        store = self._map(key)
        v = store.get(key)
        if v is None:
            # only the thread's outermost frame accrues upload_ms: builders
            # call cache() recursively (aligned -> col/dimcol) and the inner
            # elapsed is already inside the outer measurement
            depth = getattr(self._depth, "n", 0)
            t0 = time.perf_counter()
            self._depth.n = depth + 1
            try:
                v = _to_tensor(build(), self.device)
                if self.device.type == "cuda":
                    torch.cuda.synchronize(self.device)
            finally:
                self._depth.n = depth
            if depth == 0:
                with self._upload_lock:
                    self.upload_ms += (time.perf_counter() - t0) * 1e3
            store[key] = v
        return v

    def drop(self, key) -> None:
        """Release one memoized device tensor (executor memo-LRU eviction)."""
        self._map(key).pop(key, None)

    def fact_aligned(self, qualified: str):
        """Device tensor of ``table.column`` aligned to fact rows; dimension
        columns are gathered through the FK *on device* (upload the dim
        column and the FK once, gather once, cache the result)."""

        def build():
            t, c = qualified.split(".", 1)
            if t == self.ds.fact.name:
                return self.ds.fact.columns[c].data
            dim = self.ds.schema.dimension(t)
            fk = self.cache(
                ("col", f"{self.ds.fact.name}.{dim.fact_fk}"),
                lambda: self.ds.fact.columns[dim.fact_fk].data,
            )
            dcol = self.cache(
                ("dimcol", t, c), lambda: self.ds.dims[t].columns[c].data
            )
            return torch.index_select(dcol, 0, fk)

        return self.cache(("aligned", qualified), build)

    def fact_aligned_f32(self, qualified: str):
        return self.cache(
            ("aligned32", qualified),
            lambda: self.fact_aligned(qualified).to(torch.float32),
        )

    def drop_fact_arrays(self) -> None:
        """Drop every fact-aligned/derived device tensor (they are stale
        after a fact append), keeping only the dimension-column uploads."""
        self._store.clear()

    def share_dim_arrays(self, other: "DeviceDataset") -> None:
        """Alias this mirror's dimension-column store to another mirror's.
        Valid whenever both datasets share the same dimension tables (row
        slices do) and live on the same device: ``('dimcol', ...)`` entries
        are aligned to dimension rows, never to fact rows.  The stores are
        *live-shared* after the call."""
        if other.ds.dims is not self.ds.dims:
            raise ValueError("device dim arrays can only be shared between "
                             "mirrors of the same dimension tables")
        if other.device != self.device:
            raise ValueError(f"cannot share dim arrays across devices "
                             f"({self.device} vs {other.device})")
        for key, v in self._dim_store.items():
            other._dim_store.setdefault(key, v)
        self._dim_store = other._dim_store

    def nbytes(self) -> int:
        return int(sum(v.numel() * v.element_size()
                       for store in (self._store, self._dim_store)
                       for v in store.values()))


# ------------------------------------------------------- reference datasets


def _schema_from(ref) -> StarSchema:
    def cols(cs):
        return tuple(Column(c.name, c.dtype) for c in cs)

    fact = FactTable(ref.fact.name, cols(ref.fact.columns), ref.fact.date_column)
    dims = tuple(
        Dimension(d.name, d.fact_fk, d.pk, cols(d.columns),
                  tuple(Hierarchy(h.name, tuple(h.levels), h.summarizable)
                        for h in d.hierarchies),
                  tuple((c, k) for c, k in d.time_kinds))
        for d in ref.dimensions)
    return StarSchema(ref.name, fact, dims, ref.time_dimension)


def _table_from(ref) -> TableData:
    return TableData(ref.name, {
        name: ColumnData(c.dtype, np.array(c.data, copy=True),
                         None if c.vocab is None else np.array(c.vocab, copy=True))
        for name, c in ref.columns.items()})


def from_reference(ref) -> Dataset:
    """The port's :class:`Dataset` (and its :class:`StarSchema`) built from
    another package's dataset of the same shape: schema fields, and each
    column's ``dtype``/``data``/``vocab`` as numpy.  Only attributes are
    read, so the reference's package is never imported here; the arrays are
    copied."""
    return Dataset(
        _schema_from(ref.schema), _table_from(ref.fact),
        {name: _table_from(t) for name, t in ref.dims.items()},
        snapshot_id=ref.snapshot_id, version=ref.version,
        partitions=[Partition(p.start_row, p.end_row, p.date_start,
                              p.date_end, p.snapshot_id)
                    for p in ref.partitions])
