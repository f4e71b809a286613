"""TieredStore: the write-behind cold-tier engine.

One instance owns one spill directory (a :class:`ColdTier`) and offers the
cache three durability verbs:

* ``spill(key, entry, table)`` — schedule a durable write of this entry
  *version*.  Asynchronous by default: the job is parked in a per-key
  pending map and a FIFO worker thread performs the ``.npz`` write outside
  the engine lock, finalizing (rename already done by the tier; manifest
  append + pending release) back under it.  A newer spill or a delete simply
  replaces/removes the pending claim — the worker detects the stale claim at
  finalize time and drops its work, so same-key writes can never finish out
  of order.  If the durable record already matches the entry's ``version``
  (and snapshot), only a cheap metadata log record is appended — this is
  what makes ``save_cache`` incremental.
* ``peek(key)`` / ``promote(key)`` — read a table back: pending claim first
  (the write may not have landed yet), then disk with sha verification.  A
  damaged payload reads as ``None`` (miss), never a false hit.  Promotion
  leaves the durable record in place: the cold copy stays a *clean* replica
  until the entry is rewritten or dropped.
* ``delete`` / ``purge`` — tombstone records and cancel pending claims, so
  dropped entries can never resurrect on replay.

``open()`` replays the manifest into table-less :class:`CacheEntry` metas
(signature-validated) and advances the process-wide recency clock past every
persisted stamp, so warm-restart stamps keep increasing.  ``flush()`` polls
the pending map empty (declared via ``note_blocking`` — callers must hold no
sanitized lock).  ``close()`` flushes, stops the worker, and compacts the
manifest.

Write-behind staleness window: between a hot mutation and the worker's
finalize, the durable copy is one version behind; a kill in that window
recovers the *previous* version of that entry (or none), never a torn or
mixed one.

Locking: ``TieredStore._lock`` (via the sanitizer's :func:`make_lock`) is a leaf —
acquired under ``CacheShard.lock`` on the request path, held across no
blocking call and no payload IO.  :class:`ColdTier`/:class:`DurableManifest`
have no locks of their own; every call into them is made under this lock
(except ``write_payload``, which targets a unique tmp name — see
``coldstore``).
"""
from __future__ import annotations

import os
import queue
import threading
import time
from typing import Optional

from ..analysis.sanitizer import make_lock, note_blocking
from ..core.cache import CacheEntry, advance_stamp
from ..core.table import ResultTable
from ..obs.trace import adopt, child_span, current_ctx
from ..resilience import faults
from ..resilience.primitives import CircuitBreaker, backoff_delays
from .coldstore import ColdTier

__all__ = ["TieredStore", "entry_meta"]

_STOP = object()


def entry_meta(entry: CacheEntry) -> dict:
    """The manifest-record metadata for one cache entry (everything but the
    payload fields, which come from the tier's payload writer)."""
    return {
        "signature": entry.signature.to_json(),
        "origin": entry.origin,
        "snapshot_id": entry.snapshot_id,
        "hits": entry.hits,
        "refreshes": entry.refreshes,
        "lru_stamp": entry.lru_stamp,
        "store_stamp": entry.store_stamp,
        "version": entry.version,
        "cost_ms": entry.cost_ms,
        "ttl_s": entry.ttl_s,
    }


def _entry_from_record(rec: dict, now: float) -> CacheEntry:
    """A table-less (cold) CacheEntry rebuilt from a manifest record.  The
    persisted stamps ride in through the constructor, so LRU order and probe
    MRU order reconstruct deterministically on warm restart."""
    return CacheEntry(
        signature=rec["_sig"],
        table=None,
        origin=rec.get("origin", "sql"),
        snapshot_id=rec.get("snapshot_id", "snap0"),
        stored_at=now,
        hits=int(rec.get("hits", 0)),
        refreshes=int(rec.get("refreshes", 0)),
        table_nbytes=int(rec.get("nbytes", 0)),
        lru_stamp=int(rec.get("lru_stamp", 0)),
        store_stamp=int(rec.get("store_stamp", 0)),
        version=int(rec.get("version", 0)),
        cost_ms=float(rec.get("cost_ms", 0.0)),
        ttl_s=rec.get("ttl_s"),
        last_used_at=now,
    )


class _Spill:
    """One pending write-behind job: the claim for a key's next durable
    state.  Identity (``cur is job``) is the cancellation token."""

    __slots__ = ("entry", "table", "meta", "ctx")

    def __init__(self, entry: CacheEntry, table: ResultTable, meta: dict,
                 ctx=None):
        self.entry = entry
        self.table = table
        self.meta = meta
        # the scheduling thread's trace context: the worker adopts it so the
        # write-behind span lands under the originating request's trace even
        # though it finishes after the response went out
        self.ctx = ctx


class TieredStore:
    """Write-behind durable cold tier over one spill directory."""

    def __init__(self, path: str, *, fsync: bool = True,
                 async_spill: bool = True):
        self.path = os.path.abspath(path)
        self.async_spill = async_spill
        self._lock = make_lock("TieredStore._lock")
        self._tier = ColdTier(self.path, fsync=fsync)  # guarded-by: self._lock
        self._pending: dict[str, _Spill] = {}  # guarded-by: self._lock
        self._queue: "queue.Queue" = queue.Queue()  # own internal lock
        self._worker: Optional[threading.Thread] = None  # guarded-by: self._lock
        self._closed = False  # guarded-by: self._lock
        self.spilled_writes = 0  # guarded-by: self._lock
        self.spill_meta_only = 0  # guarded-by: self._lock
        self.spill_superseded = 0  # guarded-by: self._lock
        self.spill_errors = 0  # guarded-by: self._lock
        self.payload_corrupt = 0  # guarded-by: self._lock
        self.deletes = 0  # guarded-by: self._lock
        # resilience: spill/read retry budgets (set before traffic; read-only
        # after), error surfacing, and the cold tier's availability breaker
        self.spill_attempts = 3
        self.read_attempts = 3
        self.spill_retries = 0  # guarded-by: self._lock
        self.spill_last_error: Optional[str] = None  # guarded-by: self._lock
        self.worker_deaths = 0  # guarded-by: self._lock
        self.wal_append_errors = 0  # guarded-by: self._lock
        self.read_errors = 0  # guarded-by: self._lock
        # leaf lock of its own: safe to consult under self._lock, never the
        # other way round
        self.cold_breaker = CircuitBreaker("cold_tier", recovery_s=0.25)

    # -------------------------------------------------------------- open
    def open(self) -> list[CacheEntry]:
        """Replay the manifest; return cold entry metas (table=None) for the
        cache to adopt.  Advances the global recency clock past every
        persisted stamp so new stamps stay strictly above restored ones."""
        now = time.monotonic()
        with self._lock:
            records = self._tier.open()
            entries = [_entry_from_record(rec, now) for rec in records.values()]
        max_stamp = max((max(e.lru_stamp, e.store_stamp) for e in entries),
                        default=0)
        advance_stamp(max_stamp)
        return entries

    @property
    def replay_report(self) -> dict:
        return dict(self._tier.replay_report)

    # ------------------------------------------------------------- spill
    def spill(self, key: str, entry: CacheEntry, table: ResultTable) -> None:
        """Schedule (async) or perform (sync) a durable write of this entry
        version.  Clean records (same version + snapshot, payload intact)
        only get a metadata log record — the incremental-save fast path."""
        meta = entry_meta(entry)
        with self._lock:
            if self._closed:
                return
            rec = self._tier.record(key)
            if (rec is not None and rec.get("sha")
                    and rec.get("version") == entry.version
                    and rec.get("snapshot_id") == entry.snapshot_id
                    and key not in self._pending):
                try:
                    self._tier.meta_record(key, meta)
                    self.spill_meta_only += 1
                    return
                except Exception:  # noqa: BLE001 — WAL append failed (disk
                    # full, injected IO fault): fall through to a full
                    # pending job so the payload path's retry machinery owns
                    # this version's durability instead of silently losing it
                    self.wal_append_errors += 1
            job = _Spill(entry, table, meta, ctx=current_ctx())
            self._pending[key] = job
            if self.async_spill:
                self._queue.put(key)
                self._ensure_worker()
                return
        self._write_job_with_retry(key, job)

    def _ensure_worker(self) -> None:  # requires-lock: self._lock
        if self._worker is None or not self._worker.is_alive():
            self._worker = threading.Thread(
                target=self._spill_loop, name="tiered-spill", daemon=True)
            self._worker.start()

    def _spill_loop(self) -> None:
        while True:
            key = self._queue.get()
            if key is _STOP:
                return
            if faults.should_fire("storage.spill_death"):
                # chaos: the worker thread dies mid-shift.  The claim stays
                # pending and the key is requeued, so the replacement worker
                # (restarted by the next spill()/flush()) picks it up — a
                # worker death costs latency, never a lost write
                self._queue.put(key)
                with self._lock:
                    self.worker_deaths += 1
                return
            with self._lock:
                job = self._pending.get(key)
            if job is None:
                continue  # cancelled (delete/purge) before we got to it
            self._write_job_with_retry(key, job)

    def _write_job_with_retry(self, key: str, job: _Spill) -> bool:
        """Attempt the durable write up to ``spill_attempts`` times with
        deterministic backoff, abandoning early when the claim is superseded
        or cancelled.  Only after the budget is spent does the claim drop —
        with the error surfaced in ``spill_errors`` / ``spill_last_error``,
        never swallowed.  Returns True on a landed write."""
        sattrs = {"key": key, "version": job.entry.version}
        with adopt(job.ctx), child_span("store.spill", attrs=sattrs):
            ok = self._attempt_write(key, job, sattrs)
            sattrs["ok"] = ok
            return ok

    def _attempt_write(self, key: str, job: _Spill, sattrs: dict) -> bool:
        attempts = max(self.spill_attempts, 1)
        delays = backoff_delays(attempts, 0.002, 0.05, salt=key)
        err: Optional[BaseException] = None
        for attempt in range(attempts):
            try:
                faults.fire_os("storage.spill_error")
                self._write_job(key, job)
                return True
            except Exception as e:  # noqa: BLE001 — retried IO boundary
                err = e
                with self._lock:
                    if self._pending.get(key) is not job:
                        # a newer spill or a delete owns the key now; its
                        # write (or tombstone) supersedes this one
                        self.spill_superseded += 1
                        return False
                    if attempt + 1 < attempts:
                        self.spill_retries += 1
                        sattrs["retries"] = sattrs.get("retries", 0) + 1
                if attempt + 1 < attempts:
                    time.sleep(delays[attempt])
        with self._lock:
            self.spill_errors += 1
            self.spill_last_error = f"{type(err).__name__}: {err}"
            sattrs["error"] = self.spill_last_error
            if self._pending.get(key) is job:
                del self._pending[key]
        return False

    def _write_job(self, key: str, job: _Spill) -> None:
        """Payload IO outside the lock; finalize under it.  The claim check
        (``cur is job``) makes stale writes drop out instead of clobbering a
        newer durable state."""
        payload = self._tier.write_payload(key, job.table)
        with self._lock:
            cur = self._pending.get(key)
            if cur is not job:
                # superseded (newer spill owns the claim now) or cancelled
                # (deleted): the newer job rewrites the payload file, or the
                # delete already tombstoned the record — either way this
                # write must not publish a manifest record
                self.spill_superseded += 1
                return
            self._tier.put_record(key, job.meta, payload)
            del self._pending[key]
            self.spilled_writes += 1
            self._tier.maybe_compact()

    # -------------------------------------------------------------- read
    def peek(self, key: str) -> Optional[ResultTable]:
        """Read a table back without consuming the record: pending claim
        first (freshest state), then disk with sha verification.  An
        unreadable, unavailable, or damaged payload is a miss — never a
        false hit, never an exception."""
        try:
            return self._read_payload(key)
        except OSError:
            return None

    def promote(self, key: str) -> Optional[ResultTable]:
        """Like :meth:`peek`, but distinguishes *transient* unavailability
        (IO errors exhausted the retry budget, or the cold breaker is open —
        raises ``OSError``) from *damage* (sha mismatch — returns ``None``),
        so the cache keeps the cold entry across an outage instead of
        dropping a clean durable replica."""
        return self._read_payload(key)

    def _read_payload(self, key: str) -> Optional[ResultTable]:
        """Shared read path: pending claim first (freshest state), then disk
        behind the cold tier's circuit breaker with a bounded micro-retry
        (reads can execute under a shard lock, so the worst-case added hold
        time stays a few milliseconds).  Returns the table, ``None`` for a
        missing/damaged payload, raises ``OSError`` when the tier is
        transiently unavailable."""
        with self._lock:
            job = self._pending.get(key)
            if job is not None:
                return job.table
            rec = self._tier.record(key)
        if rec is None:
            return None
        if not self.cold_breaker.allow():
            # fail fast while the cold tier is unavailable
            raise OSError("cold tier circuit breaker open")
        attempts = max(self.read_attempts, 1)
        delays = backoff_delays(attempts, 0.001, 0.004, salt=key)
        for attempt in range(attempts):
            try:
                faults.fire_os("coldtier.read_error")
                table = self._tier.read_payload(rec)
            except OSError:
                with self._lock:
                    self.read_errors += 1
                if attempt + 1 < attempts:
                    time.sleep(delays[attempt])
                continue
            self.cold_breaker.record_success()
            if table is None:
                with self._lock:
                    self.payload_corrupt += 1
            return table
        self.cold_breaker.record_failure()
        raise OSError(f"cold read failed after {attempts} attempts")

    def has(self, key: str) -> bool:
        with self._lock:
            return key in self._pending or self._tier.record(key) is not None

    def record_version(self, key: str) -> Optional[int]:
        with self._lock:
            rec = self._tier.record(key)
            return None if rec is None else rec.get("version")

    def keys(self) -> list:
        with self._lock:
            ks = set(self._tier.keys())
            ks.update(self._pending.keys())
            return sorted(ks)

    # ------------------------------------------------------------ delete
    def delete(self, key: str) -> None:
        """Tombstone + cancel any pending claim: the key can never
        resurrect on replay."""
        with self._lock:
            self._pending.pop(key, None)
            if self._tier.delete(key):
                self.deletes += 1

    def purge(self) -> int:
        with self._lock:
            self._pending.clear()
            return self._tier.purge()

    # --------------------------------------------------------- lifecycle
    def flush(self, timeout: float = 30.0) -> bool:
        """Wait (poll) until no spill is pending.  Callers must hold no
        sanitized lock — this blocks on the worker's progress."""
        note_blocking("TieredStore.flush")
        deadline = time.monotonic() + timeout
        while True:
            with self._lock:
                busy = bool(self._pending)
                if busy and self.async_spill and not self._closed and (
                        self._worker is None or not self._worker.is_alive()):
                    # the worker died (crash or injected storage.spill_death)
                    # with claims outstanding: requeue them (duplicates are
                    # harmless — the loop re-checks each claim) and restart
                    # it, so a dead worker can never wedge flush()
                    for k in self._pending:
                        self._queue.put(k)
                    self._ensure_worker()
            if not busy:
                return True
            if time.monotonic() > deadline:
                return False
            time.sleep(0.002)

    def compact(self) -> int:
        with self._lock:
            return self._tier.compact()

    def close(self, compact: bool = True) -> None:
        self.flush()
        with self._lock:
            worker = self._worker
            self._worker = None
            self._closed = True
        if worker is not None and worker.is_alive():
            self._queue.put(_STOP)
            worker.join(timeout=10.0)
        with self._lock:
            if compact:
                self._tier.compact()
            self._tier.close()

    # ------------------------------------------------------------- stats
    def stats(self) -> dict:
        with self._lock:
            return {
                "path": self.path,
                "records": len(self._tier.keys()),
                "disk_bytes": self._tier.disk_bytes(),
                "spill_queue_depth": len(self._pending),
                "spilled_writes": self.spilled_writes,
                "spill_meta_only": self.spill_meta_only,
                "spill_superseded": self.spill_superseded,
                "spill_errors": self.spill_errors,
                "spill_retries": self.spill_retries,
                "spill_last_error": self.spill_last_error,
                "worker_deaths": self.worker_deaths,
                "wal_append_errors": self.wal_append_errors,
                "read_errors": self.read_errors,
                "payload_corrupt": self.payload_corrupt,
                "deletes": self.deletes,
                "log_records": self._tier.manifest.log_records,
                "torn_records": self._tier.manifest.torn_records,
                "cold_breaker": self.cold_breaker.snapshot(),
            }
