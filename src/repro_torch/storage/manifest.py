"""Crash-safe manifest: checkpoint + append-only CRC-framed WAL.

Layout inside a store directory::

    manifest.json   checkpoint — a JSON *array* of put-records, written
                    tmp+fsync+atomic-rename (the ``save_cache`` spill
                    format from before tiering, so such directories replay
                    unchanged)
    manifest.log    WAL — one JSON object per line, each carrying a CRC32 of
                    its own canonical serialization; appended + flushed +
                    fsync'd per record

Replay is checkpoint first, then the log in order.  Log records carry an
``op``:

* ``put``  — full record (payload file just renamed into place): replaces
  any prior record for the key.
* ``meta`` — metadata-only refresh (stamps / hit counts / snapshot): merged
  into the existing record; ignored if the key is unknown (the matching
  ``put`` may have been lost to a crash — a metadata orphan is not a hit).
* ``del``  — tombstone: removes the record.

A torn tail line (kill mid-append), a corrupted line (CRC mismatch), or an
unknown op is *skipped and counted*, never fatal: the manifest recovers the
longest consistent prefix.  Compaction folds the current record set into a
fresh checkpoint (atomic rename) and then truncates the log — a crash
between those two steps merely replays log records that are already in the
checkpoint, which is idempotent.

Thread-safety: none here.  All calls are serialized by the owning
:class:`repro_torch.storage.engine.TieredStore` under its ``_lock`` (the class is
registered in the analysis annotations as externally synchronized).
"""
from __future__ import annotations

import errno
import json
import os
import zlib
from typing import Iterable, Optional

from ..resilience import faults

__all__ = ["DurableManifest", "CHECKPOINT_NAME", "LOG_NAME"]

CHECKPOINT_NAME = "manifest.json"
LOG_NAME = "manifest.log"

# record fields merged (not replaced) by a ``meta`` op
_META_FIELDS = ("hits", "refreshes", "lru_stamp", "store_stamp", "version",
                "snapshot_id", "cost_ms", "ttl_s", "origin")


def _crc_payload(rec: dict) -> str:
    body = json.dumps({k: v for k, v in rec.items() if k != "crc"},
                      sort_keys=True, separators=(",", ":"))
    return format(zlib.crc32(body.encode("utf-8")) & 0xFFFFFFFF, "08x")


def _fsync_dir(path: str) -> None:
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:  # platform without directory fds
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


class DurableManifest:
    """Checkpoint + WAL over one store directory.  Not thread-safe by
    itself — see module docstring."""

    def __init__(self, path: str, *, fsync: bool = True):
        self.path = path
        self.fsync = fsync
        self.checkpoint_path = os.path.join(path, CHECKPOINT_NAME)
        self.log_path = os.path.join(path, LOG_NAME)
        self._fh = None            # lazily opened append handle for the log
        self.log_records = 0       # records appended since last checkpoint
        self.torn_records = 0      # skipped lines over the store's lifetime

    # ------------------------------------------------------------- append
    def append(self, record: dict) -> None:
        """Durably append one log record (op defaults to ``put``).

        Chaos injection points (deterministic, via ``REPRO_FAULTS``):
        ``storage.wal_enospc`` / ``storage.wal_oserror`` raise before any
        byte lands (disk full / generic IO failure); ``storage.wal_torn``
        writes *half* a frame then raises — the kill-mid-append case replay
        must skip as a torn tail."""
        faults.fire_os("storage.wal_enospc", err_no=errno.ENOSPC)
        faults.fire_os("storage.wal_oserror")
        rec = dict(record)
        rec.setdefault("op", "put")
        rec["crc"] = _crc_payload(rec)
        line = json.dumps(rec, sort_keys=True, separators=(",", ":")) + "\n"
        if self._fh is None:
            self._fh = open(self.log_path, "a", encoding="utf-8")
        if faults.should_fire("storage.wal_torn"):
            self._fh.write(line[:max(len(line) // 2, 1)])
            self._fh.flush()
            if self.fsync:
                os.fsync(self._fh.fileno())
            raise OSError("injected fault: storage.wal_torn (half frame)")
        self._fh.write(line)
        self._fh.flush()
        if self.fsync:
            os.fsync(self._fh.fileno())
        self.log_records += 1

    # ------------------------------------------------------------- replay
    def replay(self) -> tuple[dict, dict]:
        """Rebuild ``{key: record}`` from checkpoint + log.

        Returns ``(records, report)`` where ``report`` counts what was seen
        and what was skipped (torn/CRC-failed lines, orphan meta records).
        """
        records: dict[str, dict] = {}
        report = {"checkpoint_records": 0, "log_records": 0,
                  "torn_records": 0, "orphan_meta": 0, "tombstones": 0}
        if os.path.exists(self.checkpoint_path):
            try:
                with open(self.checkpoint_path, "r", encoding="utf-8") as f:
                    base = json.load(f)
            except (OSError, ValueError):
                base = []
                report["torn_records"] += 1
            if isinstance(base, list):
                for rec in base:
                    if isinstance(rec, dict) and rec.get("key"):
                        rec.pop("op", None)
                        rec.pop("crc", None)
                        records[rec["key"]] = rec
                        report["checkpoint_records"] += 1
        applied = 0
        if os.path.exists(self.log_path):
            with open(self.log_path, "rb") as f:
                raw = f.read()
            for line in raw.split(b"\n"):
                if not line.strip():
                    continue
                try:
                    rec = json.loads(line.decode("utf-8"))
                except (ValueError, UnicodeDecodeError):
                    report["torn_records"] += 1
                    continue
                if not isinstance(rec, dict) or "crc" not in rec \
                        or rec["crc"] != _crc_payload(rec):
                    report["torn_records"] += 1
                    continue
                key = rec.get("key")
                op = rec.pop("op", "put")
                rec.pop("crc", None)
                if not key:
                    report["torn_records"] += 1
                    continue
                applied += 1
                if op == "del":
                    records.pop(key, None)
                    report["tombstones"] += 1
                elif op == "meta":
                    cur = records.get(key)
                    if cur is None:
                        report["orphan_meta"] += 1
                    else:
                        for f_ in _META_FIELDS:
                            if f_ in rec:
                                cur[f_] = rec[f_]
                elif op == "put":
                    records[key] = rec
                else:
                    report["torn_records"] += 1
        report["log_records"] = applied
        self.log_records = applied
        self.torn_records += report["torn_records"]
        return records, report

    # --------------------------------------------------------- checkpoint
    def checkpoint(self, records: Iterable[dict]) -> int:
        """Fold ``records`` into a fresh checkpoint (atomic rename), then
        truncate the log.  Crash between the two steps is idempotent on
        replay.  Returns the number of records written."""
        out = []
        for rec in records:
            rec = {k: v for k, v in rec.items()
                   if not k.startswith("_") and k not in ("op", "crc")}
            out.append(rec)
        tmp = self.checkpoint_path + ".tmp"
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(out, f, indent=1, sort_keys=True)
            f.flush()
            if self.fsync:
                os.fsync(f.fileno())
        os.replace(tmp, self.checkpoint_path)
        if self.fsync:
            _fsync_dir(self.path)
        # now the log is redundant: truncate it
        if self._fh is not None:
            self._fh.close()
            self._fh = None
        with open(self.log_path, "w", encoding="utf-8") as f:
            f.flush()
            if self.fsync:
                os.fsync(f.fileno())
        self.log_records = 0
        return len(out)

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None
