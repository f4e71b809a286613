"""Cold tier: per-entry ``.npz`` payloads + the durable manifest.

Payload protocol (unchanged file naming from the spill format from before
tiering, so old spill directories replay):

* one ``entry_<key[:24]>.npz`` per record, serialized in memory first, then
  written to a unique ``.tmp`` sibling, flushed + fsync'd, and atomically
  renamed into place;
* the manifest record carries ``sha`` (sha256 of the npz bytes), ``file_bytes``
  (size framing, checked at replay) and ``columns`` (order restoration) —
  records written by the format from before tiering lack these and are trusted like the
  old loader trusted them;
* a read re-verifies ``sha`` before deserializing: a torn or tampered payload
  is a *miss*, never a false hit.

Replay validates each record's embedded signature against its key
(``sig.key() == key`` — the same tamper/versioning guard ``load_cache``
always had) and deletes orphans: ``entry_*.npz`` files no manifest record
references, and leftover ``*.tmp`` from a mid-write kill.

Thread-safety: none here; every call is serialized under the owning
:class:`~repro_torch.storage.engine.TieredStore`'s ``_lock`` or happens on the
single spill worker via the engine's pending-claim protocol (payload writes
target unique tmp names, and renames are finalized under the engine lock).
"""
from __future__ import annotations

import hashlib
import io
import itertools
import os
from typing import Optional

import numpy as np

from ..core.signature import signature_from_json
from ..core.table import ResultTable
from ..resilience import faults
from .manifest import DurableManifest

__all__ = ["ColdTier", "payload_name"]

PAYLOAD_PREFIX = "entry_"
PAYLOAD_SUFFIX = ".npz"

_TMP_SEQ = itertools.count(1)


def payload_name(key: str) -> str:
    """Stable payload filename for a cache key (legacy-compatible)."""
    return f"{PAYLOAD_PREFIX}{key[:24]}{PAYLOAD_SUFFIX}"


def _serialize_table(table: ResultTable) -> tuple[bytes, list]:
    buf = io.BytesIO()
    np.savez(buf, **{c: np.asarray(v) for c, v in table.columns.items()})
    return buf.getvalue(), list(table.columns.keys())


class ColdTier:
    """Disk records + payloads for one store directory."""

    def __init__(self, path: str, *, fsync: bool = True):
        self.path = os.path.abspath(path)
        os.makedirs(self.path, exist_ok=True)
        self.fsync = fsync
        self.manifest = DurableManifest(self.path, fsync=fsync)
        # key -> record dict; parsed Signature cached under "_sig".
        # Serialized externally by the owning TieredStore._lock.
        self._records: dict[str, dict] = {}
        self.replay_report: dict = {}

    # -------------------------------------------------------------- open
    def open(self) -> dict[str, dict]:
        """Replay the manifest, validate records, clean orphans.  Returns the
        surviving ``{key: record}`` map (also kept as ``self._records``)."""
        raw, report = self.manifest.replay()
        report["invalid_records"] = 0
        report["missing_payloads"] = 0
        report["orphan_files"] = 0
        keep: dict[str, dict] = {}
        for key, rec in raw.items():
            sig_json = rec.get("signature")
            if not isinstance(sig_json, dict):
                report["invalid_records"] += 1
                continue
            try:
                sig = signature_from_json(sig_json)
            except Exception:
                report["invalid_records"] += 1
                continue
            if sig.key() != key:
                report["invalid_records"] += 1
                continue
            fname = rec.get("file")
            fpath = os.path.join(self.path, fname) if fname else None
            if not fname or not os.path.exists(fpath):
                report["missing_payloads"] += 1
                continue
            if "file_bytes" in rec and os.path.getsize(fpath) != rec["file_bytes"]:
                # torn payload that was renamed anyway (should not happen
                # with tmp+rename, but tolerate a damaged store)
                report["missing_payloads"] += 1
                continue
            rec["_sig"] = sig
            keep[key] = rec
        referenced = {rec["file"] for rec in keep.values()}
        for fname in os.listdir(self.path):
            fpath = os.path.join(self.path, fname)
            stale_payload = (fname.startswith(PAYLOAD_PREFIX)
                             and fname.endswith(PAYLOAD_SUFFIX)
                             and fname not in referenced)
            torn_tmp = fname.endswith(".tmp")
            if stale_payload or torn_tmp:
                try:
                    os.unlink(fpath)
                    report["orphan_files"] += 1
                except OSError:
                    pass
        self._records = keep
        self.replay_report = report
        return keep

    # ---------------------------------------------------------- payloads
    def write_payload(self, key: str, table: ResultTable) -> dict:
        """Write the payload file (tmp+fsync+atomic rename).  Returns the
        payload fields for the manifest record.  Safe to call without the
        engine lock: the tmp name is unique per call and the rename replaces
        the whole file atomically."""
        data, columns = _serialize_table(table)
        fname = payload_name(key)
        tmp = os.path.join(self.path, f"{fname}.{next(_TMP_SEQ)}.{os.getpid()}.tmp")
        with open(tmp, "wb") as f:
            f.write(data)
            f.flush()
            if self.fsync:
                os.fsync(f.fileno())
        os.replace(tmp, os.path.join(self.path, fname))
        return {
            "file": fname,
            "file_bytes": len(data),
            "sha": hashlib.sha256(data).hexdigest(),
            "columns": columns,
            "nbytes": int(table.nbytes()),
        }

    def read_payload(self, rec: dict) -> Optional[ResultTable]:
        """Load and verify a record's payload.  ``None`` on any damage —
        a cold read never produces a false hit."""
        fname = rec.get("file")
        if not fname:
            return None
        fpath = os.path.join(self.path, fname)
        try:
            with open(fpath, "rb") as f:
                data = f.read()
        except OSError:
            return None
        if faults.should_fire("storage.sha_corrupt"):
            # chaos: bit-rot between write and read — the sha check below
            # must turn this into a miss, never a served wrong table
            data = data[:-1] + bytes([data[-1] ^ 0xFF]) if data else b"\x00"
        sha = rec.get("sha")
        if sha is not None and hashlib.sha256(data).hexdigest() != sha:
            return None
        try:
            with np.load(io.BytesIO(data)) as z:
                loaded = {c: np.array(z[c]) for c in z.files}
        except Exception:
            return None
        order = rec.get("columns") or list(loaded.keys())
        if any(c not in loaded for c in order):
            return None
        return ResultTable(columns={c: loaded[c] for c in order})

    # ----------------------------------------------------------- records
    def record(self, key: str) -> Optional[dict]:
        return self._records.get(key)

    def keys(self) -> list:
        return list(self._records.keys())

    def put_record(self, key: str, meta: dict, payload: dict) -> None:
        rec = {"key": key, **meta, **payload}
        self.manifest.append({**rec, "op": "put"})
        sig = rec.get("signature")
        self._records[key] = rec
        if isinstance(sig, dict) and "_sig" not in rec:
            try:
                rec["_sig"] = signature_from_json(sig)
            except Exception:
                pass

    def meta_record(self, key: str, meta: dict) -> None:
        cur = self._records.get(key)
        if cur is None:
            return
        fields = {k: meta[k] for k in
                  ("hits", "refreshes", "lru_stamp", "store_stamp", "version",
                   "snapshot_id", "cost_ms", "ttl_s", "origin") if k in meta}
        self.manifest.append({"key": key, "op": "meta", **fields})
        cur.update(fields)

    def delete(self, key: str) -> bool:
        rec = self._records.pop(key, None)
        if rec is None:
            return False
        self.manifest.append({"key": key, "op": "del"})
        fname = rec.get("file")
        if fname:
            try:
                os.unlink(os.path.join(self.path, fname))
            except OSError:
                pass
        return True

    def purge(self) -> int:
        n = 0
        for key in list(self._records.keys()):
            if self.delete(key):
                n += 1
        self.compact()
        return n

    # -------------------------------------------------------- compaction
    def compact(self) -> int:
        return self.manifest.checkpoint(self._records.values())

    def maybe_compact(self) -> None:
        if self.manifest.log_records > max(64, 4 * len(self._records)):
            self.compact()

    def disk_bytes(self) -> int:
        return sum(int(rec.get("file_bytes", rec.get("nbytes", 0)))
                   for rec in self._records.values())

    def close(self) -> None:
        self.manifest.close()
