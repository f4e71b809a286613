"""Findings model + JSON report + baseline handling for the static passes.

A finding is keyed for baseline purposes by ``(rule, file, identifier)`` —
*not* by line number, so unrelated edits above an accepted finding don't
churn the baseline.  ``identifier`` is a stable name: the guarded attribute
(``CacheShard._inflight``), the lock-order cycle (``A -> B -> A``), or the
frozen field (``Signature._family_hash``).
"""
from __future__ import annotations

import dataclasses
import json
from typing import Iterable, Optional

RULES = (
    "guarded-by",              # write to a guarded attr without its lock
    "unannotated-shared-write",  # lock-owning class writes an undeclared attr
    "lock-order",              # static acquisition-order cycle
    "immutability",            # mutation of an interned / frozen value type
)


@dataclasses.dataclass(frozen=True)
class Finding:
    rule: str
    file: str          # repo-relative path
    line: int
    identifier: str    # stable name for baseline matching
    message: str

    def key(self) -> tuple:
        return (self.rule, self.file, self.identifier)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    def render(self) -> str:
        return f"{self.file}:{self.line}: [{self.rule}] {self.message}"


def load_baseline(path: str) -> set:
    """Baseline file: ``{"findings": [{rule, file, identifier}, ...]}``."""
    try:
        with open(path) as fh:
            data = json.load(fh)
    except FileNotFoundError:
        return set()
    return {(f["rule"], f["file"], f["identifier"])
            for f in data.get("findings", ())}


def split_baseline(findings: Iterable[Finding],
                   baseline: set) -> tuple[list, list]:
    """Partition into (new, baselined)."""
    new, old = [], []
    for f in findings:
        (old if f.key() in baseline else new).append(f)
    return new, old


def write_report(path: str, *, paths: list, findings: list,
                 new: list, baselined: list,
                 waived: Optional[list] = None) -> dict:
    report = {
        "tool": "repro_torch.analysis",
        "paths": list(paths),
        "counts": {
            "total": len(findings),
            "new": len(new),
            "baselined": len(baselined),
            "waived": len(waived or ()),
        },
        "findings": [f.to_dict() for f in findings],
        "new": [f.to_dict() for f in new],
        "waived": [f.to_dict() for f in (waived or ())],
    }
    with open(path, "w") as fh:
        json.dump(report, fh, indent=2, sort_keys=True)
        fh.write("\n")
    return report
