"""Interning-immutability pass.

Interned value types (the frozen ``@dataclass(frozen=True)`` classes in
``core/signature.py``) are shared across threads precisely *because* they
are immutable: the cache keys, the single-compute-per-request hash
invariant, and the family index all assume a ``Signature`` never changes
after construction.  ``object.__setattr__`` pierces the frozen guard, so
this pass polices it:

* inside the defining module, ``object.__setattr__(self, ...)`` from the
  class's own methods is construction/interning and allowed;
* outside, only the blessed ``INTERNING_SITES`` registry entries (e.g.
  the cluster writing ``Signature._family_hash`` once under its topology
  lock) are allowed — anything else is a finding;
* a plain attribute assignment to a receiver inferred frozen is also
  flagged (it would raise ``FrozenInstanceError`` at runtime; the lint
  catches it before a test has to).

Additionally, ``FROZEN_OWNERS`` declares owner-only mutable fields of
shared record types: ``CacheEntry.signature`` / ``lru_stamp`` /
``store_stamp`` are written only by ``core/cache.py`` (under the shard
lock); a write from any other module is a finding even though the class
itself is not frozen.
"""
from __future__ import annotations

import ast
from typing import Optional

from . import annotations as A
from .findings import Finding
from .lockcheck import _Scope, _expr_calls, _own_exprs


def _frozen_classes(index: A.ProjectIndex) -> dict:
    return {name: ci for name, ci in index.classes.items() if ci.frozen}


def _interning_allowed(rel: str, cls: str, field: str) -> bool:
    for (suffix, c, f) in A.INTERNING_SITES:
        if rel.endswith(suffix) and c == cls and f == field:
            return True
    return False


def _walk_functions(module: A.ModuleInfo):
    for cinfo in module.classes.values():
        for func in cinfo.methods.values():
            yield cinfo, func
    for func in module.functions.values():
        yield None, func


def _iter_stmts(fn: ast.AST):
    for node in ast.walk(fn):
        if isinstance(node, ast.stmt):
            yield node


def run(index: A.ProjectIndex) -> tuple:
    """Returns (findings, waived)."""
    frozen = _frozen_classes(index)
    out: list = []
    waived_out: list = []

    def emit(module: A.ModuleInfo, site: ast.AST, identifier: str,
             message: str) -> None:
        f = Finding(rule="immutability", file=module.rel, line=site.lineno,
                    identifier=identifier, message=message)
        (waived_out if A.waived(module, site, "immutability")
         else out).append(f)

    for module in index.modules:
        own_frozen = {name for name in module.classes if name in frozen}
        for cinfo, func in _walk_functions(module):
            scope = _Scope(index, cinfo, func.node)
            for stmt in _iter_stmts(func.node):
                # --- object.__setattr__ escapes
                for call in _expr_calls(_own_exprs(stmt)):
                    fname = A.normalize(call.func) or ""
                    if fname != "object.__setattr__" or len(call.args) < 2:
                        continue
                    recv = call.args[0]
                    field = (call.args[1].value
                             if isinstance(call.args[1], ast.Constant) and
                             isinstance(call.args[1].value, str) else "?")
                    classes = scope.receiver_classes(recv)
                    froz = sorted(c for c in classes if c in frozen)
                    if not froz:
                        continue
                    for cls in froz:
                        if cls in own_frozen and cinfo is not None and \
                                A.normalize(recv) == "self":
                            continue  # construction/interning in-class
                        if _interning_allowed(module.rel, cls, field):
                            continue
                        emit(module, call, f"{cls}.{field}",
                             f"{func.qualname} pierces frozen {cls} via "
                             f"object.__setattr__ on field {field!r} "
                             f"(not a registered interning site)")
                # --- plain assignment to a frozen receiver / owned field
                targets = []
                if isinstance(stmt, ast.Assign):
                    targets = stmt.targets
                elif isinstance(stmt, (ast.AugAssign, ast.AnnAssign)):
                    targets = [stmt.target]
                for tgt in targets:
                    if not isinstance(tgt, ast.Attribute):
                        continue
                    classes = scope.receiver_classes(tgt.value)
                    for cls in sorted(classes):
                        if cls in frozen:
                            if cinfo is not None and cls == cinfo.name and \
                                    A.normalize(tgt.value) == "self":
                                continue
                            emit(module, tgt, f"{cls}.{tgt.attr}",
                                 f"{func.qualname} assigns "
                                 f"{cls}.{tgt.attr}: {cls} is frozen "
                                 f"(would raise FrozenInstanceError)")
                        owned = A.FROZEN_OWNERS.get(cls)
                        if owned and tgt.attr in owned["fields"] and \
                                not module.rel.endswith(owned["owner"]):
                            emit(module, tgt, f"{cls}.{tgt.attr}",
                                 f"{func.qualname} writes owner-only field "
                                 f"{cls}.{tgt.attr} outside "
                                 f"{owned['owner']}")
    return out, waived_out
