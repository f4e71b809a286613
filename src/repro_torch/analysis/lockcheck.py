"""Lock-discipline pass: prove every write to a ``# guarded-by:`` attribute
is dominated by a ``with`` (or paired ``acquire()``) on the declared lock.

Flow handling, deliberately pragmatic for a lint:

* ``with <dotted-expr>:`` adds the normalized expression to the held set
  for its body (any dotted context manager counts — guards are matched
  textually, so ``with self._cond:`` proves ``guarded-by: self._cond`` and
  ``with t.gate.write:`` proves ``guarded-by: self.gate.write`` on a
  ``t``-typed receiver).
* ``X.acquire()`` / ``X.release()`` statements toggle the held set for the
  remainder of the enclosing block (covers the try/finally multi-lock
  pattern in ``CacheCluster.set_shards``).
* ``# requires-lock:`` on the def header seeds the held set
  (caller-holds-lock contract; call sites are checked by the lock-order
  pass's graph, runtime truth by the sanitizer).
* Nested ``def``s are analyzed with an *empty* held set: a closure may run
  on another thread after the enclosing scope released everything.

Writes are attribute assigns (plain, augmented, annotated), ``del``,
subscript stores through an attribute, known mutator-method calls
(``append``/``update``/``move_to_end``/...), and ``setattr(obj, ...)``
(treated as writing every guarded attribute of the receiver's class).
``__init__`` / ``__post_init__`` are construction and exempt.

Cross-receiver writes (``flight.table = ...``) are checked when the
receiver's class can be inferred (parameter annotations, constructor-call
locals, registry TYPE_HINTS): the guard is re-rooted from ``self`` onto the
receiver expression.

A second rule, ``unannotated-shared-write``, is how the pass *surfaces*
undeclared shared state: in a class that owns a lock (``make_lock`` /
``threading.Lock`` attribute), any non-constructor write to an attribute
with no ``guarded-by`` declaration is a finding — the author must either
annotate the guard, declare ``external[...]``, or register a benign race.
"""
from __future__ import annotations

import ast
from typing import Optional

from . import annotations as A
from .findings import Finding

MUTATORS = {
    "add", "append", "appendleft", "clear", "discard", "extend", "insert",
    "move_to_end", "pop", "popitem", "popleft", "remove", "reverse",
    "setdefault", "sort", "update", "__setitem__",
}

_CTORS = ("__init__", "__post_init__")


class _Scope:
    """Per-function receiver-type context."""

    def __init__(self, index: A.ProjectIndex, cinfo: Optional[A.ClassInfo],
                 fn: ast.AST):
        self.index = index
        self.cinfo = cinfo
        self.params: dict = {}
        for arg in list(fn.args.args) + list(fn.args.kwonlyargs):
            self.params[arg.arg] = A.annotation_classes(arg.annotation)
        self.locals: dict = {}
        for stmt in ast.walk(fn):
            if isinstance(stmt, ast.Assign) and len(stmt.targets) == 1 and \
                    isinstance(stmt.targets[0], ast.Name) and \
                    isinstance(stmt.value, ast.Call):
                name = stmt.targets[0].id
                self.locals.setdefault(name, set()).update(
                    self._call_result_classes(stmt.value))

    def _call_result_classes(self, call: ast.Call) -> set:
        fname = A.normalize(call.func) or ""
        leaf = fname.split(".")[-1]
        if leaf and leaf[0].isupper() and self.index.lookup(leaf):
            return {leaf}
        # self.method(...) with a return annotation
        if fname.startswith("self.") and self.cinfo is not None:
            m = self.cinfo.methods.get(leaf)
            if m is not None:
                return A.annotation_classes(m.node.returns)
        return set()

    def receiver_classes(self, node: ast.AST) -> set:
        if isinstance(node, ast.Name):
            if node.id == "self":
                return {self.cinfo.name} if self.cinfo else set()
            out = set()
            out |= self.params.get(node.id, set())
            out |= self.locals.get(node.id, set())
            hint = A.TYPE_HINTS.get(node.id)
            if hint:
                out.add(hint)
            return out
        if isinstance(node, ast.Attribute):
            bases = self.receiver_classes(node.value)
            out = set()
            for b in bases:
                ci = self.index.lookup(b)
                if ci is not None:
                    out |= ci.attr_types.get(node.attr, set())
            return out
        if isinstance(node, ast.Call):
            return self._call_result_classes(node)
        return set()


def _target_writes(tgt: ast.AST):
    """Yield (receiver_node, attr, site) pairs for an assignment target."""
    if isinstance(tgt, ast.Attribute):
        yield tgt.value, tgt.attr, tgt
    elif isinstance(tgt, ast.Subscript):
        if isinstance(tgt.value, ast.Attribute):
            yield tgt.value.value, tgt.value.attr, tgt
    elif isinstance(tgt, (ast.Tuple, ast.List)):
        for elt in tgt.elts:
            yield from _target_writes(elt)
    elif isinstance(tgt, ast.Starred):
        yield from _target_writes(tgt.value)


def _own_exprs(stmt: ast.AST) -> list:
    """Expression nodes belonging to the statement itself — never the
    bodies of compound statements (those are walked with their own held
    sets)."""
    if isinstance(stmt, ast.Assign):
        return list(stmt.targets) + [stmt.value]
    if isinstance(stmt, (ast.AugAssign, ast.AnnAssign)):
        return [stmt.target] + ([stmt.value] if stmt.value else [])
    if isinstance(stmt, ast.Delete):
        return list(stmt.targets)
    if isinstance(stmt, (ast.Expr, ast.Return)):
        return [stmt.value] if stmt.value is not None else []
    if isinstance(stmt, ast.Raise):
        return [e for e in (stmt.exc, stmt.cause) if e is not None]
    if isinstance(stmt, ast.Assert):
        return [e for e in (stmt.test, stmt.msg) if e is not None]
    if isinstance(stmt, (ast.If, ast.While)):
        return [stmt.test]
    if isinstance(stmt, (ast.For, ast.AsyncFor)):
        return [stmt.iter]
    if isinstance(stmt, (ast.With, ast.AsyncWith)):
        return [item.context_expr for item in stmt.items]
    return []


def _expr_calls(exprs: list):
    """Call nodes in expression trees, pruning nested function bodies."""
    stack = list(exprs)
    while stack:
        node = stack.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)):
            continue
        if isinstance(node, ast.Call):
            yield node
        stack.extend(ast.iter_child_nodes(node))


def _stmt_writes(stmt: ast.AST):
    """All attribute writes a single statement performs directly: assign
    targets, plus mutator-method calls and setattr in its own expressions."""
    if isinstance(stmt, ast.Assign):
        for tgt in stmt.targets:
            yield from _target_writes(tgt)
    elif isinstance(stmt, (ast.AugAssign, ast.AnnAssign)):
        yield from _target_writes(stmt.target)
    elif isinstance(stmt, ast.Delete):
        for tgt in stmt.targets:
            yield from _target_writes(tgt)
    for node in _expr_calls(_own_exprs(stmt)):
        if isinstance(node.func, ast.Attribute) and node.func.attr in MUTATORS:
            inner = node.func.value
            if isinstance(inner, ast.Attribute):
                yield inner.value, inner.attr, node
        elif isinstance(node.func, ast.Name) and node.func.id == "setattr" \
                and len(node.args) >= 2:
            yield node.args[0], "*", node


def _reroot(guard: str, receiver: str) -> str:
    """Re-root a guard declared against ``self`` onto a write-site
    receiver expression ("self.shard.lock" + "fl" -> "fl.shard.lock")."""
    if guard == "self":
        return receiver
    if guard.startswith("self."):
        return receiver + guard[len("self"):]
    return guard


def _check_write(module: A.ModuleInfo, scope: _Scope, func: A.FuncInfo,
                 held: set, recv: ast.AST, attr: str, site: ast.AST,
                 out: list, waived_out: list) -> None:
    recv_expr = A.normalize(recv)
    classes = scope.receiver_classes(recv)
    is_self = recv_expr == "self"
    for cls_name in sorted(classes):
        if cls_name in A.EXTERNAL_CLASSES:
            continue
        cinfo = scope.index.lookup(cls_name)
        if cinfo is None:
            continue
        attrs = [attr] if attr != "*" else sorted(cinfo.guarded)
        for a in attrs:
            if (cls_name, a) in A.BENIGN_RACES:
                continue
            g = cinfo.guarded.get(a)
            if g is not None:
                if g.external is not None:
                    continue
                needed = g.guard if is_self else _reroot(g.guard, recv_expr or "")
                if needed in held or g.guard in func.requires:
                    continue
                f = Finding(
                    rule="guarded-by", file=module.rel, line=site.lineno,
                    identifier=f"{cls_name}.{a}",
                    message=(f"{func.qualname} writes {cls_name}.{a} "
                             f"without holding {needed!r} "
                             f"(declared at {g.file}:{g.line}); "
                             f"held={sorted(held) or '[]'}"))
                (waived_out if A.waived(module, site, "guarded-by")
                 else out).append(f)
            elif is_self and cinfo.owns_lock and a not in cinfo.locks \
                    and func.qualname.split(".")[-1] not in _CTORS:
                f = Finding(
                    rule="unannotated-shared-write", file=module.rel,
                    line=site.lineno, identifier=f"{cls_name}.{a}",
                    message=(f"{func.qualname} writes {cls_name}.{a}, but "
                             f"the lock-owning class declares no "
                             f"'# guarded-by:' for it (annotate the guard, "
                             f"'external[...]', or register a benign race)"))
                (waived_out if A.waived(module, site,
                                        "unannotated-shared-write")
                 else out).append(f)


def _walk(module: A.ModuleInfo, scope: _Scope, func: A.FuncInfo,
          stmts: list, held: set, out: list, waived_out: list,
          nested: list) -> None:
    for stmt in stmts:
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
            nested.append(stmt)
            continue
        # acquire()/release() toggles for the remainder of this block
        if isinstance(stmt, ast.Expr) and isinstance(stmt.value, ast.Call) \
                and isinstance(stmt.value.func, ast.Attribute):
            target = A.normalize(stmt.value.func.value)
            if target is not None:
                if stmt.value.func.attr == "acquire":
                    held.add(target)
                elif stmt.value.func.attr == "release":
                    held.discard(target)
        for recv, attr, site in _stmt_writes(stmt):
            _check_write(module, scope, func, held, recv, attr, site,
                         out, waived_out)
        if isinstance(stmt, (ast.With, ast.AsyncWith)):
            inner = set(held)
            for item in stmt.items:
                expr = A.normalize(item.context_expr)
                if expr is not None:
                    inner.add(expr)
            _walk(module, scope, func, stmt.body, inner, out, waived_out,
                  nested)
            continue
        for attr_name in ("body", "orelse", "finalbody"):
            sub = getattr(stmt, attr_name, None)
            if sub:
                _walk(module, scope, func, sub, held, out, waived_out, nested)
        for handler in getattr(stmt, "handlers", ()) or ():
            _walk(module, scope, func, handler.body, held, out, waived_out,
                  nested)


def _check_function(module: A.ModuleInfo, index: A.ProjectIndex,
                    cinfo: Optional[A.ClassInfo], func: A.FuncInfo,
                    out: list, waived_out: list) -> None:
    leaf = func.qualname.split(".")[-1]
    if cinfo is not None and leaf in _CTORS:
        return
    scope = _Scope(index, cinfo, func.node)
    nested: list = []
    # in-loop acquire() (e.g. "for sh in shards: sh.lock.acquire()") leaks
    # the held expr into the remainder of the block via a pre-scan
    _walk(module, scope, func, func.node.body, set(func.requires),
          out, waived_out, nested)
    for nfn in nested:
        sub = A.FuncInfo(qualname=f"{func.qualname}.<{nfn.name}>",
                         node=nfn, cls=func.cls, requires=set(),
                         file=func.file)
        _check_function(module, index, cinfo, sub, out, waived_out)


def run(index: A.ProjectIndex) -> tuple:
    """Returns (findings, waived)."""
    out: list = []
    waived_out: list = []
    for module in index.modules:
        for cinfo in module.classes.values():
            for func in cinfo.methods.values():
                _check_function(module, index, cinfo, func, out, waived_out)
        for func in module.functions.values():
            _check_function(module, index, None, func, out, waived_out)
    return out, waived_out
