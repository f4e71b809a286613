"""Static lock-order pass: extract the acquisition digraph, reject cycles.

Granularity is the **lock class** — the ``make_lock`` order-class string
(``"CacheShard.lock"``) — matching the runtime sanitizer, so static edges
and observed edges line up.  Lock expressions are resolved through the
project index: ``with self._lock:`` looks up the enclosing class's lock
attributes; ``with fl.shard.lock:`` walks receiver types (parameter
annotations, constructor locals, registry TYPE_HINTS); ``with
t.gate.write:`` maps the tenant gate's ``read``/``write`` context managers
to their pseudo-lock classes.

Nesting is collected flow-sensitively inside each function, then
propagated across calls by a fixpoint over per-function summaries (the set
of lock classes a function may transitively acquire): a call made while
holding ``A`` contributes edges ``A -> x`` for every ``x`` in the callee's
summary.  This is conservative — summaries ignore *which instance* — so:

* a held and re-acquired lock with the *same normalized expression* is
  same-instance reentrance and records no edge;
* self-edges on classes in ``SELF_ORDER_OK`` (deterministic instance
  order, mirrored by ``sanitizer.allow_same_class_order``) are skipped;
* a documented false positive is suppressed with ``# analysis:
  allow[lock-order]`` on the call/with line — it still shows up in the
  JSON report as waived.

Nested ``def``s (thread bodies, closures) contribute their own edges with
an empty entry held-set but are excluded from the enclosing function's
summary: the enclosing call site does not acquire their locks on the
caller's thread.
"""
from __future__ import annotations

import ast
import dataclasses
from typing import Optional

from . import annotations as A
from .findings import Finding
from .lockcheck import _Scope, _expr_calls, _own_exprs


@dataclasses.dataclass
class _Event:
    kind: str            # "acquire" | "call"
    held: tuple          # ((order_class, expr), ...) at the event
    classes: set         # acquire: lock classes; call: unused
    callees: tuple       # call: resolved function keys
    site: str            # "file:line"
    line: int
    waived: bool
    expr: Optional[str] = None   # acquire: normalized lock expression


@dataclasses.dataclass
class _Fn:
    key: tuple
    info: A.FuncInfo
    module: A.ModuleInfo
    scope: _Scope
    events: list = dataclasses.field(default_factory=list)
    direct: set = dataclasses.field(default_factory=set)
    callees: set = dataclasses.field(default_factory=set)
    summarized: bool = True   # nested defs excluded from caller summaries


def _resolve_lock(index: A.ProjectIndex, scope: _Scope,
                  expr: ast.AST) -> set:
    """Lock classes a dotted expression denotes (usually one)."""
    if not isinstance(expr, ast.Attribute):
        return set()
    leaf = expr.attr
    out = set()
    for cls_name in scope.receiver_classes(expr.value):
        ci = index.lookup(cls_name)
        if ci is not None and leaf in ci.locks:
            out.add(ci.locks[leaf])
        if cls_name == "ReadWriteGate" and leaf in A.GATE_PSEUDO_LOCKS:
            out.add(A.GATE_PSEUDO_LOCKS[leaf])
    return out


def _resolve_callees(index: A.ProjectIndex, module: A.ModuleInfo,
                     scope: _Scope, call: ast.Call) -> tuple:
    fn = call.func
    keys = []
    if isinstance(fn, ast.Attribute):
        for cls_name in scope.receiver_classes(fn.value):
            ci = index.lookup(cls_name)
            if ci is not None and fn.attr in ci.methods:
                keys.append((cls_name, fn.attr))
    elif isinstance(fn, ast.Name):
        if fn.id in module.functions:
            keys.append((module.rel, fn.id))
        else:
            ci = index.lookup(fn.id)
            if ci is not None and "__init__" in ci.methods:
                keys.append((fn.id, "__init__"))
    return tuple(keys)


def _collect(index: A.ProjectIndex, module: A.ModuleInfo, fn: _Fn,
             nested_out: list) -> None:
    info = fn.info

    def site(node: ast.AST) -> str:
        return f"{module.rel}:{node.lineno}"

    def is_waived(node: ast.AST) -> bool:
        return A.waived(module, node, "lock-order")

    def record_calls(stmt: ast.AST, held: list) -> None:
        for call in _expr_calls(_own_exprs(stmt)):
            callees = _resolve_callees(index, module, fn.scope, call)
            if callees:
                fn.callees.update(callees)
                fn.events.append(_Event(
                    kind="call", held=tuple(held), classes=set(),
                    callees=callees, site=site(call), line=call.lineno,
                    waived=is_waived(stmt)))

    def walk(stmts: list, held: list) -> None:
        for stmt in stmts:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                nested_out.append((stmt, fn))
                continue
            record_calls(stmt, held)
            if isinstance(stmt, ast.Expr) and isinstance(stmt.value, ast.Call) \
                    and isinstance(stmt.value.func, ast.Attribute):
                recv = stmt.value.func.value
                if stmt.value.func.attr == "acquire":
                    classes = _resolve_lock(index, fn.scope, recv)
                    expr = A.normalize(recv)
                    if classes:
                        fn.direct.update(classes)
                        fn.events.append(_Event(
                            kind="acquire", held=tuple(held), classes=classes,
                            callees=(), site=site(stmt), line=stmt.lineno,
                            waived=is_waived(stmt), expr=expr))
                        for oc in classes:
                            held.append((oc, expr))
                elif stmt.value.func.attr == "release":
                    expr = A.normalize(recv)
                    for i in range(len(held) - 1, -1, -1):
                        if held[i][1] == expr:
                            del held[i]
                            break
            if isinstance(stmt, (ast.With, ast.AsyncWith)):
                inner = list(held)
                for item in stmt.items:
                    classes = _resolve_lock(index, fn.scope,
                                            item.context_expr)
                    expr = A.normalize(item.context_expr)
                    if classes:
                        fn.direct.update(classes)
                        fn.events.append(_Event(
                            kind="acquire", held=tuple(inner),
                            classes=classes, callees=(), site=site(stmt),
                            line=stmt.lineno, waived=is_waived(stmt),
                            expr=expr))
                        for oc in classes:
                            inner.append((oc, expr))
                walk(stmt.body, inner)
                continue
            for attr_name in ("body", "orelse", "finalbody"):
                sub = getattr(stmt, attr_name, None)
                if sub:
                    walk(sub, held)
            for handler in getattr(stmt, "handlers", ()) or ():
                walk(handler.body, held)

    held0: list = []
    for req in sorted(info.requires):
        try:
            expr = ast.parse(req, mode="eval").body
        except SyntaxError:
            continue
        for oc in _resolve_lock(index, fn.scope, expr):
            held0.append((oc, req))
    walk(info.node.body, held0)


def _build_functions(index: A.ProjectIndex) -> dict:
    funcs: dict = {}
    nested: list = []
    for module in index.modules:
        for cinfo in module.classes.values():
            for name, info in cinfo.methods.items():
                fn = _Fn(key=(cinfo.name, name), info=info, module=module,
                         scope=_Scope(index, cinfo, info.node))
                funcs[fn.key] = fn
        for name, info in module.functions.items():
            fn = _Fn(key=(module.rel, name), info=info, module=module,
                     scope=_Scope(index, None, info.node))
            funcs[fn.key] = fn
    for fn in list(funcs.values()):
        _collect(index, fn.module, fn, nested)
    # nested defs: own events, excluded from caller summaries
    while nested:
        node, parent = nested.pop()
        info = A.FuncInfo(
            qualname=f"{parent.info.qualname}.<{node.name}>", node=node,
            cls=parent.info.cls, requires=set(), file=parent.info.file)
        fn = _Fn(key=(parent.key[0], info.qualname), info=info,
                 module=parent.module,
                 scope=_Scope(index, index.lookup(parent.key[0])
                              if isinstance(parent.key[0], str) else None,
                              node),
                 summarized=False)
        if fn.key not in funcs:
            funcs[fn.key] = fn
            _collect(index, fn.module, fn, nested)
    return funcs


def _summaries(funcs: dict) -> dict:
    summary = {k: set(fn.direct) for k, fn in funcs.items()}
    changed = True
    while changed:
        changed = False
        for key, fn in funcs.items():
            acc = summary[key]
            before = len(acc)
            for callee in fn.callees:
                sub = funcs.get(callee)
                if sub is not None and sub.summarized:
                    acc |= summary[callee]
            if len(acc) != before:
                changed = True
    return summary


def _edges(funcs: dict, summary: dict) -> tuple:
    """Returns (edges {(A, B): witness}, waived_events [Finding])."""
    edges: dict = {}
    waived_events: list = []

    def add(a: str, b: str, witness: str, ev: _Event, held_expr: str,
            acq_expr: Optional[str]) -> None:
        if a == b:
            if acq_expr is not None and acq_expr == held_expr:
                return      # same normalized expr: same-instance reentrance
            if a in A.SELF_ORDER_OK:
                return
        if ev.waived:
            waived_events.append(Finding(
                rule="lock-order", file=witness.rsplit(":", 1)[0],
                line=ev.line, identifier=f"edge:{a} -> {b}",
                message=f"edge {a} -> {b} suppressed by waiver at {witness}"))
            return
        edges.setdefault((a, b), witness)

    for key, fn in funcs.items():
        for ev in fn.events:
            if ev.kind == "acquire":
                for b in ev.classes:
                    for a, held_expr in ev.held:
                        add(a, b, ev.site, ev, held_expr, ev.expr)
            else:
                if not ev.held:
                    continue
                for callee in ev.callees:
                    for b in summary.get(callee, ()):
                        for a, held_expr in ev.held:
                            add(a, b, f"{ev.site} (via {callee[0]}."
                                      f"{callee[1]})", ev, held_expr, None)
    return edges, waived_events


def _cycles(edges: dict) -> list:
    """Self-loops plus strongly-connected components of size > 1."""
    graph: dict = {}
    for (a, b) in edges:
        graph.setdefault(a, set()).add(b)
        graph.setdefault(b, set())
    out = []
    for a in sorted(graph):
        if a in graph[a]:
            out.append([a])
    # Tarjan SCC, iterative
    index_counter = [0]
    stack: list = []
    lowlink: dict = {}
    num: dict = {}
    on_stack: set = set()
    sccs: list = []

    def strongconnect(v: str) -> None:
        work = [(v, iter(sorted(graph[v])))]
        num[v] = lowlink[v] = index_counter[0]
        index_counter[0] += 1
        stack.append(v)
        on_stack.add(v)
        while work:
            node, it = work[-1]
            advanced = False
            for w in it:
                if w not in num:
                    num[w] = lowlink[w] = index_counter[0]
                    index_counter[0] += 1
                    stack.append(w)
                    on_stack.add(w)
                    work.append((w, iter(sorted(graph[w]))))
                    advanced = True
                    break
                elif w in on_stack:
                    lowlink[node] = min(lowlink[node], num[w])
            if advanced:
                continue
            work.pop()
            if work:
                parent = work[-1][0]
                lowlink[parent] = min(lowlink[parent], lowlink[node])
            if lowlink[node] == num[node]:
                scc = []
                while True:
                    w = stack.pop()
                    on_stack.discard(w)
                    scc.append(w)
                    if w == node:
                        break
                if len(scc) > 1:
                    sccs.append(sorted(scc))

    for v in sorted(graph):
        if v not in num:
            strongconnect(v)
    out.extend(sccs)
    return out


def run(index: A.ProjectIndex) -> tuple:
    """Returns (findings, waived, edges) where edges maps (A, B) -> witness."""
    funcs = _build_functions(index)
    summary = _summaries(funcs)
    edges, waived_events = _edges(funcs, summary)
    findings = []
    for cyc in _cycles(edges):
        members = set(cyc)
        involved = {pair: w for pair, w in sorted(edges.items())
                    if pair[0] in members and pair[1] in members}
        witnesses = "; ".join(f"{a} -> {b} at {w}"
                              for (a, b), w in list(involved.items())[:6])
        ident = " -> ".join(cyc + [cyc[0]])
        findings.append(Finding(
            rule="lock-order", file=sorted(
                w.rsplit(":", 1)[0].split(" ")[0]
                for w in involved.values())[0] if involved else "?",
            line=0, identifier=f"cycle:{ident}",
            message=f"lock-order cycle {ident} ({witnesses})"))
    return findings, waived_events, edges
