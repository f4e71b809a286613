"""Annotation conventions, analysis registry, and the project index.

The passes read three comment conventions out of the source text (the
``ast`` module drops comments, so declarations are matched back to their
statement's source span):

``# guarded-by: self._lock``
    Trailing an attribute declaration (``self.x = ...`` in ``__init__`` /
    ``__post_init__``, or a dataclass field).  Every write to the attribute
    outside construction must happen while the named lock expression is
    held (a dominating ``with`` or a paired ``acquire()``), where the
    guard is spelled relative to the *owning instance* — a write through
    another receiver ``r`` requires ``r.<guard suffix>`` to be held.

``# guarded-by: external[why]``
    The attribute is mutable and shared but synchronized by a mechanism
    the pass cannot see (single-writer protocols, rebalance holding every
    shard lock).  Declares the invariant without a provable lock.

``# requires-lock: self.shard.lock``
    Trailing a ``def`` header (any of its physical lines): the method's
    contract is caller-holds-lock; the pass seeds the held set with it.

``# analysis: allow[rule] reason``
    Line-level waiver: findings of ``rule`` whose statement span covers
    this line are suppressed (they still appear in the JSON report under
    ``waived``).  Used for documented false positives only.

The REGISTRY section collects the facts that have no natural source line:
externally-synchronized whole classes, benign idempotent races, receiver
type hints, interning sites, and owner-only record fields.
"""
from __future__ import annotations

import ast
import dataclasses
import os
import re
from typing import Optional

# --------------------------------------------------------------- REGISTRY

#: Classes whose entire mutable state is externally synchronized; writes to
#: their attributes are never findings.  Keyed by class name, value is why.
EXTERNAL_CLASSES = {
    "SemanticCache": "owned by exactly one CacheShard; every entry/stats "
                     "mutation runs inside CacheShard.lock (_shard_op)",
    "CacheStats": "owned by a SemanticCache (same shard lock) or by "
                  "CacheCluster._retired_stats under _topology_lock",
    "ColdTier": "owned by exactly one TieredStore; every call runs under "
                "TieredStore._lock (write_payload targets unique tmp names)",
    "DurableManifest": "owned by exactly one ColdTier; serialized by the "
                       "owning TieredStore._lock",
}

#: (class, attr) pairs that are deliberate benign races: idempotent memos
#: where a lost race recomputes the same value.  Exempt from both
#: guarded-by and unannotated-shared-write.
BENIGN_RACES = {
    ("OlapExecutor", "_exact_cols"):
        "idempotent dtype-widening memo; racing writers store equal lists",
    ("OlapExecutor", "_nan_cols"):
        "idempotent NaN-column memo; racing writers store equal sets",
    ("OlapExecutor", "_devices"):
        "idempotent device-list memo; racing writers store equal tuples",
}

#: Receiver-name -> class-name hints for sites with no annotation to read.
TYPE_HINTS = {
    "shard": "CacheShard",
    "sh": "CacheShard",
    "tenant": "Tenant",
    "t": "Tenant",
    "sub": "OlapExecutor",
    "entry": "CacheEntry",
    "gate": "ReadWriteGate",
    "flight": "Flight",
    "fl": "Flight",
    "cluster": "CacheCluster",
    "store": "TieredStore",
}

#: ReadWriteGate attributes that act as ordering pseudo-locks (held across
#: the gated body; the gate's internal Condition is not).
GATE_PSEUDO_LOCKS = {"write": "ReadWriteGate.write", "read": "ReadWriteGate.read"}

#: Lock classes that may nest instances of themselves in a deterministic
#: instance order (mirrors sanitizer.allow_same_class_order call sites).
SELF_ORDER_OK = {"CacheShard.lock"}

#: (file suffix, frozen class, field) triples allowed to object.__setattr__
#: outside the class's defining module: blessed interning sites.
INTERNING_SITES = {
    ("cluster/cluster.py", "Signature", "_family_hash"),
    # level-lattice memo attached to the frozen schema: an idempotent,
    # schema-pure cache (racing attachers lose at most one warm memo dict)
    ("core/derivations.py", "StarSchema", "_lattice_memo"),
}

#: Owner-only mutable fields of otherwise-shared records: writes allowed
#: only inside the owning module (path suffix).
FROZEN_OWNERS = {
    "CacheEntry": {
        "fields": {"signature", "lru_stamp", "store_stamp"},
        "owner": "core/cache.py",
    },
}

# ------------------------------------------------------------- annotations

_GUARD_RE = re.compile(r"#\s*guarded-by:\s*(.+?)\s*$")
_EXTERNAL_RE = re.compile(r"^external\[(.*)\]$")
_REQUIRES_RE = re.compile(r"#\s*requires-lock:\s*(.+?)\s*$")
_ALLOW_RE = re.compile(r"#\s*analysis:\s*allow\[([\w-]+)\]\s*(.*)$")


@dataclasses.dataclass
class GuardedAttr:
    cls: str
    attr: str
    guard: Optional[str]       # normalized expr ("self._lock"); None if external
    external: Optional[str]    # external[...] description
    file: str
    line: int


@dataclasses.dataclass
class FuncInfo:
    qualname: str              # "CacheShard._shard_op" or module func name
    node: ast.AST              # FunctionDef / AsyncFunctionDef
    cls: Optional[str]
    requires: set
    file: str


@dataclasses.dataclass
class ClassInfo:
    name: str
    file: str
    line: int
    guarded: dict = dataclasses.field(default_factory=dict)   # attr -> GuardedAttr
    locks: dict = dataclasses.field(default_factory=dict)     # attr -> order class
    attr_types: dict = dataclasses.field(default_factory=dict)  # attr -> set[class]
    methods: dict = dataclasses.field(default_factory=dict)   # name -> FuncInfo
    frozen: bool = False
    fields: set = dataclasses.field(default_factory=set)      # dataclass fields

    @property
    def owns_lock(self) -> bool:
        return bool(self.locks)


@dataclasses.dataclass
class ModuleInfo:
    path: str                  # absolute
    rel: str                   # repo-relative, forward slashes
    tree: ast.Module
    lines: list
    classes: dict = dataclasses.field(default_factory=dict)
    functions: dict = dataclasses.field(default_factory=dict)  # module-level
    waivers: dict = dataclasses.field(default_factory=dict)    # line -> set[rule]


@dataclasses.dataclass
class ProjectIndex:
    modules: list
    classes: dict              # class name -> ClassInfo (first definition wins)

    def lookup(self, name: str) -> Optional[ClassInfo]:
        return self.classes.get(name)


# ----------------------------------------------------------- expr helpers

def normalize(expr: ast.AST) -> Optional[str]:
    """Dotted-name form of a Name/Attribute chain, else None."""
    parts = []
    node = expr
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def annotation_classes(node: Optional[ast.AST]) -> set:
    """Class names referenced by a type annotation: handles Name,
    string annotations, Optional[...]/list[...] subscripts, and PEP 604
    unions ("SemanticCache | CacheCluster")."""
    out = set()
    if node is None:
        return out
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        try:
            node = ast.parse(node.value, mode="eval").body
        except SyntaxError:
            return out
    if isinstance(node, ast.Name):
        out.add(node.id)
    elif isinstance(node, ast.Attribute):
        out.add(node.attr)
    elif isinstance(node, ast.BinOp) and isinstance(node.op, ast.BitOr):
        out |= annotation_classes(node.left)
        out |= annotation_classes(node.right)
    elif isinstance(node, ast.Subscript):
        base = node.value
        basename = base.id if isinstance(base, ast.Name) else (
            base.attr if isinstance(base, ast.Attribute) else "")
        if basename in ("Optional", "Union"):
            sl = node.slice
            if isinstance(sl, ast.Tuple):
                for elt in sl.elts:
                    out |= annotation_classes(elt)
            else:
                out |= annotation_classes(sl)
    return out - {"None", "str", "int", "float", "bool", "dict", "list",
                  "set", "tuple", "bytes", "object", "Any"}


def span_lines(lines: list, node: ast.AST) -> list:
    """(lineno, text) pairs for the physical lines a node spans."""
    lo = getattr(node, "lineno", None)
    hi = getattr(node, "end_lineno", lo)
    if lo is None:
        return []
    return [(i, lines[i - 1]) for i in range(lo, min(hi, len(lines)) + 1)]


def _comment_match(lines: list, node: ast.AST, regex: re.Pattern):
    for _, text in span_lines(lines, node):
        m = regex.search(text)
        if m:
            return m
    return None


def _header_lines(lines: list, fn: ast.AST) -> list:
    """Physical lines of a def header (def line through the line before the
    first body statement)."""
    lo = fn.lineno
    hi = fn.body[0].lineno - 1 if fn.body else fn.lineno
    deco_hi = max((getattr(d, "end_lineno", lo) for d in fn.decorator_list),
                  default=lo - 1)
    lo = max(lo, deco_hi + 1) if fn.decorator_list else lo
    return [(i, lines[i - 1]) for i in range(lo, min(hi, len(lines)) + 1)]


def _is_make_lock(call: ast.AST) -> Optional[str]:
    if not isinstance(call, ast.Call):
        return None
    fname = normalize(call.func) or ""
    if fname.split(".")[-1] == "make_lock" and call.args and \
            isinstance(call.args[0], ast.Constant) and \
            isinstance(call.args[0].value, str):
        return call.args[0].value
    return None


def _is_threading_lock(call: ast.AST) -> bool:
    if not isinstance(call, ast.Call):
        return False
    fname = normalize(call.func) or ""
    return fname.split(".")[-1] in ("Lock", "RLock", "Condition")


def waived(module: ModuleInfo, node: ast.AST, rule: str) -> bool:
    for lineno, _ in span_lines(module.lines, node):
        if rule in module.waivers.get(lineno, ()):
            return True
    return False


# ------------------------------------------------------------- the parser

_CTORS = ("__init__", "__post_init__")


def _parse_class(module: ModuleInfo, cdef: ast.ClassDef) -> ClassInfo:
    info = ClassInfo(name=cdef.name, file=module.rel, line=cdef.lineno)
    for deco in cdef.decorator_list:
        call = deco if isinstance(deco, ast.Call) else None
        fname = normalize(call.func if call else deco) or ""
        if fname.split(".")[-1] == "dataclass":
            if call:
                for kw in call.keywords:
                    if kw.arg == "frozen" and isinstance(kw.value, ast.Constant) \
                            and kw.value.value is True:
                        info.frozen = True

    def note_decl(attr: str, stmt: ast.AST) -> None:
        m = _comment_match(module.lines, stmt, _GUARD_RE)
        if not m:
            return
        raw = m.group(1)
        ext = _EXTERNAL_RE.match(raw)
        info.guarded[attr] = GuardedAttr(
            cls=cdef.name, attr=attr,
            guard=None if ext else raw,
            external=ext.group(1) if ext else None,
            file=module.rel, line=stmt.lineno)

    # class-level dataclass fields
    for stmt in cdef.body:
        if isinstance(stmt, ast.AnnAssign) and isinstance(stmt.target, ast.Name):
            attr = stmt.target.id
            info.fields.add(attr)
            info.attr_types[attr] = annotation_classes(stmt.annotation)
            note_decl(attr, stmt)
            # dataclass field lock: default_factory=lambda: make_lock("...")
            if isinstance(stmt.value, ast.Call):
                for kw in stmt.value.keywords:
                    if kw.arg == "default_factory" and \
                            isinstance(kw.value, ast.Lambda):
                        oc = _is_make_lock(kw.value.body)
                        if oc:
                            info.locks[attr] = oc
                        elif _is_threading_lock(kw.value.body):
                            info.locks[attr] = f"{cdef.name}.{attr}"

    # methods
    for stmt in cdef.body:
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
            requires = set()
            for _, text in _header_lines(module.lines, stmt):
                m = _REQUIRES_RE.search(text)
                if m:
                    requires.add(m.group(1))
            info.methods[stmt.name] = FuncInfo(
                qualname=f"{cdef.name}.{stmt.name}", node=stmt,
                cls=cdef.name, requires=requires, file=module.rel)

    # __init__ / __post_init__: self-attr declarations, locks, attr types
    for ctor_name in _CTORS:
        ctor = info.methods.get(ctor_name)
        if ctor is None:
            continue
        params = {}
        for arg in list(ctor.node.args.args) + list(ctor.node.args.kwonlyargs):
            params[arg.arg] = annotation_classes(arg.annotation)
        for stmt in ast.walk(ctor.node):
            targets = []
            value = None
            if isinstance(stmt, ast.Assign):
                targets, value = stmt.targets, stmt.value
            elif isinstance(stmt, ast.AnnAssign):
                targets, value = [stmt.target], stmt.value
            for tgt in targets:
                if not (isinstance(tgt, ast.Attribute) and
                        isinstance(tgt.value, ast.Name) and
                        tgt.value.id == "self"):
                    continue
                attr = tgt.attr
                note_decl(attr, stmt)
                oc = _is_make_lock(value)
                if oc:
                    info.locks[attr] = oc
                elif _is_threading_lock(value):
                    info.locks[attr] = f"{cdef.name}.{attr}"
                if isinstance(stmt, ast.AnnAssign):
                    info.attr_types.setdefault(attr, set()).update(
                        annotation_classes(stmt.annotation))
                if isinstance(value, ast.Call):
                    fname = normalize(value.func) or ""
                    cls_name = fname.split(".")[-1]
                    if cls_name and cls_name[0].isupper():
                        info.attr_types.setdefault(attr, set()).add(cls_name)
                elif isinstance(value, ast.Name) and value.id in params:
                    info.attr_types.setdefault(attr, set()).update(
                        params[value.id])
    return info


def parse_module(path: str, repo_root: str) -> ModuleInfo:
    with open(path, encoding="utf-8") as fh:
        src = fh.read()
    rel = os.path.relpath(path, repo_root).replace(os.sep, "/")
    module = ModuleInfo(path=path, rel=rel, tree=ast.parse(src, filename=path),
                        lines=src.splitlines())
    for lineno, text in enumerate(module.lines, start=1):
        m = _ALLOW_RE.search(text)
        if m:
            module.waivers.setdefault(lineno, set()).add(m.group(1))
    for stmt in module.tree.body:
        if isinstance(stmt, ast.ClassDef):
            module.classes[stmt.name] = _parse_class(module, stmt)
        elif isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
            requires = set()
            for _, text in _header_lines(module.lines, stmt):
                m = _REQUIRES_RE.search(text)
                if m:
                    requires.add(m.group(1))
            module.functions[stmt.name] = FuncInfo(
                qualname=stmt.name, node=stmt, cls=None,
                requires=requires, file=module.rel)
    return module


def build_index(paths: list, repo_root: str) -> ProjectIndex:
    files = []
    for p in paths:
        if os.path.isfile(p):
            files.append(p)
            continue
        for dirpath, dirnames, filenames in os.walk(p):
            dirnames[:] = [d for d in dirnames if d != "__pycache__"]
            for fn in sorted(filenames):
                if fn.endswith(".py"):
                    files.append(os.path.join(dirpath, fn))
    modules = [parse_module(f, repo_root) for f in sorted(set(files))]
    classes: dict = {}
    for mod in modules:
        for name, cinfo in mod.classes.items():
            classes.setdefault(name, cinfo)
    return ProjectIndex(modules=modules, classes=classes)
