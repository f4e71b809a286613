"""SQL -> OLAP Intent Signature canonicalization (§3.4, SQL path).

Deterministic AST normalization: identifier resolution against the star
schema, commutative predicate/operand ordering, literal canonicalization,
and time-window extraction.  Identical signatures imply identical semantics
under the §3.1 schema conditions.

Raises:
    sqlparse.UnsupportedQuery  — valid SQL outside the subset (cache bypass)
    sqlparse.SQLSyntaxError    — malformed SQL (cache bypass)
    CanonicalizationError      — schema-invalid references (cache bypass)

Request-plane fast path: :class:`SQLCanonicalizer` keeps a **parameterized
template cache**.  The query text is tokenized once into a literal-free
fingerprint plus its literal values; the fingerprint keys a cached slotted
AST (parsed once per template), and each distinct ``(literals, scope)``
binding memoizes its finished, interned :class:`Signature`.  A verbatim
dashboard re-arrival costs one dict probe (tier-0 exact-text memo); a
re-formatted arrival of a known binding costs one tokenize + two dict
probes; a warm-template arrival with fresh literals rebinds the literal
slots into the cached AST and re-runs only ``from_ast``.  The rebound parse
is structurally identical to a cold ``sqlparse.parse`` of the same text
(property-tested), so the fast path can never produce a different signature
than the cold path.
"""
from __future__ import annotations

import datetime as _dt
import re
from collections import OrderedDict
from typing import Optional

from ..analysis.sanitizer import make_lock
from . import sqlparse as sp
from .schema import AmbiguousColumn, StarSchema, UnknownColumn
from .signature import (
    Filter,
    HavingClause,
    Measure,
    OrderKey,
    Signature,
    TimeWindow,
)


class CanonicalizationError(Exception):
    """Schema-invalid SQL (unknown/ambiguous identifiers, bad joins)."""


# ------------------------------------------------------------------ helpers


def _next_day(iso: str) -> str:
    return (_dt.date.fromisoformat(iso) + _dt.timedelta(days=1)).isoformat()


def _month_window(year: int, month: int) -> tuple[str, str]:
    start = _dt.date(year, month, 1)
    end = _dt.date(year + (month == 12), month % 12 + 1, 1)
    return start.isoformat(), end.isoformat()


def _year_window(year: int) -> tuple[str, str]:
    return f"{year:04d}-01-01", f"{year + 1:04d}-01-01"


def _quarter_window(year: int, q: int) -> tuple[str, str]:
    sm = 3 * (q - 1) + 1
    start = _dt.date(year, sm, 1)
    if q == 4:
        end = _dt.date(year + 1, 1, 1)
    else:
        end = _dt.date(year, sm + 3, 1)
    return start.isoformat(), end.isoformat()


_MONTH_NAMES = {
    m.lower(): i + 1
    for i, m in enumerate(
        ["Jan", "Feb", "Mar", "Apr", "May", "Jun", "Jul", "Aug", "Sep", "Oct", "Nov", "Dec"]
    )
}


def _kind_window(kind: str, val) -> Optional[tuple[str, str]]:
    """Window for a single time-level equality value, per declared kind."""
    try:
        if kind == "year":
            return _year_window(int(val))
        if kind == "yearmonthnum":  # e.g. 199702
            v = int(val)
            return _month_window(v // 100, v % 100)
        if kind == "yearmonth_str":  # e.g. 'Mar1994'
            m = re.fullmatch(r"([A-Za-z]{3})\s?(\d{4})", str(val).strip())
            if not m or m.group(1).lower() not in _MONTH_NAMES:
                return None
            return _month_window(int(m.group(2)), _MONTH_NAMES[m.group(1).lower()])
        if kind == "yearquarter_str":  # e.g. '1997Q1'
            m = re.fullmatch(r"(\d{4})\s?Q([1-4])", str(val).strip(), re.IGNORECASE)
            if not m:
                return None
            return _quarter_window(int(m.group(1)), int(m.group(2)))
        if kind == "date":
            d = _dt.date.fromisoformat(str(val).strip())
            return d.isoformat(), _next_day(d.isoformat())
    except (ValueError, TypeError):
        return None
    return None


class _WindowAccum:
    """Intersects time-range constraints into one [start, end) window."""

    def __init__(self):
        self.start: Optional[str] = None
        self.end: Optional[str] = None

    def add(self, start: Optional[str], end: Optional[str]) -> None:
        if start is not None and (self.start is None or start > self.start):
            self.start = start
        if end is not None and (self.end is None or end < self.end):
            self.end = end

    def window(self) -> Optional[TimeWindow]:
        if self.start is None and self.end is None:
            return None
        if self.start is None or self.end is None:
            raise CanonicalizationError(
                "time window does not resolve to concrete [start, end) boundaries"
            )
        if self.end < self.start:
            # an empty window is concrete but selects nothing; normalize
            self.end = self.start
        return TimeWindow(self.start, self.end)


# ------------------------------------------------------------- canonicalizer


class _ParseCtx:
    """Resolution context for one ``from_ast`` invocation (alias map and
    joined-dimension set).  Threaded through the helpers explicitly: the
    canonicalizer instance is shared across request threads, so per-parse
    state must never live on ``self``."""

    __slots__ = ("aliases", "joined")

    def __init__(self, aliases: dict, joined: set):
        self.aliases = aliases
        self.joined = joined


class _Template:
    """One cached query template: the slotted AST plus a bounded LRU memo of
    ``(literal_values, scope) -> Signature`` bindings.  Signatures are frozen
    and interned, so sharing one instance across arrivals is safe (and is
    what makes repeat traffic hash-free)."""

    __slots__ = ("ast", "bindings")

    def __init__(self, ast: sp.Query):
        self.ast = ast
        self.bindings: "OrderedDict[tuple, Signature]" = OrderedDict()


class SQLCanonicalizer:
    def __init__(
        self,
        schema: StarSchema,
        *,
        template_cache: bool = True,
        max_templates: int = 1024,
        max_bindings_per_template: int = 4096,
    ):
        self.schema = schema
        self.template_cache = template_cache
        self.max_templates = max_templates
        self.max_bindings = max_bindings_per_template
        self.max_texts = 4 * max_bindings_per_template
        # one canonicalizer serves every request thread of a tenant (the
        # sharded-cluster regime): the LRU OrderedDicts and counters below
        # are guarded by _lock — move_to_end/popitem on a shared OrderedDict
        # can corrupt its recency list under a data race, not just drop a
        # count.  Parsing and from_ast run *outside* the lock (pure); a lost
        # cold-parse race costs one duplicate parse, never a wrong memo.
        self._lock = make_lock("SQLCanonicalizer._lock")
        self._templates: "OrderedDict[tuple, _Template]" = OrderedDict()  # guarded-by: self._lock
        # tier-0: exact text -> signature (a verbatim dashboard re-arrival
        # skips even tokenization; canonicalization is deterministic, so an
        # identical (text, scope) can only ever produce the identical result)
        self._text_memo: "OrderedDict[tuple, Signature]" = OrderedDict()  # guarded-by: self._lock
        # fast-path counters (surfaced by CacheService.stats())
        self.text_hits = 0  # guarded-by: self._lock
        self.template_hits = 0  # guarded-by: self._lock
        self.template_misses = 0  # guarded-by: self._lock
        self.binding_hits = 0  # guarded-by: self._lock
        self.binding_misses = 0  # guarded-by: self._lock

    # -- public entry
    def canonicalize(self, sql: str, scope: Optional[str] = None) -> Signature:
        if not self.template_cache:
            return self.from_ast(sp.parse(sql), scope=scope)
        tkey = (sql, scope)
        with self._lock:
            sig = self._text_memo.get(tkey)
            if sig is not None:
                self.text_hits += 1  # verbatim repeat: tokenize skipped too
                self._text_memo.move_to_end(tkey)
                return sig
        sig = self._canonicalize_template(sql, scope)
        with self._lock:
            self._text_memo[tkey] = sig
            if len(self._text_memo) > self.max_texts:
                self._text_memo.popitem(last=False)
        return sig

    def _canonicalize_template(self, sql: str, scope: Optional[str]) -> Signature:
        fp, tokens, values = sp.template_of(sql)  # pure: outside the lock
        bkey = (values, scope)
        with self._lock:
            tpl = self._templates.get(fp)
            if tpl is None:
                self.template_misses += 1  # cold tokenize + parse
            else:
                self.template_hits += 1  # fingerprint seen: parse skipped
                self._templates.move_to_end(fp)
                sig = tpl.bindings.get(bkey)
                if sig is not None:
                    self.binding_hits += 1  # memoized: from_ast skipped
                    tpl.bindings.move_to_end(bkey)
                    return sig
        if tpl is None:
            ast = sp.parse_slotted(tokens, sql)  # cold parse, outside the lock
            # cache the template even if from_ast below fails: the *parse* is
            # sound for every text with this fingerprint, and whether a given
            # literal binding canonicalizes (e.g. a time value that folds
            # into a window vs one that doesn't) is decided per binding
            with self._lock:
                tpl = self._templates.get(fp)
                if tpl is None:  # lost parse races adopt the winner's template
                    self._templates[fp] = tpl = _Template(ast)
                    if len(self._templates) > self.max_templates:
                        self._templates.popitem(last=False)
                sig = tpl.bindings.get(bkey)
                if sig is not None:
                    self.binding_hits += 1
                    tpl.bindings.move_to_end(bkey)
                    return sig
        with self._lock:
            self.binding_misses += 1  # warm template, fresh literals
        sig = self.from_ast(sp.bind_slots(tpl.ast, values), scope=scope)
        # only successful canonicalizations are memoized; failures keep
        # raising per arrival exactly like the cold path.  setdefault: a
        # concurrent binder of the same key keeps one canonical instance
        with self._lock:
            sig = tpl.bindings.setdefault(bkey, sig)
            tpl.bindings.move_to_end(bkey)
            if len(tpl.bindings) > self.max_bindings:
                tpl.bindings.popitem(last=False)
        return sig

    def template_stats(self) -> dict:
        """Template-cache counters: per-arrival outcome totals plus the
        current footprint (templates held, bindings memoized)."""
        with self._lock:
            return {
                "text_hits": self.text_hits,
                "template_hits": self.template_hits,
                "template_misses": self.template_misses,
                "binding_hits": self.binding_hits,
                "binding_misses": self.binding_misses,
                "templates": len(self._templates),
                "bindings": sum(len(t.bindings)
                                for t in self._templates.values()),
            }

    def from_ast(self, q: sp.Query, scope: Optional[str] = None) -> Signature:
        sch = self.schema
        # ---- table/alias resolution.  FROM must be the fact table; each JOIN
        # must follow a schema-declared FK->PK path to a distinct dimension.
        if q.table != sch.fact.name:
            raise CanonicalizationError(
                f"FROM {q.table!r} is not the fact table {sch.fact.name!r}"
            )
        alias_to_table: dict[str, str] = {q.alias: sch.fact.name}
        joined_dims: set[str] = set()
        for j in q.joins:
            dim = sch.dimension(j.table)
            if dim is None:
                if j.table == sch.fact.name:
                    raise sp.UnsupportedQuery("self-joins are outside the OLAP subset")
                raise CanonicalizationError(f"JOIN target {j.table!r} is not a dimension")
            if dim.name in joined_dims:
                raise sp.UnsupportedQuery(
                    f"dimension {dim.name!r} joined twice (role-playing) — bypass"
                )
            if j.alias in alias_to_table:
                raise CanonicalizationError(f"duplicate alias {j.alias!r}")
            # normalize ON order: fact.fk = dim.pk
            l_tab = self._table_of(j.left, alias_to_table, extra={j.alias: dim.name})
            r_tab = self._table_of(j.right, alias_to_table, extra={j.alias: dim.name})
            pair = {(l_tab, j.left.column), (r_tab, j.right.column)}
            want = {(sch.fact.name, dim.fact_fk), (dim.name, dim.pk)}
            if pair != want:
                raise CanonicalizationError(
                    f"join condition {pair} does not follow the schema FK path {want}"
                )
            alias_to_table[j.alias] = dim.name
            joined_dims.add(dim.name)
        # parse-scoped resolution context: threaded through the helpers
        # rather than stored on the (shared, concurrently-used) instance
        ctx = _ParseCtx(aliases=alias_to_table, joined=joined_dims)

        # ---- measures and grouping levels from the SELECT list
        measures: list[Measure] = []
        alias_to_measure: dict[str, int] = {}
        expr_to_measure: dict[str, int] = {}
        select_levels: list[str] = []
        for item in q.select:
            if isinstance(item.expr, sp.AggCall):
                m = self._measure(item.expr, ctx)
                idx = len(measures)
                measures.append(m)
                if item.alias:
                    alias_to_measure[item.alias] = idx
                expr_to_measure[f"{m.agg}|{m.expr}|{m.distinct}"] = idx
            elif isinstance(item.expr, sp.ColRef):
                select_levels.append(self._qualify(item.expr, ctx))
            else:
                raise sp.UnsupportedQuery(
                    "non-aggregate SELECT expressions are outside the OLAP subset"
                )
        if not measures:
            raise sp.UnsupportedQuery("queries without aggregation are outside the OLAP subset")

        group_levels = [self._qualify(c, ctx) for c in q.group_by]
        if set(select_levels) - set(group_levels):
            raise CanonicalizationError(
                "SELECT columns not covered by GROUP BY: "
                f"{sorted(set(select_levels) - set(group_levels))}"
            )

        # ---- filters & time window
        filters: list[Filter] = []
        wacc = _WindowAccum()
        for p in q.where:
            self._classify_predicate(p, filters, wacc, ctx)
        tw = wacc.window()

        # ---- HAVING over selected measures
        having: list[HavingClause] = []
        for p in q.having:
            having.append(
                self._having(p, alias_to_measure, expr_to_measure, ctx))

        # ---- ORDER BY / LIMIT
        order: list[OrderKey] = []
        for expr, desc in q.order_by:
            if isinstance(expr, sp.AggCall):
                m = self._measure(expr, ctx)
                k = f"{m.agg}|{m.expr}|{m.distinct}"
                if k not in expr_to_measure:
                    raise CanonicalizationError("ORDER BY aggregate not in SELECT")
                order.append(OrderKey(f"measure:{expr_to_measure[k]}", desc))
            elif isinstance(expr, sp.ColRef):
                name = expr.column
                if expr.table is None and name in alias_to_measure:
                    order.append(OrderKey(f"measure:{alias_to_measure[name]}", desc))
                else:
                    lv = self._qualify(expr, ctx)
                    if lv not in group_levels:
                        raise CanonicalizationError(f"ORDER BY {lv} not in GROUP BY")
                    order.append(OrderKey(lv, desc))
            else:
                raise sp.UnsupportedQuery("ORDER BY expression outside the OLAP subset")
        if q.limit is not None and not order:
            raise sp.UnsupportedQuery("LIMIT without ORDER BY is non-deterministic — bypass")

        return Signature(
            schema=sch.name,
            measures=tuple(measures),
            levels=tuple(group_levels),
            filters=tuple(filters),
            time_window=tw,
            having=tuple(having),
            order_by=tuple(order),
            limit=q.limit,
            scope=scope,
        )

    # ------------------------------------------------------------ resolution
    def _table_of(self, c: sp.ColRef, aliases: dict[str, str], extra=None) -> str:
        look = dict(aliases)
        if extra:
            look.update(extra)
        if c.table is not None:
            if c.table in look:
                return look[c.table]
            if c.table in self.schema.tables():
                return c.table
            raise CanonicalizationError(f"unknown table/alias {c.table!r}")
        try:
            t, _ = self.schema.resolve_column(c.column)
        except (AmbiguousColumn, UnknownColumn) as e:
            raise CanonicalizationError(str(e)) from e
        return t

    def _qualify(self, c: sp.ColRef, ctx: "_ParseCtx") -> str:
        """Resolve a column ref to canonical 'table.column'."""
        t = self._table_of(c, ctx.aliases)
        try:
            t2, col = self.schema.resolve_column(c.column, table=t)
        except (AmbiguousColumn, UnknownColumn) as e:
            raise CanonicalizationError(str(e)) from e
        if t2 != self.schema.fact.name and t2 not in ctx.joined:
            raise CanonicalizationError(
                f"column {t2}.{col.name} referenced without joining {t2!r}"
            )
        return f"{t2}.{col.name}"

    # ----------------------------------------------------------- expressions
    def _canon_expr(self, e: sp.Expr, ctx: "_ParseCtx") -> str:
        """Canonical expression string: fully-qualified identifiers, sorted
        operands under commutative ops, canonical literal formats."""
        if isinstance(e, sp.ColRef):
            return self._qualify(e, ctx)
        if isinstance(e, sp.Literal):
            v = e.value
            if isinstance(v, float) and v == int(v):
                return str(int(v))
            return repr(v) if isinstance(v, str) else str(v)
        if isinstance(e, sp.BinOp):
            l, r = self._canon_expr(e.left, ctx), self._canon_expr(e.right, ctx)
            if e.op in ("+", "*"):
                # flatten same-op chains and sort operands
                parts = sorted(self._flatten(e, e.op, ctx))
                return "(" + e.op.join(parts) + ")"
            return f"({l}{e.op}{r})"
        raise sp.UnsupportedQuery("aggregate nested inside expression")

    def _flatten(self, e: sp.Expr, op: str, ctx: "_ParseCtx") -> list[str]:
        if isinstance(e, sp.BinOp) and e.op == op:
            return self._flatten(e.left, op, ctx) + \
                self._flatten(e.right, op, ctx)
        return [self._canon_expr(e, ctx)]

    def _measure(self, a: sp.AggCall, ctx: "_ParseCtx") -> Measure:
        if a.arg is None:  # COUNT(*)
            return Measure("COUNT", "*", distinct=False)
        expr = self._canon_expr(a.arg, ctx)
        if a.distinct and a.func != "COUNT":
            raise sp.UnsupportedQuery(f"{a.func}(DISTINCT …) is outside the OLAP subset")
        self._check_measure_types(a, ctx)
        return Measure(a.func, expr, distinct=a.distinct)

    def _check_measure_types(self, a: sp.AggCall, ctx: "_ParseCtx") -> None:
        """Aggregations besides COUNT require numeric arguments."""
        if a.func == "COUNT":
            return

        def visit(e: sp.Expr) -> None:
            if isinstance(e, sp.ColRef):
                t = self._table_of(e, ctx.aliases)
                _, col = self.schema.resolve_column(e.column, table=t)
                if not col.is_numeric():
                    raise CanonicalizationError(
                        f"{a.func} over non-numeric column {t}.{col.name}"
                    )
            elif isinstance(e, sp.BinOp):
                visit(e.left)
                visit(e.right)

        visit(a.arg)

    # ------------------------------------------------------------ predicates
    def _classify_predicate(
        self, p: sp.Predicate, filters: list[Filter], wacc: _WindowAccum,
        ctx: "_ParseCtx"
    ) -> None:
        left, op, right = p.left, p.op, p.right
        # normalize literal-on-left comparisons
        if isinstance(left, sp.Literal) and isinstance(right, sp.ColRef):
            left, right = right, left
            op = {"<": ">", ">": "<", "<=": ">=", ">=": "<="}.get(op, op)
        if not isinstance(left, sp.ColRef):
            raise sp.UnsupportedQuery("predicate left side must be a column")
        col = self._qualify(left, ctx)
        tab, cname = col.split(".", 1)
        kind = self._time_kind(tab, cname)
        if kind is not None and self._try_time(col, kind, op, right, wacc):
            return
        # ordinary filter
        if op == "between":
            lo, hi = right
            filters.append(Filter(col, ">=", lo.value))
            filters.append(Filter(col, "<=", hi.value))
            return
        if op == "in":
            filters.append(Filter(col, "in", [l.value for l in right]))
            return
        if not isinstance(right, sp.Literal):
            raise sp.UnsupportedQuery("column-to-column predicates are outside the OLAP subset")
        filters.append(Filter(col, op, right.value))

    def _time_kind(self, tab: str, col: str) -> Optional[str]:
        if tab == self.schema.fact.name:
            if col == self.schema.fact.date_column:
                return "date"
            return None
        d = self.schema.dimension(tab)
        if d is None or tab != self.schema.time_dimension:
            return None
        return d.time_kind(col)

    def _try_time(self, col, kind, op, right, wacc: _WindowAccum) -> bool:
        """Fold a time predicate into the window accumulator.  Returns False
        when the predicate is time-typed but not range-expressible (it then
        stays an ordinary filter, which is still exact)."""
        def one(v):
            return _kind_window(kind, v)

        if op == "=":
            if not isinstance(right, sp.Literal):
                return False
            w = one(right.value)
            if w is None:
                return False
            wacc.add(*w)
            return True
        if op == "between":
            lo, hi = right
            wl, wh = one(lo.value), one(hi.value)
            if wl is None or wh is None:
                return False
            wacc.add(wl[0], wh[1])
            return True
        if op in ("<", "<=", ">", ">="):
            if not isinstance(right, sp.Literal):
                return False
            w = one(right.value)
            if w is None:
                return False
            start, end = w
            if op == ">=":
                wacc.add(start, None)
            elif op == ">":
                wacc.add(end, None)
            elif op == "<":
                wacc.add(None, start)
            else:  # <=
                wacc.add(None, end)
            return True
        return False  # 'in' over time levels stays an ordinary filter

    # --------------------------------------------------------------- having
    def _having(self, p: sp.Predicate, alias_idx, expr_idx,
                ctx: "_ParseCtx") -> HavingClause:
        left, op, right = p.left, p.op, p.right
        if op in ("between", "in"):
            raise sp.UnsupportedQuery("HAVING BETWEEN/IN is outside the OLAP subset")
        if isinstance(left, sp.Literal) and not isinstance(right, sp.Literal):
            left, right = right, left
            op = {"<": ">", ">": "<", "<=": ">=", ">=": "<="}.get(op, op)
        if not isinstance(right, sp.Literal):
            raise sp.UnsupportedQuery("HAVING must compare a measure to a literal")
        if isinstance(left, sp.AggCall):
            m = self._measure(left, ctx)
            k = f"{m.agg}|{m.expr}|{m.distinct}"
            if k not in expr_idx:
                raise CanonicalizationError("HAVING aggregate not in SELECT")
            return HavingClause(expr_idx[k], op, right.value)
        if isinstance(left, sp.ColRef) and left.table is None and left.column in alias_idx:
            return HavingClause(alias_idx[left.column], op, right.value)
        raise CanonicalizationError("HAVING must reference a selected measure")
