"""Signature validation against the star schema (§3.5).

Before any reuse we validate that (1) all referenced measures/dimensions exist
and pass type checks, (2) the time window resolves to concrete boundaries,
(3) the implied join path is unique within the schema, and (4) unsupported
constructs trigger bypass.  Validation failures never raise out of
``validate`` — they return a structured report the middleware turns into a
conservative bypass (prefer misses over incorrect reuse).

This is the safety backstop for the NL path: LLM-emitted signatures are
arbitrary JSON and get *exactly* the same checks as SQL-derived ones.
"""
from __future__ import annotations

import dataclasses
import datetime as _dt
from collections import OrderedDict
from typing import Optional

from . import sqlparse as sp
from .schema import AmbiguousColumn, StarSchema, UnknownColumn
from .signature import Signature


@dataclasses.dataclass
class ValidationResult:
    ok: bool
    reasons: tuple[str, ...] = ()

    def __bool__(self) -> bool:
        return self.ok


class SignatureValidator:
    def __init__(self, schema: StarSchema, memo_capacity: int = 8192):
        self.schema = schema
        # validation is a pure function of (schema, signature) and the schema
        # is fixed per validator, so results are memoized by signature value:
        # repeat dashboard intents (the request-plane hot path) pay one dict
        # probe instead of re-parsing every measure expression
        self._memo: "OrderedDict[Signature, ValidationResult]" = OrderedDict()
        self._memo_capacity = memo_capacity

    # ------------------------------------------------------------------ api
    def validate(self, sig: Signature) -> ValidationResult:
        if self._memo_capacity <= 0:  # memo disabled (benchmark baseline)
            return self._validate(sig)
        cached = self._memo.get(sig)
        if cached is not None:
            self._memo.move_to_end(sig)
            return cached
        result = self._validate(sig)
        self._memo[sig] = result
        if len(self._memo) > self._memo_capacity:
            self._memo.popitem(last=False)
        return result

    def _validate(self, sig: Signature) -> ValidationResult:
        reasons: list[str] = []
        if sig.schema != self.schema.name:
            return ValidationResult(False, (f"schema mismatch: {sig.schema!r}",))
        for m in sig.measures:
            reasons.extend(self._check_measure(m.agg, m.expr, m.distinct))
        for lv in sig.levels:
            reasons.extend(self._check_level(lv))
        for f in sig.filters:
            reasons.extend(self._check_filter(f.col, f.op, f.val))
        reasons.extend(self._check_time_window(sig))
        for h in sig.having:
            if not (0 <= h.measure < len(sig.measures)):
                reasons.append(f"HAVING references measure {h.measure} out of range")
        for o in sig.order_by:
            if o.key.startswith("measure:"):
                try:
                    idx = int(o.key.split(":", 1)[1])
                except ValueError:
                    reasons.append(f"bad order key {o.key!r}")
                    continue
                if not (0 <= idx < len(sig.measures)):
                    reasons.append(f"ORDER BY measure {idx} out of range")
            elif o.key not in sig.levels:
                reasons.append(f"ORDER BY {o.key!r} not among grouping levels")
        if sig.limit is not None and (not sig.order_by or sig.limit < 0):
            reasons.append("LIMIT requires ORDER BY and a non-negative bound")
        # join-path uniqueness: every referenced dimension must exist and be
        # reachable by its single declared FK (guaranteed by schema.validate();
        # here we confirm references only name declared dimensions).
        for t in self._referenced_tables(sig):
            if t != self.schema.fact.name and self.schema.dimension(t) is None:
                reasons.append(f"no unique join path to unknown table {t!r}")
        return ValidationResult(not reasons, tuple(reasons))

    # ------------------------------------------------------------- internals
    def _referenced_tables(self, sig: Signature) -> set[str]:
        tabs: set[str] = set()
        for lv in sig.levels:
            if "." in lv:
                tabs.add(lv.split(".", 1)[0])
        for f in sig.filters:
            if "." in f.col:
                tabs.add(f.col.split(".", 1)[0])
        for m in sig.measures:
            if m.expr != "*":
                try:
                    for t in self._expr_tables(sp.parse_expr(m.expr)):
                        tabs.add(t)
                except (sp.SQLSyntaxError, sp.UnsupportedQuery):
                    pass
        return tabs

    def _expr_tables(self, e: sp.Expr) -> set[str]:
        if isinstance(e, sp.ColRef):
            return {e.table} if e.table else set()
        if isinstance(e, sp.BinOp):
            return self._expr_tables(e.left) | self._expr_tables(e.right)
        return set()

    def _check_measure(self, agg: str, expr: str, distinct: bool) -> list[str]:
        if expr == "*":
            if agg != "COUNT":
                return [f"{agg}(*) is invalid"]
            return []
        try:
            ast = sp.parse_expr(expr)
        except (sp.SQLSyntaxError, sp.UnsupportedQuery) as e:
            return [f"measure expression {expr!r}: {e}"]
        errs: list[str] = []

        def visit(node: sp.Expr) -> None:
            if isinstance(node, sp.ColRef):
                try:
                    t, col = self.schema.resolve_column(node.column, table=node.table)
                except (AmbiguousColumn, UnknownColumn) as e:
                    errs.append(str(e))
                    return
                if agg != "COUNT" and not col.is_numeric():
                    errs.append(f"{agg} over non-numeric {t}.{col.name}")
            elif isinstance(node, sp.BinOp):
                visit(node.left)
                visit(node.right)
            elif isinstance(node, sp.AggCall):
                errs.append("nested aggregate in measure expression")

        visit(ast)
        return errs

    def _check_level(self, level: str) -> list[str]:
        if "." not in level:
            return [f"grouping level {level!r} is not table-qualified"]
        t, c = level.split(".", 1)
        try:
            self.schema.resolve_column(c, table=t)
        except (AmbiguousColumn, UnknownColumn) as e:
            return [str(e)]
        return []

    def _check_filter(self, col: str, op: str, val) -> list[str]:
        if "." not in col:
            return [f"filter column {col!r} is not table-qualified"]
        t, c = col.split(".", 1)
        try:
            _, column = self.schema.resolve_column(c, table=t)
        except (AmbiguousColumn, UnknownColumn) as e:
            return [str(e)]
        # type check: comparisons on numeric columns need numeric literals
        vals = list(val) if isinstance(val, (list, tuple)) else [val]
        for v in vals:
            if column.is_numeric() and isinstance(v, str):
                return [f"filter {col} {op} {v!r}: string literal on numeric column"]
            if column.dtype == "str" and isinstance(v, (int, float)):
                return [f"filter {col} {op} {v!r}: numeric literal on string column"]
            if column.dtype == "date":
                try:
                    _dt.date.fromisoformat(str(v))
                except ValueError:
                    return [f"filter {col} {op} {v!r}: not an ISO date"]
        return []

    def _check_time_window(self, sig: Signature) -> list[str]:
        tw = sig.time_window
        if tw is None:
            return []
        try:
            s = _dt.date.fromisoformat(tw.start)
            e = _dt.date.fromisoformat(tw.end)
        except ValueError:
            return [f"time window boundaries not concrete ISO dates: {tw}"]
        if e < s:
            return [f"time window end before start: {tw}"]
        if self.schema.fact.date_column is None and self.schema.time_dimension is None:
            return ["schema has no time dimension but signature has a time window"]
        return []
