"""Systematic SQL variant generation (§5.1: 21 variants per canonical intent).

AST-level rewrites (alias renaming, predicate/join/group-by reordering,
BETWEEN <-> inequality pairs, single-element IN <-> equality, commutative
operand swaps, time-dimension <-> raw-date-range predicates) composed with
text-level styles (keyword case, layout, AS/INNER/ASC toggles, comments).
Every variant is verified to canonicalize to the *same* intent signature as
the canonical query — they are surface forms of one intent, which is what
makes ground-truth hit-rate measurement possible.
"""
from __future__ import annotations

import dataclasses
import datetime as _dt
import itertools
import random
from typing import Callable

from ..core import sqlparse as sp
from ..core.schema import StarSchema
from ..core.sql_canon import SQLCanonicalizer
from .render import Style, render

# ---------------------------------------------------------- AST-level rewrites


def rename_aliases(q: sp.Query, naming: str) -> sp.Query:
    """naming: 'long' (table-name aliases) or 'tN' (positional)."""
    mapping: dict[str, str] = {}
    if naming == "long":
        mapping[q.alias] = q.table
        for j in q.joins:
            mapping[j.alias] = j.table
    else:
        mapping[q.alias] = "t0"
        for i, j in enumerate(q.joins):
            mapping[j.alias] = f"t{i + 1}"

    def fix_col(c: sp.ColRef) -> sp.ColRef:
        if c.table is not None and c.table in mapping:
            return sp.ColRef(mapping[c.table], c.column)
        return c

    def fix_expr(e: sp.Expr) -> sp.Expr:
        if isinstance(e, sp.ColRef):
            return fix_col(e)
        if isinstance(e, sp.BinOp):
            return sp.BinOp(e.op, fix_expr(e.left), fix_expr(e.right))
        if isinstance(e, sp.AggCall):
            return sp.AggCall(e.func, None if e.arg is None else fix_expr(e.arg), e.distinct)
        return e

    def fix_pred(p: sp.Predicate) -> sp.Predicate:
        right = p.right
        if isinstance(right, sp.ColRef):
            right = fix_col(right)
        elif isinstance(right, (sp.BinOp,)):
            right = fix_expr(right)
        return sp.Predicate(fix_expr(p.left), p.op, right)

    return sp.Query(
        select=tuple(sp.SelectItem(fix_expr(s.expr), s.alias) for s in q.select),
        table=q.table,
        alias=mapping[q.alias],
        joins=tuple(
            sp.Join(j.table, mapping[j.alias], fix_col(j.left), fix_col(j.right))
            for j in q.joins
        ),
        where=tuple(fix_pred(p) for p in q.where),
        group_by=tuple(fix_col(c) for c in q.group_by),
        having=tuple(fix_pred(p) for p in q.having),
        order_by=tuple((fix_expr(e), d) for e, d in q.order_by),
        limit=q.limit,
    )


def shuffle_predicates(q: sp.Query, seed: int) -> sp.Query:
    where = list(q.where)
    random.Random(seed).shuffle(where)
    return dataclasses.replace(q, where=tuple(where))


def shuffle_joins(q: sp.Query, seed: int) -> sp.Query:
    joins = list(q.joins)
    random.Random(seed).shuffle(joins)
    return dataclasses.replace(q, joins=tuple(joins))


def shuffle_group_by(q: sp.Query, seed: int) -> sp.Query:
    g = list(q.group_by)
    random.Random(seed).shuffle(g)
    return dataclasses.replace(q, group_by=tuple(g))


def between_to_ineq(q: sp.Query) -> sp.Query:
    out = []
    for p in q.where:
        if p.op == "between":
            lo, hi = p.right
            out.append(sp.Predicate(p.left, ">=", lo))
            out.append(sp.Predicate(p.left, "<=", hi))
        else:
            out.append(p)
    return dataclasses.replace(q, where=tuple(out))


def eq_to_in(q: sp.Query) -> sp.Query:
    """x = v  ->  x IN (v): same semantics, different surface form."""
    out = []
    changed = False
    for p in q.where:
        if p.op == "=" and isinstance(p.right, sp.Literal) and not changed:
            out.append(sp.Predicate(p.left, "in", [p.right]))
            changed = True
        else:
            out.append(p)
    return dataclasses.replace(q, where=tuple(out))


def swap_comparison_sides(q: sp.Query) -> sp.Query:
    """quantity < 25  ->  25 > quantity (first applicable predicate)."""
    flip = {"<": ">", ">": "<", "<=": ">=", ">=": "<=", "=": "=", "!=": "!="}
    out = []
    changed = False
    for p in q.where:
        if (
            not changed
            and p.op in flip
            and isinstance(p.right, sp.Literal)
            and isinstance(p.left, sp.ColRef)
        ):
            out.append(sp.Predicate(p.right, flip[p.op], p.left))
            changed = True
        else:
            out.append(p)
    return dataclasses.replace(q, where=tuple(out))


def commute_expressions(q: sp.Query) -> sp.Query:
    """Swap operands of commutative ops inside measure expressions."""

    def fix(e: sp.Expr) -> sp.Expr:
        if isinstance(e, sp.BinOp):
            l, r = fix(e.left), fix(e.right)
            if e.op in ("*", "+"):
                return sp.BinOp(e.op, r, l)
            return sp.BinOp(e.op, l, r)
        if isinstance(e, sp.AggCall) and e.arg is not None:
            return sp.AggCall(e.func, fix(e.arg), e.distinct)
        return e

    return dataclasses.replace(
        q, select=tuple(sp.SelectItem(fix(s.expr), s.alias) for s in q.select)
    )


def time_level_to_date_range(q: sp.Query, schema: StarSchema) -> sp.Query | None:
    """Rewrite a time-dimension level predicate (d_year = 1997) into the
    equivalent raw-date-range predicate on the fact date column.  Returns None
    when not applicable (no such predicate / no fact date column)."""
    if schema.fact.date_column is None or schema.time_dimension is None:
        return None
    tdim = schema.dimension(schema.time_dimension)
    alias_to_table = {q.alias: q.table, **{j.alias: j.table for j in q.joins}}
    from ..core.sql_canon import _kind_window  # shared canonical window logic

    fact_alias = q.alias
    out, found = [], False
    for p in q.where:
        if (
            not found
            and isinstance(p.left, sp.ColRef)
            and isinstance(p.right, sp.Literal)
            and p.op == "="
        ):
            tab = alias_to_table.get(p.left.table, p.left.table) if p.left.table else None
            if tab is None:
                try:
                    tab, _ = schema.resolve_column(p.left.column)
                except Exception:
                    tab = None
            if tab == tdim.name:
                kind = tdim.time_kind(p.left.column)
                if kind:
                    w = _kind_window(kind, p.right.value)
                    if w:
                        start, end = w
                        dcol = sp.ColRef(fact_alias, schema.fact.date_column)
                        out.append(sp.Predicate(dcol, ">=", sp.Literal(start)))
                        out.append(sp.Predicate(dcol, "<", sp.Literal(end)))
                        found = True
                        continue
        out.append(p)
    if not found:
        return None
    return dataclasses.replace(q, where=tuple(out))


# ------------------------------------------------------------- the generator

AstRewrite = Callable[[sp.Query], sp.Query]


def make_variants(canonical_sql: str, schema: StarSchema, n: int = 21, seed: int = 0):
    """Produce ``n`` SQL texts (the canonical query first) that all
    canonicalize to the same intent signature."""
    base = sp.parse(canonical_sql)
    canon = SQLCanonicalizer(schema)
    want_key = canon.from_ast(base).key()

    ast_forms: list[sp.Query] = [base]

    def add(q: sp.Query | None):
        if q is None:
            return
        try:
            if canon.from_ast(q).key() == want_key:
                ast_forms.append(q)
        except Exception:
            pass

    add(rename_aliases(base, "long"))
    add(rename_aliases(base, "tN"))
    add(shuffle_predicates(base, seed + 1))
    add(shuffle_predicates(base, seed + 2))
    add(shuffle_joins(base, seed + 3))
    add(shuffle_group_by(base, seed + 4))
    add(between_to_ineq(base))
    add(eq_to_in(base))
    add(swap_comparison_sides(base))
    add(commute_expressions(base))
    add(time_level_to_date_range(base, schema))
    add(shuffle_predicates(rename_aliases(base, "long"), seed + 5))
    add(between_to_ineq(rename_aliases(base, "tN")))
    add(commute_expressions(shuffle_predicates(base, seed + 6)))

    styles = [
        Style(),
        Style(upper_keywords=False),
        Style(newlines=False),
        Style(use_as=False),
        Style(explicit_inner=True),
        Style(explicit_asc=True, trailing_semicolon=True),
        Style(leading_comment="dashboard tile 7", compact=True),
        Style(upper_keywords=False, use_as=False, newlines=False),
    ]

    texts: list[str] = []
    seen: set[str] = set()
    for ast, style in itertools.product(ast_forms, styles):
        t = render(ast, style)
        if t not in seen:
            seen.add(t)
            texts.append(t)
        if len(texts) >= 4 * n:
            break
    # deterministic selection: canonical first, then spread across the list
    rnd = random.Random(seed + 99)
    rest = texts[1:]
    rnd.shuffle(rest)
    out = [texts[0]] + rest[: n - 1]
    while len(out) < n:  # degenerate intents with few distinct forms
        out.append(texts[0])
    # ground-truth guarantee
    for t in out:
        k = canon.canonicalize(t).key()
        assert k == want_key, f"variant diverged from intent:\n{t}"
    return out


_WINDOW_KIND_IMPORT_GUARD = _dt.date  # keep datetime import (used by rewrites)
