"""Render Query ASTs back to SQL text with controllable style.

The variant generator (variants.py) composes AST-level rewrites with these
text-level styles to produce the paper's "systematic SQL variants"
(formatting, alias, predicate-order changes — §5.1).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from ..core import sqlparse as sp


@dataclasses.dataclass(frozen=True)
class Style:
    upper_keywords: bool = True
    newlines: bool = True
    use_as: bool = True  # AS keyword for aliases
    explicit_inner: bool = False  # INNER JOIN vs JOIN
    explicit_asc: bool = False
    leading_comment: Optional[str] = None
    compact: bool = False  # single-space everything
    trailing_semicolon: bool = False


def _kw(style: Style, word: str) -> str:
    return word.upper() if style.upper_keywords else word.lower()


def render_expr(e: sp.Expr, style: Style) -> str:
    if isinstance(e, sp.ColRef):
        return f"{e.table}.{e.column}" if e.table else e.column
    if isinstance(e, sp.Literal):
        if isinstance(e.value, str):
            return "'" + e.value.replace("'", "''") + "'"
        if isinstance(e.value, float) and e.value == int(e.value):
            return str(int(e.value))
        return str(e.value)
    if isinstance(e, sp.BinOp):
        l, r = render_expr(e.left, style), render_expr(e.right, style)
        if isinstance(e.left, sp.BinOp):
            l = f"({l})"
        if isinstance(e.right, sp.BinOp):
            r = f"({r})"
        return f"{l} {e.op} {r}"
    if isinstance(e, sp.AggCall):
        arg = "*" if e.arg is None else render_expr(e.arg, style)
        if e.distinct:
            arg = _kw(style, "distinct") + " " + arg
        return f"{_kw(style, e.func.lower())}({arg})"
    raise TypeError(f"cannot render {e!r}")


def render_predicate(p: sp.Predicate, style: Style) -> str:
    l = render_expr(p.left, style)
    if p.op == "between":
        lo, hi = p.right
        return f"{l} {_kw(style, 'between')} {render_expr(lo, style)} {_kw(style, 'and')} {render_expr(hi, style)}"
    if p.op == "in":
        vals = ", ".join(render_expr(v, style) for v in p.right)
        return f"{l} {_kw(style, 'in')} ({vals})"
    return f"{l} {p.op} {render_expr(p.right, style)}"


def render(q: sp.Query, style: Style = Style()) -> str:
    sep = "\n" if style.newlines and not style.compact else " "
    parts: list[str] = []
    if style.leading_comment:
        # block comments survive single-line layouts; line comments don't
        parts.append(f"/* {style.leading_comment} */")
    sel_items = []
    for item in q.select:
        s = render_expr(item.expr, style)
        if item.alias:
            s += (f" {_kw(style, 'as')} " if style.use_as else " ") + item.alias
        sel_items.append(s)
    parts.append(_kw(style, "select") + " " + ", ".join(sel_items))
    from_part = _kw(style, "from") + " " + q.table
    if q.alias != q.table:
        from_part += (f" {_kw(style, 'as')} " if style.use_as else " ") + q.alias
    parts.append(from_part)
    for j in q.joins:
        jk = _kw(style, "inner join") if style.explicit_inner else _kw(style, "join")
        jt = j.table
        if j.alias != j.table:
            jt += (f" {_kw(style, 'as')} " if style.use_as else " ") + j.alias
        lhs = f"{j.left.table}.{j.left.column}" if j.left.table else j.left.column
        rhs = f"{j.right.table}.{j.right.column}" if j.right.table else j.right.column
        parts.append(f"{jk} {jt} {_kw(style, 'on')} {lhs} = {rhs}")
    if q.where:
        conj = f" {_kw(style, 'and')} ".join(render_predicate(p, style) for p in q.where)
        parts.append(_kw(style, "where") + " " + conj)
    if q.group_by:
        cols = ", ".join(
            (f"{c.table}.{c.column}" if c.table else c.column) for c in q.group_by
        )
        parts.append(_kw(style, "group by") + " " + cols)
    if q.having:
        conj = f" {_kw(style, 'and')} ".join(render_predicate(p, style) for p in q.having)
        parts.append(_kw(style, "having") + " " + conj)
    if q.order_by:
        items = []
        for e, desc in q.order_by:
            s = render_expr(e, style)
            if desc:
                s += " " + _kw(style, "desc")
            elif style.explicit_asc:
                s += " " + _kw(style, "asc")
            items.append(s)
        parts.append(_kw(style, "order by") + " " + ", ".join(items))
    if q.limit is not None:
        parts.append(_kw(style, "limit") + f" {q.limit}")
    sql = sep.join(parts)
    if style.trailing_semicolon:
        sql += ";"
    return sql
