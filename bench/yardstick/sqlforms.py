"""SQL text for a structured intent in one of 21 surface forms.

A frozen copy, with changes, of the port's variant renderer
(``src/repro_torch/workloads/variants.py`` with ``render.py``): the same
AST-level rewrites (alias renaming, predicate, join and group-by
reordering, BETWEEN as two inequalities, one equality as a one-element IN,
a comparison with its sides swapped, commuted measure operands, the time
level as a range on the fact table's date column) composed with the same
eight text styles (keyword case, layout, AS and INNER JOIN toggles, ASC and
a trailing semicolon, a leading comment).  What was changed: it renders
from :class:`flights.Intent` directly, without the port's SQL parser or
canonicalizer, so that a fault there shows as a wrong answer and not as
a missing form; form ``f`` is one fixed (rewrite, style) pair, so drawing a
form costs one rendering; and where a rewrite does not apply to an intent
its form is the canonical text in that style.
"""
from __future__ import annotations

import dataclasses
import random

from .flights import MEASURES, Intent, Pred
from .ssbgen import MONTHS

N_FORMS = 21
FACT = "lineorder"
JOIN_KEYS = {"dates": ("lo_orderdate", "d_key"), "customer": ("lo_custkey", "c_key"),
             "supplier": ("lo_suppkey", "s_key"), "part": ("lo_partkey", "p_key")}
SHORT = {"lineorder": "lo", "dates": "d", "customer": "c", "supplier": "s", "part": "p"}


@dataclasses.dataclass(frozen=True)
class Style:
    upper_keywords: bool = True
    newlines: bool = True
    use_as: bool = True
    explicit_inner: bool = False
    explicit_asc: bool = False
    leading_comment: str | None = None
    compact: bool = False
    trailing_semicolon: bool = False


STYLES = (
    Style(),
    Style(upper_keywords=False),
    Style(newlines=False),
    Style(use_as=False),
    Style(explicit_inner=True),
    Style(explicit_asc=True, trailing_semicolon=True),
    Style(leading_comment="dashboard tile 7", compact=True),
    Style(upper_keywords=False, use_as=False, newlines=False),
)
REWRITES = ("canonical", "alias_short", "alias_positional", "shuffle_preds_a",
            "shuffle_preds_b", "reverse_joins", "reverse_group_by", "between_as_ineq",
            "eq_as_in", "swap_sides", "commute_measure", "time_as_date_range")


def form_of(f: int) -> tuple[str, Style]:
    """Form ``f`` (0 to 20): rewrite ``f mod 12`` in a style that differs
    between the first and the second pass over the rewrites."""
    if not 0 <= f < N_FORMS:
        raise ValueError(f"form {f} outside 0..{N_FORMS - 1}")
    return REWRITES[f % len(REWRITES)], STYLES[(f + 5 * (f // len(REWRITES))) % len(STYLES)]


def _kw(st: Style, w: str) -> str:
    return w.upper() if st.upper_keywords else w.lower()


def _lit(v) -> str:
    if isinstance(v, str):
        return "'" + v.replace("'", "''") + "'"
    return str(v)


def _month_range(y: int, m: int) -> tuple[str, str]:
    y2, m2 = (y, m + 1) if m < 12 else (y + 1, 1)
    return f"{y:04d}-{m:02d}-01", f"{y2:04d}-{m2:02d}-01"


def _date_range(p: Pred) -> tuple[str, str] | None:
    """[start, end) of a time-level predicate, as ISO dates."""
    if p.col == "dates.d_year" and p.op == "=":
        return f"{p.val[0]}-01-01", f"{p.val[0] + 1}-01-01"
    if p.col == "dates.d_year" and p.op == "between":
        return f"{p.val[0]}-01-01", f"{p.val[1] + 1}-01-01"
    if p.col == "dates.d_yearmonthnum" and p.op == "=":
        return _month_range(p.val[0] // 100, p.val[0] % 100)
    if p.col == "dates.d_yearmonth" and p.op == "=":
        return _month_range(int(p.val[0][3:]), MONTHS.index(p.val[0][:3]) + 1)
    return None


def render(it: Intent, f: int) -> str:
    """SQL text of intent ``it`` in form ``f``."""
    rw, st = form_of(f)
    rnd = random.Random(f"{rw}|{it.flight}")
    tables = [FACT] + sorted({c.split(".")[0] for c in it.levels + tuple(p.col for p in it.preds)
                              if c.split(".")[0] != FACT})
    if rw == "alias_short":
        alias = dict(SHORT)
    elif rw == "alias_positional":
        alias = {t: f"t{i}" for i, t in enumerate(tables)}
    else:
        alias = {t: t for t in tables}
    qualify = rw in ("alias_short", "alias_positional")

    def col(q: str) -> str:
        t, c = q.split(".")
        return f"{alias[t]}.{c}" if qualify else c

    def expr(e) -> str:
        if isinstance(e, str):
            return col(e)
        op, a, b = e
        if rw == "commute_measure" and op in ("*", "+"):
            a, b = b, a
        return f"{expr(a)} {op} {expr(b)}"

    preds: list[tuple[str, str, tuple]] = []  # (column text, op, literals)
    for p in it.preds:
        rng = _date_range(p) if rw == "time_as_date_range" else None
        if rng is not None:
            dcol = f"{alias[FACT]}.lo_date" if qualify else "lo_date"
            preds += [(dcol, ">=", (rng[0],)), (dcol, "<", (rng[1],))]
        elif p.op == "between" and rw == "between_as_ineq":
            preds += [(col(p.col), ">=", (p.val[0],)), (col(p.col), "<=", (p.val[1],))]
        else:
            preds.append((col(p.col), p.op, p.val))
    if rw == "eq_as_in":
        for i, (c, op, v) in enumerate(preds):
            if op == "=":
                preds[i] = (c, "in", v)
                break
    if rw in ("shuffle_preds_a", "shuffle_preds_b"):
        rnd.shuffle(preds)
    swap = next((i for i, (_, op, _) in enumerate(preds) if op not in ("between", "in")),
                None) if rw == "swap_sides" else None

    def pred_text(i: int, c: str, op: str, v: tuple) -> str:
        if op == "between":
            return f"{c} {_kw(st, 'between')} {_lit(v[0])} {_kw(st, 'and')} {_lit(v[1])}"
        if op == "in":
            return f"{c} {_kw(st, 'in')} ({', '.join(_lit(x) for x in v)})"
        if i == swap:
            flip = {"<": ">", ">": "<", "<=": ">=", ">=": "<=", "=": "="}[op]
            return f"{_lit(v[0])} {flip} {c}"
        return f"{c} {op} {_lit(v[0])}"

    agg, tree = MEASURES[it.measure]
    sep = "\n" if st.newlines and not st.compact else " "
    as_kw = f" {_kw(st, 'as')} " if st.use_as else " "
    parts = []
    if st.leading_comment:
        parts.append(f"/* {st.leading_comment} */")
    sel = [col(lv) for lv in it.levels] + [f"{_kw(st, agg.lower())}({expr(tree)}){as_kw}{it.measure}"]
    parts.append(f"{_kw(st, 'select')} {', '.join(sel)}")
    parts.append(f"{_kw(st, 'from')} {FACT}" + (f"{as_kw}{alias[FACT]}" if alias[FACT] != FACT else ""))
    dims = tables[1:]
    if rw == "reverse_joins":
        dims = dims[::-1]
    for t in dims:
        fk, pk = JOIN_KEYS[t]
        jt = t + (f"{as_kw}{alias[t]}" if alias[t] != t else "")
        jk = _kw(st, "inner join") if st.explicit_inner else _kw(st, "join")
        parts.append(f"{jk} {jt} {_kw(st, 'on')} {alias[FACT]}.{fk} = {alias[t]}.{pk}")
    if preds:
        conj = f" {_kw(st, 'and')} ".join(pred_text(i, *p) for i, p in enumerate(preds))
        parts.append(f"{_kw(st, 'where')} {conj}")
    if it.levels:
        group = [col(lv) for lv in it.levels]
        if rw == "reverse_group_by":
            group = group[::-1]
        parts.append(f"{_kw(st, 'group by')} {', '.join(group)}")
    sql = sep.join(parts)
    if st.trailing_semicolon:
        sql += ";"
    return sql
