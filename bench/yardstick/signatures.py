"""An intent signature that the service executed, mapped back to an
:class:`flights.Intent` that the plain reference answers.

An NL request's answer is judged against the signature that the service
executed for it (what the canonicalizer made of the question), not
against the question's own intent: a canonicalizer that misreads a
question gives another answer, which is a fault of its reading and not of
the answer.  ``intent_of`` reads the signature's canonical JSON: one
``SUM`` of one of ``flights.MEASURES``' expressions, grouping levels on the
dimensions, filters, and a time window on the order date.  It gives None
where the signature says what the reference cannot (another aggregate or
expression, ``!=``, ``>`` on a float column, HAVING, ORDER BY, LIMIT).
"""
from __future__ import annotations

import datetime as _dt

from .flights import MEASURES, Intent, Pred
from .ssbgen import EPOCH, SSBData

FACT = "lineorder"


def _expr(tree) -> str:
    """An expression tree as the port's canonicalizer writes it:
    parenthesised, the operands of ``*`` and ``+`` in sorted order."""
    if isinstance(tree, str):
        return tree
    op, a, b = tree
    x, y = _expr(a), _expr(b)
    if op in ("*", "+"):
        x, y = sorted((x, y))
    return f"({x}{op}{y})"


MEASURE_OF = {(agg, _expr(tree)): name for name, (agg, tree) in MEASURES.items()}


def _days(iso: str) -> int:
    return (_dt.date.fromisoformat(iso) - EPOCH).days


def _pred(f: dict, data: SSBData) -> Pred | None:
    table, _, name = f["col"].partition(".")
    col = data.tables.get(table, {}).get(name)
    if col is None:
        return None
    op, v = f["op"], f["val"]
    if col.kind == "date":
        v = [_days(x) for x in v] if isinstance(v, list) else _days(v)
    if op in ("=", "<", ">="):
        return Pred(f["col"], op, (v,))
    if op == "in":
        return Pred(f["col"], "in", tuple(v))
    if op == "<=":
        return Pred(f["col"], "between", ("" if col.kind == "str" else float("-inf"), v))
    if op == ">" and col.kind in ("int", "date"):
        return Pred(f["col"], ">=", (v + 1,))
    return None


def intent_of(signature, data: SSBData) -> Intent | None:
    """The intent that ``signature`` (the port's ``Signature``) asks of
    ``data``, or None where the reference cannot answer it."""
    obj = signature.to_json()
    if obj.get("having") or obj.get("order_by") or obj.get("limit") is not None \
            or len(obj["measures"]) != 1:
        return None
    m = obj["measures"][0]
    measure = MEASURE_OF.get((m["agg"], m["expr"]))
    if measure is None or m.get("distinct"):
        return None
    levels = tuple(obj.get("levels", ()))
    for lv in levels:
        table, _, name = lv.partition(".")
        if table == FACT or name not in data.tables.get(table, {}):
            return None
    preds = [_pred(f, data) for f in obj.get("filters", ())]
    if any(p is None for p in preds):
        return None
    tw = obj.get("time_window")
    if tw:
        preds.append(Pred(f"{FACT}.lo_date", "between",
                          (_days(tw["start"]), _days(tw["end"]) - 1)))
    return Intent("executed", measure, levels, tuple(preds))
