"""The plain reference: the answer to a structured intent, computed with
NumPy from the generated SSB columns.

It imports nothing of the port and reads nothing the port made: it takes
the :class:`flights.Intent` (not the SQL text) and the arrays of
:class:`ssbgen.SSBData`.  Every predicate is evaluated on the dimension's
rows and gathered to the fact rows through the foreign key; the selected
rows are grouped by their level values and each group's measure is summed
in float64.  An answer is a dict from the group's key (a tuple of the
level values as text, in the intent's level order) to its sum; an intent
without levels has the one key ``()``, whose sum is 0 where no row
qualifies.

``intent_of`` maps a signature that the service executed back to the
intent it asks (``signatures.py``), so that an NL answer is judged on what
was executed.

``answer(..., control=True)`` is the control of the comparison that
decides ``correct``: the same computation with the measure values and the
sums in bfloat16, the precision below the float32 that the configuration
states (torch, on ``device``).
"""
from __future__ import annotations

import numpy as np

from . import signatures
from .flights import MEASURES, Intent, Pred
from .ssbgen import SSBData

FACT = "lineorder"


def _test(values: np.ndarray, p: Pred) -> np.ndarray:
    """Boolean of predicate ``p`` over decoded ``values``."""
    v = p.val
    if p.op == "=":
        return values == v[0]
    if p.op == "in":
        return np.isin(values, np.asarray(v, dtype=values.dtype))
    if p.op == "between":
        return (values >= v[0]) & (values <= v[1])
    if p.op == "<":
        return values < v[0]
    if p.op == ">=":
        return values >= v[0]
    raise ValueError(f"unknown operator {p.op!r}")


class Reference:
    def __init__(self, data: SSBData):
        self.data = data
        self.fact = data.tables[FACT]

    def intent_of(self, signature) -> Intent | None:
        """The intent that a signature the service executed (the port's
        ``Signature``) asks of this data, or None where this reference
        cannot answer it (``signatures.intent_of``)."""
        return signatures.intent_of(signature, self.data)

    def _dim_rows(self, table: str, preds: list[Pred]) -> np.ndarray:
        """Rows of a dimension that pass every predicate on it."""
        cols = self.data.tables[table]
        ok = np.ones(self.data.rows(table), dtype=bool)
        for p in preds:
            col = cols[p.col.split(".")[1]]
            if col.kind == "str":
                # test each vocabulary entry once, then gather by code
                ok &= _test(col.vocab, p)[col.data]
            else:
                ok &= _test(col.data, p)
        return ok

    def rows(self, it: Intent) -> np.ndarray:
        """Fact row numbers that the intent's predicates select: the most
        selective dimension first over every row, the others and the fact
        table's own predicates over the rows left."""
        by_table: dict[str, list[Pred]] = {}
        for p in it.preds:
            by_table.setdefault(p.col.split(".")[0], []).append(p)
        dims = sorted(((ok.mean(), t, ok) for t, ok in (
            (t, self._dim_rows(t, preds)) for t, preds in by_table.items() if t != FACT)),
            key=lambda x: x[0])
        idx = None
        for _, table, ok in dims:
            fk = self.fact[self.data.fk[table]].data
            idx = np.flatnonzero(ok[fk]) if idx is None else idx[ok[fk[idx]]]
        if idx is None:
            idx = np.arange(self.data.rows(FACT))
        for p in by_table.get(FACT, []):
            idx = idx[_test(self.fact[p.col.split(".")[1]].data[idx], p)]
        return idx

    def _values(self, tree, idx: np.ndarray) -> np.ndarray:
        if isinstance(tree, str):
            return self.fact[tree.split(".")[1]].data[idx].astype(np.float64)
        op, a, b = tree
        x, y = self._values(a, idx), self._values(b, idx)
        return {"*": x * y, "-": x - y, "+": x + y}[op]

    def _level(self, level: str, idx: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """(physical values at the selected rows, decoded table of them)."""
        table, c = level.split(".")
        col = self.data.tables[table][c]
        phys = col.data[self.fact[self.data.fk[table]].data[idx]]
        return phys, col

    def answer(self, it: Intent, control: bool = False, device: str = "cpu") -> dict:
        idx = self.rows(it)
        agg, tree = MEASURES[it.measure]
        if agg != "SUM":
            raise ValueError(f"the reference sums; {it.measure} is {agg}")
        vals = self._values(tree, idx)
        if it.levels:
            levels = [self._level(lv, idx) for lv in it.levels]
            # one int64 key per row, mixed radix over the levels' physical values
            lows = [int(col.data.min()) for _, col in levels]
            radix = [int(col.data.max()) - lo + 1 for (_, col), lo in zip(levels, lows)]
            flat = np.zeros(len(idx), np.int64)
            for (phys, _), lo, r in zip(levels, lows, radix):
                flat = flat * r + (phys.astype(np.int64) - lo)
            uniq, inv = np.unique(flat, return_inverse=True)
            keys = np.zeros((len(uniq), len(levels)), np.int64)
            rest = uniq.copy()
            for j in range(len(levels) - 1, -1, -1):
                keys[:, j] = rest % radix[j] + lows[j]
                rest //= radix[j]
        else:
            keys, inv = np.zeros((1, 0), np.int64), np.zeros(len(idx), np.int64)
        if control:
            sums = _bf16_sums(vals, inv, len(keys), device)
        else:
            sums = np.bincount(inv, weights=vals, minlength=len(keys))
        out = {}
        for k in range(len(keys)):
            key = tuple(_text(col.decode(keys[k, j:j + 1])[0])
                        for j, (_, col) in enumerate(levels)) if it.levels else ()
            out[key] = float(sums[k])
        return out


def _bf16_sums(vals: np.ndarray, inv: np.ndarray, n: int, device: str) -> np.ndarray:
    import torch

    out = torch.zeros(n, dtype=torch.bfloat16, device=device)
    out.index_add_(0, torch.from_numpy(inv).to(device),
                   torch.from_numpy(vals).to(device=device, dtype=torch.bfloat16))
    return out.float().cpu().numpy().astype(np.float64)


def _text(v) -> str:
    """A level value as text, the same for numpy and Python scalars."""
    if isinstance(v, (float, np.floating)) and float(v).is_integer():
        v = int(v)
    if isinstance(v, (np.integer,)):
        v = int(v)
    return str(v)


def table_answer(table, levels: tuple[str, ...]) -> dict | None:
    """A served result table as an answer of the same form (its measure is
    the column ``m0``); None where it has no such shape."""
    cols = table.columns
    if "m0" not in cols or any(lv not in cols for lv in levels):
        return None
    m = cols["m0"]
    out = {}
    for i in range(len(m)):
        out[tuple(_text(cols[lv][i]) for lv in levels)] = float(m[i])
    return out


def gap(served: dict | None, ref: dict) -> tuple[bool, float]:
    """(keys differ, widest gap): whether the served answer has another set
    of groups than the reference, and the largest |served - ref| /
    max(|ref|, 1) over the groups both have (1 currency unit is the floor of
    the scale: a sum of cents that is 0 in the reference compares by its
    absolute value)."""
    if served is None:
        return True, float("inf")
    if set(served) != set(ref):
        return True, float("inf")
    widest = 0.0
    for k, r in ref.items():
        s = served[k]
        g = abs(s - r) / max(abs(r), 1.0) if np.isfinite(s) else float("inf")
        widest = max(widest, g)
    return False, widest
