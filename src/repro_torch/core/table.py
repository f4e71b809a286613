"""Columnar result tables (numpy-backed).

Cached OLAP results are small aggregates (§2); we hold them as named numpy
columns.  Derivations (roll-up / filter-down) operate directly on these.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Sequence

import numpy as np


@dataclasses.dataclass
class ResultTable:
    columns: dict[str, np.ndarray]  # insertion order == presentation order

    def __post_init__(self):
        n = {len(v) for v in self.columns.values()}
        if len(n) > 1:
            raise ValueError(f"ragged result table: lengths {n}")

    @property
    def num_rows(self) -> int:
        if not self.columns:
            return 0
        return len(next(iter(self.columns.values())))

    @property
    def names(self) -> list[str]:
        return list(self.columns.keys())

    def nbytes(self) -> int:
        return int(sum(v.nbytes for v in self.columns.values()))

    def project(self, names: Sequence[str]) -> "ResultTable":
        return ResultTable({n: self.columns[n] for n in names})

    def mask(self, m: np.ndarray) -> "ResultTable":
        return ResultTable({n: v[m] for n, v in self.columns.items()})

    def sort(self, keys: Sequence[tuple[str, bool]]) -> "ResultTable":
        """Stable sort by (name, desc) keys, last key least significant."""
        if self.num_rows == 0 or not keys:
            return self
        order = np.arange(self.num_rows)
        for name, desc in reversed(list(keys)):
            col = self.columns[name][order]
            idx = np.argsort(col, kind="stable")
            if desc:
                idx = idx[::-1]
                # keep stability under descending: argsort of negated rank
                col_sorted = col[idx]
                # re-stabilize equal runs (argsort reversed breaks stability)
                idx = idx[np.argsort(_rank_equal_runs(col_sorted), kind="stable")]
            order = order[idx]
        return ResultTable({n: v[order] for n, v in self.columns.items()})

    def head(self, k: int) -> "ResultTable":
        return ResultTable({n: v[:k] for n, v in self.columns.items()})

    def to_rows(self) -> list[tuple]:
        cols = list(self.columns.values())
        return [tuple(c[i] for c in cols) for i in range(self.num_rows)]

    def row_set(self, sig_digits: int = 5) -> frozenset:
        """Order-insensitive content fingerprint.  Floats are rounded to
        ``sig_digits`` significant digits: cached results may have been
        accumulated in f32 (seg_agg) or f64 (numpy oracle)."""
        return frozenset(tuple(_norm(x, sig_digits) for x in row) for row in self.to_rows())

    def equals(self, other: "ResultTable", ordered: bool = False,
               rtol: float = 1e-4) -> bool:
        """Content equality with float tolerance.  Unordered comparison aligns
        rows by the non-float (grouping key) columns — group-by results have
        unique key combinations per row — then compares float measures with
        ``allclose`` (results may be f32- or f64-accumulated)."""
        if self.num_rows != other.num_rows or len(self.columns) != len(other.columns):
            return False
        if self.num_rows == 0:
            return True
        a, b = self, other
        if not ordered:
            keys = [n for n, v in self.columns.items() if v.dtype.kind not in "fc"]
            order_keys = [(k, False) for k in keys] or [(self.names[0], False)]
            a = self.sort(order_keys)
            b = other.sort(order_keys)
        for (na, ca), (nb, cb) in zip(a.columns.items(), b.columns.items()):
            if na != nb:
                return False
            if ca.dtype.kind in "fc" or cb.dtype.kind in "fc":
                af = np.asarray(ca, np.float64)
                bf = np.asarray(cb, np.float64)
                both_nan = np.isnan(af) & np.isnan(bf)
                close = np.isclose(af, bf, rtol=rtol, atol=1e-8)
                if not np.all(close | both_nan):
                    return False
            elif not np.array_equal(np.asarray(ca, str) if ca.dtype.kind in "UO" else ca,
                                    np.asarray(cb, str) if cb.dtype.kind in "UO" else cb):
                return False
        return True

    def to_rows_normalized(self, sig_digits: int = 5) -> list[tuple]:
        return [tuple(_norm(x, sig_digits) for x in row) for row in self.to_rows()]


def _norm(x: Any, sig_digits: int = 5):
    if isinstance(x, (np.floating, float)):
        f = float(x)
        if f == 0 or not np.isfinite(f):
            return 0.0 if f == 0 else f
        return float(f"{f:.{sig_digits}g}")
    if isinstance(x, np.integer):
        return int(x)
    if isinstance(x, (np.str_, str)):
        return str(x)
    return x


def _rank_equal_runs(sorted_col: np.ndarray) -> np.ndarray:
    """Helper for stable descending sort: ranks equal runs by position."""
    n = len(sorted_col)
    if n == 0:
        return np.zeros(0, dtype=np.int64)
    change = np.ones(n, dtype=bool)
    change[1:] = sorted_col[1:] != sorted_col[:-1]
    return np.cumsum(change)


def eval_predicate(col: np.ndarray, op: str, val: Any) -> np.ndarray:
    """Vectorized predicate evaluation used by filter-down and executors."""
    if op == "in":
        vals = list(val) if isinstance(val, (list, tuple, frozenset, set)) else [val]
        return np.isin(col, np.asarray(vals, dtype=col.dtype))
    v = np.asarray(val, dtype=col.dtype)
    if op == "=":
        return col == v
    if op == "!=":
        return col != v
    if op == "<":
        return col < v
    if op == "<=":
        return col <= v
    if op == ">":
        return col > v
    if op == ">=":
        return col >= v
    raise ValueError(f"unknown op {op!r}")
