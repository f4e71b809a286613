"""Correctness-preserving reuse beyond exact hits (§3.6).

Two derivations, each guarded by explicit preconditions:

* **Roll-up** — re-aggregate a finer-grained cached entry.  Permitted only for
  composable aggregations (SUM, COUNT, MIN, MAX); AVG / COUNT DISTINCT /
  ratios are rejected.  Requires summarizable hierarchies (functional
  child->parent mapping) and NULL-preserving semantics.
* **Filter-down** — post-filter a cached superset.  The cached result must
  contain the filter attributes needed for the tighter predicate (i.e. they
  are grouping columns of the cached entry).

Both are disabled when either signature carries ORDER BY / LIMIT / HAVING:
re-aggregation or post-filtering can alter top-k membership and group
survival.  Drill-down (finer <- coarser) is unsupported — query-level caching
lacks the detail data.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np

from .schema import StarSchema
from .signature import COMPOSABLE_AGGS, Signature
from .table import ResultTable, eval_predicate

# A hierarchy value mapper: (dim, fine_level, coarse_level, fine_values) ->
# coarse values.  Built from dimension tables by the dataset/executor; roll-up
# across hierarchy levels is only attempted when a mapper is available and the
# hierarchy is declared summarizable.
LevelMapper = Callable[[str, str, str, np.ndarray], np.ndarray]


@dataclasses.dataclass(frozen=True)
class DerivationPlan:
    kind: str  # 'rollup' | 'filterdown'
    cached_key: str
    # rollup: requested level -> cached level it derives from (same = identity)
    level_map: tuple[tuple[str, str], ...] = ()
    # filterdown: the extra predicates to apply to cached rows
    extra_filters: tuple = ()
    # requested-measure index -> cached-measure index
    measure_map: tuple[int, ...] = ()


def no_postagg(sig: Signature) -> bool:
    """True when a signature carries no HAVING/ORDER BY/LIMIT — the shared
    precondition of every derivation (the cache's index prefilters on it)."""
    return not sig.having and not sig.order_by and sig.limit is None


_no_postagg = no_postagg  # internal alias (pre-index name)


def _match_measures(requested: Signature, cached: Signature) -> Optional[tuple[int, ...]]:
    """Map each requested measure to a distinct cached measure with identical
    (agg, expr, distinct).  None if the multisets differ."""
    used = [False] * len(cached.measures)
    out: list[int] = []
    for m in requested.measures:
        for j, c in enumerate(cached.measures):
            if not used[j] and (c.agg, c.expr, c.distinct) == (m.agg, m.expr, m.distinct):
                used[j] = True
                out.append(j)
                break
        else:
            return None
    if not all(used):
        return None
    return tuple(out)


# ------------------------------------------------------------------- roll-up


def plan_rollup(
    requested: Signature, cached: Signature, schema: StarSchema, cached_key: str
) -> Optional[DerivationPlan]:
    """Check roll-up preconditions; return an executable plan or None."""
    if requested.schema != cached.schema or requested.scope != cached.scope:
        return None
    if not (_no_postagg(requested) and _no_postagg(cached)):
        return None
    if not (requested.all_composable() and cached.all_composable()):
        return None  # precondition (i): composable aggregation only
    mm = _match_measures(requested, cached)
    if mm is None:
        return None
    if requested.filters != cached.filters or requested.time_window != cached.time_window:
        return None
    if requested.levels == cached.levels:
        return None  # that would be an exact hit, not a derivation
    level_map: list[tuple[str, str]] = []
    for lv in requested.levels:
        if lv in cached.levels:
            level_map.append((lv, lv))
            continue
        src = _finer_source(lv, cached.levels, schema)
        if src is None:
            return None  # not derivable: drill-down or cross-hierarchy
        level_map.append((lv, src))
    return DerivationPlan(
        kind="rollup", cached_key=cached_key,
        level_map=tuple(level_map), measure_map=mm,
    )


def _finer_source(coarse: str, cached_levels: tuple[str, ...], schema: StarSchema) -> Optional[str]:
    """Find a cached level that is a strict descendant of ``coarse`` within a
    summarizable hierarchy of the same dimension (precondition ii).

    Memoized *on the schema instance* (the level lattice is a pure function
    of the frozen schema, and roll-up planning re-asks the same (coarse,
    cached-levels) pairs for every probe of a recurring dashboard intent) —
    a schema-keyed global cache would both pin dead schemas process-wide and
    re-hash the whole nested schema per probe."""
    memo = schema.__dict__.get("_lattice_memo")
    if memo is None:
        memo = {}
        object.__setattr__(schema, "_lattice_memo", memo)
    k = (coarse, cached_levels)
    if k not in memo:
        memo[k] = _finer_source_cold(coarse, cached_levels, schema)
    return memo[k]


def _finer_source_cold(coarse: str, cached_levels: tuple[str, ...],
                       schema: StarSchema) -> Optional[str]:
    if "." not in coarse:
        return None
    dim_name, col = coarse.split(".", 1)
    dim = schema.dimension(dim_name)
    if dim is None:
        return None
    h = dim.hierarchy_of(col)
    if h is None or not h.summarizable:
        return None
    for cand in cached_levels:
        if not cand.startswith(dim_name + "."):
            continue
        fine = cand.split(".", 1)[1]
        if h.is_ancestor(col, fine):
            return cand
    return None


def apply_rollup(
    plan: DerivationPlan,
    requested: Signature,
    cached: Signature,
    table: ResultTable,
    mapper: Optional[LevelMapper],
) -> Optional[ResultTable]:
    """Execute a roll-up plan on the cached result (numpy; results are small)."""
    n = table.num_rows
    # 1. derive requested level columns (identity or hierarchy mapping)
    key_cols: dict[str, np.ndarray] = {}
    for req_lv, src_lv in plan.level_map:
        src = table.columns[src_lv]
        if req_lv == src_lv:
            key_cols[req_lv] = src
        else:
            if mapper is None:
                return None
            dim = req_lv.split(".", 1)[0]
            mapped = mapper(dim, src_lv.split(".", 1)[1], req_lv.split(".", 1)[1], src)
            if mapped is None:
                return None
            key_cols[req_lv] = mapped
    # 2. group rows by the composite requested key
    if key_cols:
        inverse, uniques = _group_inverse(list(key_cols.values()), n)
        n_groups = len(next(iter(uniques)))
    else:
        inverse = np.zeros(n, dtype=np.int64)
        uniques = []
        n_groups = 1 if n > 0 else 0
    # 3. re-aggregate each requested measure from its cached source column
    out: dict[str, np.ndarray] = {}
    for lv, u in zip(key_cols.keys(), uniques):
        out[lv] = u
    for ri, ci in enumerate(plan.measure_map):
        agg = requested.measures[ri].agg
        src = table.columns[f"m{ci}"]
        out[f"m{ri}"] = _reaggregate(agg, src, inverse, n_groups)
    # preserve canonical column order: sorted levels then measures
    ordered = {lv: out[lv] for lv in requested.levels}
    for ri in range(len(requested.measures)):
        ordered[f"m{ri}"] = out[f"m{ri}"]
    return ResultTable(ordered)


def _group_inverse(cols: list[np.ndarray], n: int) -> tuple[np.ndarray, list[np.ndarray]]:
    """Factorize a composite key into (inverse indices, unique values percol)."""
    if n == 0:
        return np.zeros(0, dtype=np.int64), [c[:0] for c in cols]
    codes = np.zeros(n, dtype=np.int64)
    dims: list[np.ndarray] = []
    for c in cols:
        u, inv = np.unique(c, return_inverse=True)
        codes = codes * len(u) + inv
        dims.append(u)
    ucodes, inverse = np.unique(codes, return_inverse=True)
    # decode unique composite codes back to per-column values
    uniques: list[np.ndarray] = []
    rem = ucodes
    for u in reversed(dims):
        uniques.append(u[rem % len(u)])
        rem = rem // len(u)
    uniques.reverse()
    return inverse, uniques


def _extreme_at(agg: str, src: np.ndarray, inverse: np.ndarray,
                out: np.ndarray) -> np.ndarray:
    """NaN-aware grouped MIN/MAX scatter shared by roll-up, the refresh
    merge algebra, and the executor's numpy oracle: NaN sources are masked
    out of the ``.at`` call (which would otherwise raise ``RuntimeWarning:
    invalid value encountered``) and their destination groups re-poisoned
    afterwards — a NaN child value still yields a NaN parent, exactly what a
    direct recompute over the NaN-bearing rows produces, without the
    float-compare warnings."""
    red = np.minimum if agg == "MIN" else np.maximum
    ok = ~np.isnan(src)
    red.at(out, inverse[ok], src[ok])
    if not ok.all():
        out[np.unique(inverse[~ok])] = np.nan
    return out


def _reaggregate(agg: str, src: np.ndarray, inverse: np.ndarray, n_groups: int) -> np.ndarray:
    """COUNT rolls up as SUM of counts; SUM/MIN/MAX as themselves (§3.6)."""
    if agg in ("SUM", "COUNT"):
        out = np.zeros(n_groups, dtype=np.float64 if src.dtype.kind == "f" else np.int64)
        np.add.at(out, inverse, src)
        return out
    if agg in ("MIN", "MAX"):
        if src.dtype.kind == "f":
            ident = np.inf if agg == "MIN" else -np.inf
            return _extreme_at(agg, src, inverse,
                               np.full(n_groups, ident, dtype=src.dtype))
        red = np.minimum if agg == "MIN" else np.maximum
        ident = np.iinfo(np.int64).max if agg == "MIN" else np.iinfo(np.int64).min
        out = np.full(n_groups, ident, dtype=np.int64)
        red.at(out, inverse, src)
        return out
    raise AssertionError(f"non-composable agg {agg} escaped precondition check")


# --------------------------------------------------------------- filter-down


def plan_filterdown(
    requested: Signature, cached: Signature, schema: StarSchema, cached_key: str
) -> Optional[DerivationPlan]:
    """Check filter-down preconditions; return an executable plan or None."""
    if requested.schema != cached.schema or requested.scope != cached.scope:
        return None
    if not (_no_postagg(requested) and _no_postagg(cached)):
        return None  # precondition (iii): no ORDER BY / LIMIT
    mm = _match_measures(requested, cached)
    if mm is None:
        return None
    if requested.levels != cached.levels:
        return None
    if requested.time_window != cached.time_window:
        return None
    req_fs, c_fs = requested.filters_frozen(), cached.filters_frozen()
    extra = req_fs - c_fs
    if not extra or c_fs - req_fs:
        return None  # must be a strict tightening
    # precondition (i): every extra filter attribute must be present among the
    # cached grouping columns (the only attributes the cached result retains)
    for f in extra:
        if f.col not in cached.levels:
            return None
    return DerivationPlan(
        kind="filterdown", cached_key=cached_key,
        extra_filters=tuple(sorted(extra, key=lambda f: f.sort_key())), measure_map=mm,
    )


# ------------------------------------------------- composed derivation
# (beyond-paper, flag-gated: filter-down then roll-up in one step — e.g.
#  cached (region, category) answers "by region WHERE category='x'")


def plan_compose(
    requested: Signature, cached: Signature, schema: StarSchema, cached_key: str
) -> Optional[DerivationPlan]:
    if requested.schema != cached.schema or requested.scope != cached.scope:
        return None
    if not (_no_postagg(requested) and _no_postagg(cached)):
        return None
    if not (requested.all_composable() and cached.all_composable()):
        return None
    mm = _match_measures(requested, cached)
    if mm is None:
        return None
    if requested.time_window != cached.time_window:
        return None
    req_fs, c_fs = requested.filters_frozen(), cached.filters_frozen()
    extra = req_fs - c_fs
    if not extra or c_fs - req_fs:
        return None
    for f in extra:
        if f.col not in cached.levels:
            return None  # filter attribute not retained by the cached result
    if requested.levels == cached.levels:
        return None  # that is plain filter-down, handled separately
    level_map: list[tuple[str, str]] = []
    for lv in requested.levels:
        if lv in cached.levels:
            level_map.append((lv, lv))
            continue
        src = _finer_source(lv, cached.levels, schema)
        if src is None:
            return None
        level_map.append((lv, src))
    return DerivationPlan(
        kind="compose", cached_key=cached_key, level_map=tuple(level_map),
        extra_filters=tuple(sorted(extra, key=lambda f: f.sort_key())),
        measure_map=mm,
    )


def apply_compose(
    plan: DerivationPlan, requested: Signature, cached: Signature,
    table: ResultTable, mapper: Optional[LevelMapper],
) -> Optional[ResultTable]:
    mask = np.ones(table.num_rows, dtype=bool)
    for f in plan.extra_filters:
        mask &= eval_predicate(table.columns[f.col], f.op, f.val)
    return apply_rollup(plan, requested, cached, table.mask(mask), mapper)


def apply_filterdown(
    plan: DerivationPlan, requested: Signature, cached: Signature, table: ResultTable
) -> ResultTable:
    mask = np.ones(table.num_rows, dtype=bool)
    for f in plan.extra_filters:
        mask &= eval_predicate(table.columns[f.col], f.op, f.val)
    filtered = table.mask(mask)
    ordered = {lv: filtered.columns[lv] for lv in requested.levels}
    for ri, ci in enumerate(plan.measure_map):
        ordered[f"m{ri}"] = filtered.columns[f"m{ci}"]
    return ResultTable(ordered)
