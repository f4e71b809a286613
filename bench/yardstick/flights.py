"""Structured intents over SSB: the 13 query flights of SSB rev. 3 as
templates, their literal domains, and the drill, roll-up and window moves
of a dashboard session.

An :class:`Intent` is what the traffic generator draws and what the plain
reference answers: one measure, the grouping levels and the predicates.
The port never sees it: it receives the SQL text that ``sqlforms``
renders from it.

The flights follow SSB rev. 3 (O'Neil et al. 2009, section 3) with their
literals drawn over the full domains instead of fixed.  Q1.3's week of the
year stays an ordinary predicate.  ``HIERARCHIES`` and the moves of
``drill``/``roll`` are a frozen copy, with changes, of the drill-session
logic of the port's ``src/repro_torch/workloads/hierarchical.py`` (its
``_HIERARCHIES`` paths, walked one level at a time; the source walked a
fixed ten-query session instead).
"""
from __future__ import annotations

import dataclasses
import random

from .ssbgen import MONTHS, NATIONS, REGIONS, YEARS, brands, categories, city_name

# measure name -> (aggregate, expression tree); a tree is a qualified column
# name or (operator, left, right)
MEASURES = {
    "disc_revenue": ("SUM", ("*", "lineorder.lo_extendedprice", "lineorder.lo_discount")),
    "revenue": ("SUM", "lineorder.lo_revenue"),
    "profit": ("SUM", ("-", "lineorder.lo_revenue", "lineorder.lo_supplycost")),
}

# fine -> coarse, as the port's schema declares them (d_date left out: a
# grouping by day is no dashboard's)
HIERARCHIES = {
    "time": ("dates.d_yearmonth", "dates.d_quarter", "dates.d_year"),
    "cust_geo": ("customer.c_city", "customer.c_nation", "customer.c_region"),
    "supp_geo": ("supplier.s_city", "supplier.s_nation", "supplier.s_region"),
    "prod": ("part.p_brand", "part.p_category", "part.p_mfgr"),
}
HIERARCHY_OF = {lv: h for h, lvs in HIERARCHIES.items() for lv in lvs}
PRICE_COLUMN = "lineorder.lo_extendedprice"


@dataclasses.dataclass(frozen=True)
class Pred:
    col: str  # qualified column
    op: str  # '=' | 'in' | 'between' | '<' | '>='
    val: tuple  # one literal, or the list of 'in', or (lo, hi) of 'between'


@dataclasses.dataclass(frozen=True)
class Intent:
    flight: str
    measure: str  # a key of MEASURES
    levels: tuple[str, ...]
    preds: tuple[Pred, ...]

    @property
    def host_mask(self) -> bool:
        """True where a predicate reads a column that float32 cannot hold
        exactly: on a miss the port builds that mask on the host and
        aggregates with kernel A, not kernel B."""
        return any(p.col == PRICE_COLUMN for p in self.preds)

    def with_preds(self, preds) -> "Intent":
        return dataclasses.replace(self, preds=tuple(preds))


# ------------------------------------------------------------ literal draws

def _nation(rng) -> tuple[str, str]:
    return NATIONS[rng.randrange(len(NATIONS))]


def _year_range(rng) -> tuple[int, int]:
    a, b = sorted(rng.sample(YEARS, 2))
    return a, b


def _brand_run(rng) -> tuple[str, str]:
    cat = rng.choice(categories())
    b = rng.randint(10, 33)  # two digits: the run is a run of strings too
    return f"{cat}{b}", f"{cat}{b + 7}"


def _two_cities(rng) -> tuple[str, ...]:
    nat, _ = _nation(rng)
    a, b = rng.sample(range(10), 2)
    return city_name(nat, a), city_name(nat, b)


def _month(rng) -> tuple[int, int]:
    return rng.choice(YEARS), rng.randint(1, 12)


def _disc(rng) -> tuple[int, int]:
    d = rng.randint(1, 9)
    return d - 1, d + 1


def _t(col, op, *val) -> Pred:
    return Pred(col, op, tuple(val))


def q1_1(rng) -> Intent:
    return Intent("q1.1", "disc_revenue", (), (
        _t("dates.d_year", "=", rng.choice(YEARS)),
        _t("lineorder.lo_discount", "between", *_disc(rng)),
        _t("lineorder.lo_quantity", "<", rng.randint(2, 50))))


def q1_2(rng) -> Intent:
    y, m = _month(rng)
    q = rng.randint(1, 41)
    return Intent("q1.2", "disc_revenue", (), (
        _t("dates.d_yearmonthnum", "=", y * 100 + m),
        _t("lineorder.lo_discount", "between", *_disc(rng)),
        _t("lineorder.lo_quantity", "between", q, q + 9)))


def q1_3(rng) -> Intent:
    q = rng.randint(1, 41)
    return Intent("q1.3", "disc_revenue", (), (
        _t("dates.d_weeknuminyear", "=", rng.randint(1, 47)),
        _t("dates.d_year", "=", rng.choice(YEARS)),
        _t("lineorder.lo_discount", "between", *_disc(rng)),
        _t("lineorder.lo_quantity", "between", q, q + 9)))


def q2_1(rng) -> Intent:
    return Intent("q2.1", "revenue", ("dates.d_year", "part.p_brand"), (
        _t("part.p_category", "=", rng.choice(categories())),
        _t("supplier.s_region", "=", rng.choice(REGIONS))))


def q2_2(rng) -> Intent:
    return Intent("q2.2", "revenue", ("dates.d_year", "part.p_brand"), (
        _t("part.p_brand", "between", *_brand_run(rng)),
        _t("supplier.s_region", "=", rng.choice(REGIONS))))


def q2_3(rng) -> Intent:
    return Intent("q2.3", "revenue", ("dates.d_year", "part.p_brand"), (
        _t("part.p_brand", "=", rng.choice(brands())),
        _t("supplier.s_region", "=", rng.choice(REGIONS))))


def q3_1(rng) -> Intent:
    r = rng.choice(REGIONS)
    return Intent("q3.1", "revenue", ("customer.c_nation", "supplier.s_nation", "dates.d_year"), (
        _t("customer.c_region", "=", r), _t("supplier.s_region", "=", r),
        _t("dates.d_year", "between", *_year_range(rng))))


def q3_2(rng) -> Intent:
    nat, _ = _nation(rng)
    return Intent("q3.2", "revenue", ("customer.c_city", "supplier.s_city", "dates.d_year"), (
        _t("customer.c_nation", "=", nat), _t("supplier.s_nation", "=", nat),
        _t("dates.d_year", "between", *_year_range(rng))))


def q3_3(rng) -> Intent:
    cities = _two_cities(rng)
    return Intent("q3.3", "revenue", ("customer.c_city", "supplier.s_city", "dates.d_year"), (
        _t("customer.c_city", "in", *cities), _t("supplier.s_city", "in", *cities),
        _t("dates.d_year", "between", *_year_range(rng))))


def q3_4(rng) -> Intent:
    cities = _two_cities(rng)
    y, m = _month(rng)
    return Intent("q3.4", "revenue", ("customer.c_city", "supplier.s_city", "dates.d_year"), (
        _t("customer.c_city", "in", *cities), _t("supplier.s_city", "in", *cities),
        _t("dates.d_yearmonth", "=", f"{MONTHS[m - 1]}{y}")))


def _two_mfgrs(rng) -> tuple[str, ...]:
    return tuple(sorted(rng.sample([f"MFGR#{i}" for i in range(1, 6)], 2)))


def q4_1(rng) -> Intent:
    r = rng.choice(REGIONS)
    return Intent("q4.1", "profit", ("dates.d_year", "customer.c_nation"), (
        _t("customer.c_region", "=", r), _t("supplier.s_region", "=", r),
        _t("part.p_mfgr", "in", *_two_mfgrs(rng))))


def q4_2(rng) -> Intent:
    r = rng.choice(REGIONS)
    y = rng.choice(YEARS[:-1])
    return Intent("q4.2", "profit", ("dates.d_year", "supplier.s_nation", "part.p_category"), (
        _t("customer.c_region", "=", r), _t("supplier.s_region", "=", r),
        _t("dates.d_year", "between", y, y + 1),
        _t("part.p_mfgr", "in", *_two_mfgrs(rng))))


def q4_3(rng) -> Intent:
    nat, _ = _nation(rng)
    y = rng.choice(YEARS[:-1])
    return Intent("q4.3", "profit", ("dates.d_year", "supplier.s_city", "part.p_brand"), (
        _t("supplier.s_nation", "=", nat),
        _t("dates.d_year", "between", y, y + 1),
        _t("part.p_category", "=", rng.choice(categories()))))


FLIGHTS = {f.__name__.replace("_", ".", 1): f for f in (
    q1_1, q1_2, q1_3, q2_1, q2_2, q2_3, q3_1, q3_2, q3_3, q3_4, q4_1, q4_2, q4_3)}


def draw(rng: random.Random, flight: str | None = None) -> Intent:
    """One flight's intent with every literal drawn uniformly over its
    domain (the flight too, where ``flight`` is None)."""
    name = flight or rng.choice(sorted(FLIGHTS))
    return FLIGHTS[name](rng)


def with_price_floor(it: Intent, rng: random.Random) -> Intent:
    """``it`` restricted to line orders of at least a price drawn over the
    column's range (whole currency units): "large orders only"."""
    return it.with_preds(it.preds + (_t(PRICE_COLUMN, ">=", rng.randint(1000, 100_000)),))


def regroup(it: Intent, rng: random.Random) -> Intent:
    """Each grouping level replaced by a level of its hierarchy drawn
    uniformly (an analyst's own grouping of the flight)."""
    return dataclasses.replace(it, levels=tuple(
        rng.choice(HIERARCHIES[HIERARCHY_OF[lv]]) for lv in it.levels))


# ------------------------------------------------------- time tile moves

def time_pred(it: Intent) -> Pred | None:
    """The predicate that sets the intent's time window (the last on a
    time column), or None."""
    found = [p for p in it.preds if p.col in ("dates.d_year", "dates.d_yearmonthnum",
                                               "dates.d_yearmonth")]
    return found[-1] if found else None


def _month_pred(col: str, y: int, m: int) -> Pred:
    if col == "dates.d_yearmonthnum":
        return _t(col, "=", y * 100 + m)
    return _t(col, "=", f"{MONTHS[m - 1]}{y}")


def _month_of(p: Pred) -> tuple[int, int]:
    v = p.val[0]
    if p.col == "dates.d_yearmonthnum":
        return v // 100, v % 100
    return int(v[3:]), MONTHS.index(v[:3]) + 1


def shift_time(it: Intent, k: int, anchor: Pred | None = None) -> Intent:
    """``it`` with its time window moved to the ``k``-th unit after
    ``anchor`` (default: its own window): a year window (or a span of
    years) becomes the single year ``start + k``, a month the month ``k``
    later.  An intent without a time window gets the year ``k`` after the
    first of the domain."""
    tp = time_pred(it)
    anchor = anchor or tp
    if anchor is None:
        return it.with_preds(it.preds + (_t("dates.d_year", "=", YEARS[0] + k),))
    if anchor.col == "dates.d_year":
        new = _t("dates.d_year", "=", anchor.val[0] + k)
    else:
        y, m = _month_of(anchor)
        y, m = y + (m - 1 + k) // 12, (m - 1 + k) % 12 + 1
        new = _month_pred(anchor.col, y, m)
    return it.with_preds(new if p is tp else p for p in it.preds)


LAST_MONTH = (1998, 12)


def tiles(it: Intent, n: int = 6) -> list[Intent]:
    """A dashboard's ``n`` tiles: the intent once per time unit, from the
    first year of the domain (a year window, or none) or from its own month
    onwards (moved back where the last tile would leave the domain)."""
    tp = time_pred(it)
    if tp is None or tp.col == "dates.d_year":
        start = _t("dates.d_year", "=", YEARS[0])
        return [shift_time(it, k, start if tp is not None else None) for k in range(n)]
    y, m = _month_of(tp)
    last = LAST_MONTH[0] * 12 + LAST_MONTH[1] - 1
    first = min(y * 12 + m - 1, last - (n - 1))
    start = _month_pred(tp.col, first // 12, first % 12 + 1)
    return [shift_time(it, k, start) for k in range(n)]


def window_move(it: Intent, rng: random.Random) -> Intent:
    """The time window moved one unit earlier or later, inside the
    domain."""
    tp = time_pred(it)
    if tp is None:
        return it
    if tp.col == "dates.d_year":
        y = tp.val[0]
        steps = [k for k in (-1, 1) if YEARS[0] <= y + k <= YEARS[-1]]
    else:
        y, m = _month_of(tp)
        i, last = y * 12 + m - 1, LAST_MONTH[0] * 12 + LAST_MONTH[1] - 1
        steps = [k for k in (-1, 1) if YEARS[0] * 12 <= i + k <= last]
    return shift_time(it, rng.choice(steps))


# --------------------------------------------------------- drill and roll

def _parent(lv: str) -> str | None:
    path = HIERARCHIES[HIERARCHY_OF[lv]]
    i = path.index(lv)
    return path[i + 1] if i + 1 < len(path) else None


def _child(lv: str) -> str | None:
    path = HIERARCHIES[HIERARCHY_OF[lv]]
    i = path.index(lv)
    return path[i - 1] if i > 0 else None


def _holds(p: Pred, v) -> bool:
    if p.op in ("=", "in"):
        return v in p.val
    if p.op == "between":
        return p.val[0] <= v <= p.val[1]
    return v < p.val[0] if p.op == "<" else v >= p.val[0]


def members(level: str, it: Intent) -> list:
    """Values of a geography or product ``level`` that the intent's
    predicates on its hierarchy leave possible."""
    h = HIERARCHY_OF[level]
    path = HIERARCHIES[h]
    rows = ([(b, b[:7], b[:6]) for b in brands()] if h == "prod" else
            [(city_name(n, i), n, r) for n, r in NATIONS for i in range(10)])
    for p in it.preds:
        if p.col in path:
            j = path.index(p.col)
            rows = [r for r in rows if _holds(p, r[j])]
    return sorted({r[path.index(level)] for r in rows})


def drill(it: Intent, rng: random.Random, into_share: float) -> Intent:
    """One level down: a geography or product grouping level L is replaced
    by the level below it and the intent filtered to one member of L (with
    probability ``into_share`` the grouping stays and only the filter is
    added: the tile narrowed to a member, which the cache can derive from
    the tile).  A time level moves from year to quarter or quarter to
    month within the window.  A flight without grouping is split by
    month."""
    choices = [lv for lv in it.levels if _child(lv) is not None]
    if not choices:
        if not it.levels:
            return dataclasses.replace(it, levels=("dates.d_yearmonth",))
        return it
    lv = rng.choice(choices)
    if HIERARCHY_OF[lv] == "time":
        return dataclasses.replace(
            it, levels=tuple(_child(lv) if x == lv else x for x in it.levels))
    m = members(lv, it)
    if not m:
        return it
    member = rng.choice(m)
    preds = tuple(p for p in it.preds if p.col != lv) + (_t(lv, "=", member),)
    if rng.random() < into_share:
        return it.with_preds(preds)
    return dataclasses.replace(
        it, levels=tuple(_child(lv) if x == lv else x for x in it.levels), preds=preds)


def roll(it: Intent, rng: random.Random) -> Intent:
    """One level up: a grouping level replaced by the level above it, or
    dropped where it is the top of its hierarchy.  A flight without
    grouping is asked again as it is."""
    if not it.levels:
        return it
    lv = rng.choice(it.levels)
    up = _parent(lv)
    levels = (up if x == lv else x for x in it.levels)
    return dataclasses.replace(it, levels=tuple(dict.fromkeys(x for x in levels if x)))
