"""SSB hierarchical drill workload (RQ4, §5.5).

Dashboard drill sessions over SSB's explicit hierarchies (time, customer
geography, product).  Each 10-query session keeps WHERE fixed and walks
GROUP BY granularities:

    1 x fine-grain query            (cold miss; populates the cache)
    4 x coarser roll-up queries     (derivation hits when roll-up is enabled)
    4 x exact repeats               (exact hits either way)
    1 x drill-down to a finer level (always a miss: query-level caching
                                     lacks the detail data — §3.6)

=> hit rate 8/10 with derivations vs 4/10 without, reproducing the paper's
37% -> 80% structure.  TPC-DS and NYC TLC lack systematic hierarchy
traversal, so derivations are evaluated on SSB by design (paper §5.5).
"""
from __future__ import annotations

from .base import Query

_JD = "JOIN dates ON lineorder.lo_orderdate = dates.d_key "
_JC = "JOIN customer ON lineorder.lo_custkey = customer.c_key "
_JS = "JOIN supplier ON lineorder.lo_suppkey = supplier.s_key "
_JP = "JOIN part ON lineorder.lo_partkey = part.p_key "

# (hierarchy name, needed join, drill path fine -> coarse, drill-down level)
_HIERARCHIES = [
    ("time", _JD, ["d_yearmonth", "d_quarter", "d_year"], "d_date"),
    ("cust_geo", _JD + _JC, ["c_city", "c_nation", "c_region"], None),
    ("prod", _JD + _JP, ["p_brand", "p_category", "p_mfgr"], None),
    ("supp_geo", _JD + _JS, ["s_city", "s_nation", "s_region"], None),
]

_FILTERS = [
    "d_year = 1992", "d_year = 1993", "d_year = 1994", "d_year = 1995",
    "d_year = 1996", "d_year = 1997",
]


def _q(joins: str, level_list: list[str], where: str) -> str:
    cols = ", ".join(level_list)
    return (
        f"SELECT {cols}, SUM(lo_revenue) AS revenue FROM lineorder {joins}"
        f"WHERE {where} GROUP BY {cols}"
    )


def build_stream(n_sessions: int = 20) -> list[Query]:
    """The drill-session query stream (SQL only, matching the paper's RQ4)."""
    out: list[Query] = []
    for s in range(n_sessions):
        hname, joins, path, drill = _HIERARCHIES[s % len(_HIERARCHIES)]
        # unique (hierarchy, filter) pair per session — sessions must not
        # alias each other's cache entries
        where = _FILTERS[(s // len(_HIERARCHIES)) % len(_FILTERS)]
        fine, mid, coarse = path
        sid = f"hier_{s:02d}_{hname}"

        fine_q = _q(joins, [fine, mid], where)  # e.g. (city, nation)
        roll_1 = _q(joins, [mid], where)  # drop + coarsen
        roll_2 = _q(joins, [coarse], where)
        roll_3 = _q(joins, [fine], where)  # drop a level, keep fine
        roll_4 = _q(joins, [mid, coarse], where)
        if drill is not None:
            drill_q = _q(_JD, [drill], where)  # finer than anything cached
        else:
            # different hierarchy's fine level: not derivable from this session;
            # region varies per session so drills never alias across sessions
            region = ["ASIA", "AMERICA", "EUROPE", "AFRICA", "MIDDLE EAST"][s % 5]
            drill_q = _q(_JD + _JS, ["s_city", "s_nation"],
                         where + f" AND s_region = '{region}'")

        seq = [
            (fine_q, "fine"),
            (roll_1, "rollup"), (roll_2, "rollup"),
            (roll_1, "repeat"), (roll_2, "repeat"),
            (roll_3, "rollup"), (roll_4, "rollup"),
            (roll_3, "repeat"), (fine_q, "repeat"),
            (drill_q, "drilldown"),
        ]
        for i, (sql, role) in enumerate(seq):
            out.append(Query("ssb_hier", f"{sid}_{role}", "sql", sql, i))
    return out
