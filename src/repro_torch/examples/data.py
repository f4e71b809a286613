"""The live dashboard of ``streaming_append`` and the append batches that
grow its fact table: composable SSB intents (SUM/COUNT/MIN/MAX over shared
groupings, differing filters; one closed window inside the deltas' date
range, one outside) and LINEORDER rows drawn from ``ssb.build_dataset``'s
distributions."""
from __future__ import annotations

import numpy as np

_JOINS = ("JOIN customer ON lineorder.lo_custkey = customer.c_key "
          "JOIN supplier ON lineorder.lo_suppkey = supplier.s_key "
          "JOIN part ON lineorder.lo_partkey = part.p_key "
          "JOIN dates ON lineorder.lo_orderdate = dates.d_key ")
_BASE = ("SELECT {lvl}, SUM(lo_revenue) AS rev, COUNT(*) AS n, "
         "MIN(lo_supplycost) AS lo, MAX(lo_supplycost) AS hi "
         f"FROM lineorder {_JOINS}")

# Windowless tiles are affected by every tick; the d_year tiles show the
# window-intersection rule (1998 refreshes, 1992 stays untouched because
# the deltas only carry 1998 dates).
DASHBOARD = (
    [_BASE.format(lvl="c_region") + w + "GROUP BY c_region"
     for w in ("", "WHERE lo_quantity < 25 ", "WHERE lo_discount <= 3 ",
               "WHERE c_region = 'ASIA' ", "WHERE p_mfgr = 'MFGR#1' ",
               "WHERE d_year = 1998 ", "WHERE d_year = 1992 ")]
    + [_BASE.format(lvl=lvl) + f"GROUP BY {lvl}"
       for lvl in ("c_nation", "s_region", "d_year")]
)


def make_delta(ds, n: int, rng, year: int = 1998) -> dict:
    """``n`` new LINEORDER rows drawn from ``ssb.build_dataset``'s
    distributions (any customer, supplier and part; quantity 1-50, price
    100-10,000, discount 0-10, supply cost 40-80 % of the price), ordered on
    days of ``year`` (so the update's extent exercises the
    window-intersection rule)."""
    dim = ds.dims["dates"]
    day_keys = np.nonzero(dim.columns["d_year"].data == year)[0]
    od = rng.choice(day_keys, size=n)
    qty = rng.integers(1, 51, size=n)
    price = np.round(rng.uniform(100, 10_000, size=n), 2)
    disc = rng.integers(0, 11, size=n)
    return {
        "lo_orderdate": od,
        "lo_custkey": rng.integers(0, ds.dims["customer"].num_rows, size=n),
        "lo_suppkey": rng.integers(0, ds.dims["supplier"].num_rows, size=n),
        "lo_partkey": rng.integers(0, ds.dims["part"].num_rows, size=n),
        "lo_quantity": qty,
        "lo_extendedprice": price,
        "lo_discount": disc,
        "lo_revenue": np.round(price * (1 - disc / 100.0), 2),
        "lo_supplycost": np.round(price * rng.uniform(0.4, 0.8, size=n), 2),
        "lo_date": dim.columns["d_date"].data[od],
    }
