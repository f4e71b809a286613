"""BIRD-style human-authored questions (§5.3: 150 OLAP-compatible questions).

The BIRD dev set is unavailable offline; this module synthesizes 150
human-style questions with the same character: a mix of clean requests and
requests carrying realistic ambiguity (synonyms, implicit time references,
underspecified dimensions) absent from the controlled paraphrases — which is
exactly what explains the paper's 51.3% accuracy gap.  Each question carries
a gold signature under the conventional readings of adversarial.py.
"""
from __future__ import annotations

import random

from ..core.signature import Filter, Measure, Signature, TimeWindow
from .adversarial import AdversarialQuery

_CLEAN = [  # (text, schema, gold-builder)
    ("Show total earnings by pickup borough in {y}", "nyc_tlc",
     lambda y: _s("nyc_tlc", [_m("SUM", "trips.total_amount")],
                  ["zones_pu.pu_borough"], _yw(y))),
    ("How many trips were there by payment type in {y}?", "nyc_tlc",
     lambda y: _s("nyc_tlc", [_m("COUNT", "*")], ["payment.payment_type"], _yw(y))),
    ("total tips by dropoff borough in {y}", "nyc_tlc",
     lambda y: _s("nyc_tlc", [_m("SUM", "trips.tip_amount")],
                  ["zones_do.do_borough"], _yw(y))),
    ("average fare by year", "nyc_tlc",
     lambda y: _s("nyc_tlc", [_m("AVG", "trips.fare_amount")], ["dates.d_year"], None)),
    ("What is total sales by category in {y}?", "tpcds",
     lambda y: _s("tpcds", [_m("SUM", "store_sales.ss_ext_sales_price")],
                  ["item.i_category"], _yw(y))),
    ("total profit by state in {y}", "tpcds",
     lambda y: _s("tpcds", [_m("SUM", "store_sales.ss_net_profit")],
                  ["store.s_state"], _yw(y))),
    ("number of transactions by channel in {y}", "tpcds",
     lambda y: _s("tpcds", [_m("COUNT", "*")], ["promotion.p_channel"], _yw(y))),
    ("total revenue by customer nation in {y}", "ssb",
     lambda y: _s("ssb", [_m("SUM", "lineorder.lo_revenue")],
                  ["customer.c_nation"], _yw(y))),
    ("total profit by supplier region in {y}", "ssb",
     lambda y: _s("ssb", [_m("SUM", "(lineorder.lo_revenue-lineorder.lo_supplycost)")],
                  ["supplier.s_region"], _yw(y))),
    ("number of orders by year", "ssb",
     lambda y: _s("ssb", [_m("COUNT", "*")], ["dates.d_year"], None)),
]

_AMBIGUOUS = [
    # metric: 'revenue' is net-vs-gross on nyc_tlc / tpcds
    ("Show total revenue by pickup borough in {y}", "nyc_tlc",
     lambda y: _s("nyc_tlc", [_m("SUM", "trips.total_amount")],
                  ["zones_pu.pu_borough"], _yw(y))),
    ("total revenue by month in {y}", "nyc_tlc",
     lambda y: _s("nyc_tlc", [_m("SUM", "trips.total_amount")],
                  ["dates.d_yearmonth"], _yw(y))),
    ("What was total revenue by state in {y}?", "tpcds",
     lambda y: _s("tpcds", [_m("SUM", "store_sales.ss_ext_sales_price")],
                  ["store.s_state"], _yw(y))),
    # dimension: area/zone/borough underspecified
    ("total earnings by area in {y}", "nyc_tlc",
     lambda y: _s("nyc_tlc", [_m("SUM", "trips.total_amount")],
                  ["zones_pu.pu_zone"], _yw(y))),
    ("number of trips by zone in {y}", "nyc_tlc",
     lambda y: _s("nyc_tlc", [_m("COUNT", "*")], ["zones_pu.pu_zone"], _yw(y))),
    ("total distance by borough in {y}", "nyc_tlc",
     lambda y: _s("nyc_tlc", [_m("SUM", "trips.trip_distance")],
                  ["zones_pu.pu_borough"], _yw(y))),
    ("total revenue by region in {y}", "ssb",
     lambda y: _s("ssb", [_m("SUM", "lineorder.lo_revenue")],
                  ["customer.c_region"], _yw(y))),
    # time: implicit/relative references
    ("total earnings by payment type last month", "nyc_tlc",
     lambda y: _s("nyc_tlc", [_m("SUM", "trips.total_amount")],
                  ["payment.payment_type"],
                  TimeWindow("2024-02-01", "2024-03-01", open_ended=True))),
    ("number of rides by pickup borough last year", "nyc_tlc",
     lambda y: _s("nyc_tlc", [_m("COUNT", "*")], ["zones_pu.pu_borough"],
                  TimeWindow("2023-01-01", "2024-01-01", open_ended=True))),
    ("total sales by brand this year", "tpcds",
     lambda y: _s("tpcds", [_m("SUM", "store_sales.ss_ext_sales_price")],
                  ["item.i_brand"],
                  TimeWindow("2024-01-01", "2024-03-15", open_ended=True))),
    # aggregation: count-like nouns without an aggregation word
    ("trips by pickup borough in {y}", "nyc_tlc",
     lambda y: _s("nyc_tlc", [_m("COUNT", "*")], ["zones_pu.pu_borough"], _yw(y))),
    ("passengers by month in {y}", "nyc_tlc",
     lambda y: _s("nyc_tlc", [_m("SUM", "trips.passenger_count")],
                  ["dates.d_yearmonth"], _yw(y))),
    ("quantity by customer region in {y}", "ssb",
     lambda y: _s("ssb", [_m("SUM", "lineorder.lo_quantity")],
                  ["customer.c_region"], _yw(y))),
    # compositional with a bare noun
    ("earnings and trips and distance by month in {y}", "nyc_tlc",
     lambda y: _s("nyc_tlc", [_m("SUM", "trips.total_amount"), _m("COUNT", "*"),
                              _m("SUM", "trips.trip_distance")],
                  ["dates.d_yearmonth"], _yw(y))),
    ("sales and profit and coupon savings by category in {y}", "tpcds",
     lambda y: _s("tpcds", [_m("SUM", "store_sales.ss_ext_sales_price"),
                            _m("SUM", "store_sales.ss_net_profit"),
                            _m("SUM", "store_sales.ss_coupon_amt")],
                  ["item.i_category"], _yw(y))),
]

_YEARS = {"nyc_tlc": [2023, 2024], "tpcds": [2001, 2002, 2003], "ssb": [1994, 1995, 1996, 1997]}


def _m(agg, expr):
    return Measure(agg, expr)


def _s(schema, measures, levels, tw):
    return Signature(schema=schema, measures=tuple(measures), levels=tuple(levels),
                     time_window=tw)


def _yw(y):
    return TimeWindow(f"{y}-01-01", f"{y + 1}-01-01")


def build(n: int = 150, clean_frac: float = 0.27, seed: int = 5) -> list[AdversarialQuery]:
    rnd = random.Random(seed)
    out: list[AdversarialQuery] = []
    n_clean = int(n * clean_frac)
    pools = [(_CLEAN, n_clean), (_AMBIGUOUS, n - n_clean)]
    for pool, count in pools:
        for i in range(count):
            text_tpl, schema, gold_fn = pool[i % len(pool)]
            y = rnd.choice(_YEARS[schema])
            text = text_tpl.format(y=y)
            out.append(AdversarialQuery(text, gold_fn(y), "birdlike", schema))
    return out[:n]
