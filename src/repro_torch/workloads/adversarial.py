"""The 63 adversarial NL queries (§5.3, Table 2).

Five ambiguity types with the paper's exact counts — metric name (15), time
reference (12), dimension (12), aggregation intent (9), compositional (15).
Each query carries a *gold* signature under the conventional reading
(documented per type below); the simulated model sees only the text, hits the
genuine ambiguity, and resolves it with the calibrated error rates, exactly
reproducing the paper's schema-valid-but-semantically-wrong failure mode.

Gold conventions (the paper's annotator choices):
  * 'revenue'  -> gross (trips.total_amount / ss_ext_sales_price), not net,
  * relative time -> anchored at the dashboard's reference date (2024-03-15),
  * 'area'/'zone'/bare borough -> the *pickup* geography at zone granularity,
  * missing aggregation word on count-like nouns -> the noun's default agg,
  * compositional -> every requested measure must be present.
"""
from __future__ import annotations

import dataclasses
import datetime as _dt
from typing import Optional

from ..core.signature import Filter, Measure, Signature, TimeWindow

REFERENCE_NOW = _dt.date(2024, 3, 15)


@dataclasses.dataclass(frozen=True)
class AdversarialQuery:
    text: str
    gold: Optional[Signature]  # None => any non-None output is Wrong
    ambiguity: str  # 'metric' | 'time' | 'dimension' | 'aggregation' | 'compositional'
    schema: str


def _sig(schema, measures, levels=(), filters=(), tw=None):
    return Signature(schema=schema, measures=tuple(measures), levels=tuple(levels),
                     filters=tuple(filters), time_window=tw)


def _year(y):
    return TimeWindow(f"{y}-01-01", f"{y + 1}-01-01")


def _last_month_window():  # anchored at REFERENCE_NOW
    return TimeWindow("2024-02-01", "2024-03-01", open_ended=True)


def _last_30d_window():
    return TimeWindow("2024-02-14", "2024-03-15", open_ended=True)


def _this_year_window():
    return TimeWindow("2024-01-01", "2024-03-15", open_ended=True)


def build() -> list[AdversarialQuery]:
    out: list[AdversarialQuery] = []
    TA = lambda: Measure("SUM", "trips.total_amount")  # noqa: E731
    SALES = lambda: Measure("SUM", "store_sales.ss_ext_sales_price")  # noqa: E731

    # ---------------------------------------------------- metric name (N=15)
    metric_texts = [
        ("Show total revenue by pickup borough in 2024",
         _sig("nyc_tlc", [TA()], ["zones_pu.pu_borough"], tw=_year(2024))),
        ("What was total revenue by payment type in 2023?",
         _sig("nyc_tlc", [TA()], ["payment.payment_type"], tw=_year(2023))),
        ("total revenue by month in 2024",
         _sig("nyc_tlc", [TA()], ["dates.d_yearmonth"], tw=_year(2024))),
        ("Give me total revenue by pickup zone in q1 2024",
         _sig("nyc_tlc", [TA()], ["zones_pu.pu_zone"],
              tw=TimeWindow("2024-01-01", "2024-04-01"))),
        ("Report total revenue by dropoff borough in 2024",
         _sig("nyc_tlc", [TA()], ["zones_do.do_borough"], tw=_year(2024))),
        ("overall revenue by quarter in 2023",
         _sig("nyc_tlc", [TA()], ["dates.d_quarter"], tw=_year(2023))),
        ("Total revenue by payment type in q2 2024",
         _sig("nyc_tlc", [TA()], ["payment.payment_type"],
              tw=TimeWindow("2024-04-01", "2024-07-01"))),
        ("How does total revenue look by pickup borough in 2023?",
         _sig("nyc_tlc", [TA()], ["zones_pu.pu_borough"], tw=_year(2023))),
        ("total revenue by category in 2002",
         _sig("tpcds", [SALES()], ["item.i_category"], tw=_year(2002))),
        ("Show total revenue by state in 2002",
         _sig("tpcds", [SALES()], ["store.s_state"], tw=_year(2002))),
        ("total revenue by brand in 2003",
         _sig("tpcds", [SALES()], ["item.i_brand"], tw=_year(2003))),
        ("What is total revenue by channel in 2002?",
         _sig("tpcds", [SALES()], ["promotion.p_channel"], tw=_year(2002))),
        ("total revenue by month in 2001",
         _sig("tpcds", [SALES()], ["date_dim.d_yearmonth"], tw=_year(2001))),
        ("Give total revenue by county in 2002",
         _sig("tpcds", [SALES()], ["store.s_county"], tw=_year(2002))),
        ("Report total revenue by class in 2002",
         _sig("tpcds", [SALES()], ["item.i_class"], tw=_year(2002))),
    ]
    out += [AdversarialQuery(t, g, "metric", g.schema) for t, g in metric_texts]

    # ------------------------------------------------- time reference (N=12)
    time_texts = [
        ("Show total earnings by pickup borough last month",
         _sig("nyc_tlc", [TA()], ["zones_pu.pu_borough"], tw=_last_month_window())),
        ("number of trips by payment type last month",
         _sig("nyc_tlc", [Measure("COUNT", "*")], ["payment.payment_type"],
              tw=_last_month_window())),
        ("total tips by pickup zone last month",
         _sig("nyc_tlc", [Measure("SUM", "trips.tip_amount")], ["zones_pu.pu_zone"],
              tw=_last_month_window())),
        ("total earnings by month this year",
         _sig("nyc_tlc", [TA()], ["dates.d_yearmonth"], tw=_this_year_window())),
        ("Show total distance by pickup borough for the last 30 days",
         _sig("nyc_tlc", [Measure("SUM", "trips.trip_distance")],
              ["zones_pu.pu_borough"], tw=_last_30d_window())),
        ("number of rides by dropoff borough last quarter",
         _sig("nyc_tlc", [Measure("COUNT", "*")], ["zones_do.do_borough"],
              tw=TimeWindow("2023-10-01", "2024-01-01", open_ended=True))),
        ("total earnings by payment type last year",
         _sig("nyc_tlc", [TA()], ["payment.payment_type"],
              tw=TimeWindow("2023-01-01", "2024-01-01", open_ended=True))),
        ("total fares by pickup borough last month",
         _sig("nyc_tlc", [Measure("SUM", "trips.fare_amount")],
              ["zones_pu.pu_borough"], tw=_last_month_window())),
        ("recent trips by pickup borough — how many?",
         None),  # 'recently' with no window is unanswerable; any guess is Wrong
        ("total sales by category last year",
         _sig("tpcds", [SALES()], ["item.i_category"],
              tw=TimeWindow("2023-01-01", "2024-01-01", open_ended=True))),
        ("total profit by state last quarter",
         _sig("tpcds", [Measure("SUM", "store_sales.ss_net_profit")],
              ["store.s_state"], tw=TimeWindow("2023-10-01", "2024-01-01", open_ended=True))),
        ("number of transactions by state this year",
         _sig("tpcds", [Measure("COUNT", "*")], ["store.s_state"],
              tw=_this_year_window())),
    ]
    out += [AdversarialQuery(t, g, "time", g.schema if g else "nyc_tlc")
            for t, g in time_texts]

    # ------------------------------------------------------ dimension (N=12)
    dim_texts = [
        ("Show total earnings by area in 2024",
         _sig("nyc_tlc", [TA()], ["zones_pu.pu_zone"], tw=_year(2024))),
        ("number of trips by area in 2023",
         _sig("nyc_tlc", [Measure("COUNT", "*")], ["zones_pu.pu_zone"], tw=_year(2023))),
        ("total tips by area in q1 2024",
         _sig("nyc_tlc", [Measure("SUM", "trips.tip_amount")], ["zones_pu.pu_zone"],
              tw=TimeWindow("2024-01-01", "2024-04-01"))),
        ("total earnings by zone in 2024",
         _sig("nyc_tlc", [TA()], ["zones_pu.pu_zone"], tw=_year(2024))),
        ("number of rides by zone in q2 2023",
         _sig("nyc_tlc", [Measure("COUNT", "*")], ["zones_pu.pu_zone"],
              tw=TimeWindow("2023-04-01", "2023-07-01"))),
        ("total distance by borough in 2024",
         _sig("nyc_tlc", [Measure("SUM", "trips.trip_distance")],
              ["zones_pu.pu_borough"], tw=_year(2024))),
        ("total earnings by borough in 2023",
         _sig("nyc_tlc", [TA()], ["zones_pu.pu_borough"], tw=_year(2023))),
        ("number of trips for manhattan by month in 2024",
         _sig("nyc_tlc", [Measure("COUNT", "*")], ["dates.d_yearmonth"],
              [Filter("zones_pu.pu_borough", "=", "Manhattan")], tw=_year(2024))),
        ("total earnings for brooklyn by quarter in 2024",
         _sig("nyc_tlc", [TA()], ["dates.d_quarter"],
              [Filter("zones_pu.pu_borough", "=", "Brooklyn")], tw=_year(2024))),
        ("total fares for queens by month in 2023",
         _sig("nyc_tlc", [Measure("SUM", "trips.fare_amount")], ["dates.d_yearmonth"],
              [Filter("zones_pu.pu_borough", "=", "Queens")], tw=_year(2023))),
        ("total revenue by region in 1997",
         _sig("ssb", [Measure("SUM", "lineorder.lo_revenue")],
              ["customer.c_region"], tw=_year(1997))),
        ("total profit by nation in 1995",
         _sig("ssb", [Measure("SUM", "(lineorder.lo_revenue-lineorder.lo_supplycost)")],
              ["customer.c_nation"], tw=_year(1995))),
    ]
    out += [AdversarialQuery(t, g, "dimension", g.schema) for t, g in dim_texts]

    # ----------------------------------------------------- aggregation (N=9)
    agg_texts = [
        ("trips by payment type in 2024",
         _sig("nyc_tlc", [Measure("COUNT", "*")], ["payment.payment_type"],
              tw=_year(2024))),
        ("rides by pickup borough in 2023",
         _sig("nyc_tlc", [Measure("COUNT", "*")], ["zones_pu.pu_borough"],
              tw=_year(2023))),
        ("trips by month in 2024",
         _sig("nyc_tlc", [Measure("COUNT", "*")], ["dates.d_yearmonth"],
              tw=_year(2024))),
        ("passengers by pickup borough in 2024",
         _sig("nyc_tlc", [Measure("SUM", "trips.passenger_count")],
              ["zones_pu.pu_borough"], tw=_year(2024))),
        ("rides by quarter in 2024",
         _sig("nyc_tlc", [Measure("COUNT", "*")], ["dates.d_quarter"], tw=_year(2024))),
        ("trips by dropoff borough in q3 2024",
         _sig("nyc_tlc", [Measure("COUNT", "*")], ["zones_do.do_borough"],
              tw=TimeWindow("2024-07-01", "2024-10-01"))),
        ("passengers by month in 2023",
         _sig("nyc_tlc", [Measure("SUM", "trips.passenger_count")],
              ["dates.d_yearmonth"], tw=_year(2023))),
        ("units sold by category in 2002",
         _sig("tpcds", [Measure("SUM", "store_sales.ss_quantity")],
              ["item.i_category"], tw=_year(2002))),
        ("quantity by customer region in 1994",
         _sig("ssb", [Measure("SUM", "lineorder.lo_quantity")],
              ["customer.c_region"], tw=_year(1994))),
    ]
    out += [AdversarialQuery(t, g, "aggregation", g.schema) for t, g in agg_texts]

    # -------------------------------------------------- compositional (N=15)
    comp_texts = [
        ("Show earnings, tips and distance by pickup borough in 2024",
         _sig("nyc_tlc", [TA(), Measure("SUM", "trips.tip_amount"),
                          Measure("SUM", "trips.trip_distance")],
              ["zones_pu.pu_borough"], tw=_year(2024))),
        ("fares, tips and passengers by payment type in 2024",
         _sig("nyc_tlc", [Measure("SUM", "trips.fare_amount"),
                          Measure("SUM", "trips.tip_amount"),
                          Measure("SUM", "trips.passenger_count")],
              ["payment.payment_type"], tw=_year(2024))),
        ("earnings and trips by month in 2024",
         _sig("nyc_tlc", [TA(), Measure("COUNT", "*")], ["dates.d_yearmonth"],
              tw=_year(2024))),
        ("distance and earnings and tips by pickup zone in q1 2024",
         _sig("nyc_tlc", [Measure("SUM", "trips.trip_distance"), TA(),
                          Measure("SUM", "trips.tip_amount")],
              ["zones_pu.pu_zone"], tw=TimeWindow("2024-01-01", "2024-04-01"))),
        ("tips and fares by dropoff borough in 2023",
         _sig("nyc_tlc", [Measure("SUM", "trips.tip_amount"),
                          Measure("SUM", "trips.fare_amount")],
              ["zones_do.do_borough"], tw=_year(2023))),
        ("earnings, fares, tips by quarter in 2024",
         _sig("nyc_tlc", [TA(), Measure("SUM", "trips.fare_amount"),
                          Measure("SUM", "trips.tip_amount")],
              ["dates.d_quarter"], tw=_year(2024))),
        ("trips and passengers by pickup borough in 2024",
         _sig("nyc_tlc", [Measure("COUNT", "*"),
                          Measure("SUM", "trips.passenger_count")],
              ["zones_pu.pu_borough"], tw=_year(2024))),
        ("distance and passengers by month in 2023",
         _sig("nyc_tlc", [Measure("SUM", "trips.trip_distance"),
                          Measure("SUM", "trips.passenger_count")],
              ["dates.d_yearmonth"], tw=_year(2023))),
        ("sales, profit and coupon savings by category in 2002",
         _sig("tpcds", [SALES(), Measure("SUM", "store_sales.ss_net_profit"),
                        Measure("SUM", "store_sales.ss_coupon_amt")],
              ["item.i_category"], tw=_year(2002))),
        ("profit and sales by state in 2002",
         _sig("tpcds", [Measure("SUM", "store_sales.ss_net_profit"), SALES()],
              ["store.s_state"], tw=_year(2002))),
        ("sales and transactions by brand in 2003",
         _sig("tpcds", [SALES(), Measure("COUNT", "*")], ["item.i_brand"],
              tw=_year(2003))),
        ("units sold and sales by class in 2002",
         _sig("tpcds", [Measure("SUM", "store_sales.ss_quantity"), SALES()],
              ["item.i_class"], tw=_year(2002))),
        ("revenue and profit by year",
         _sig("ssb", [Measure("SUM", "lineorder.lo_revenue"),
                      Measure("SUM", "(lineorder.lo_revenue-lineorder.lo_supplycost)")],
              ["dates.d_year"])),
        ("revenue, quantity and supply cost by customer region in 1996",
         _sig("ssb", [Measure("SUM", "lineorder.lo_revenue"),
                      Measure("SUM", "lineorder.lo_quantity"),
                      Measure("SUM", "lineorder.lo_supplycost")],
              ["customer.c_region"], tw=_year(1996))),
        ("profit and orders by supplier nation in 1997",
         _sig("ssb", [Measure("SUM", "(lineorder.lo_revenue-lineorder.lo_supplycost)"),
                      Measure("COUNT", "*")],
              ["supplier.s_nation"], tw=_year(1997))),
    ]
    out += [AdversarialQuery(t, g, "compositional", g.schema) for t, g in comp_texts]

    assert len(out) == 63, len(out)
    counts = {}
    for q in out:
        counts[q.ambiguity] = counts.get(q.ambiguity, 0) + 1
    assert counts == {"metric": 15, "time": 12, "dimension": 12,
                      "aggregation": 9, "compositional": 15}, counts
    return out


def score(queries, results) -> dict:
    """Classify each (gold, NLResult) as correct / wrong / invalid (Table 2)."""
    per_type: dict[str, dict[str, int]] = {}
    rows = []
    for q, r in zip(queries, results):
        bucket = per_type.setdefault(q.ambiguity, {"correct": 0, "wrong": 0, "invalid": 0})
        if r.signature is None:
            verdict = "invalid"
        elif q.gold is not None and r.signature.key() == q.gold.key():
            verdict = "correct"
        else:
            verdict = "wrong"
        bucket[verdict] += 1
        rows.append((q, r, verdict))
    return {"per_type": per_type, "rows": rows}
