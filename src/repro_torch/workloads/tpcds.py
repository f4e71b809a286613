"""TPC-DS-style workload (14 in-scope canonical intents, §3.1/§5.1).

The paper keeps 14 of 99 TPC-DS templates — the dashboard-shaped aggregations
without window functions / CTEs / set operations.  This module mirrors that
in-scope fragment over a store_sales star: more multi-measure ("compositional")
and HAVING/top-k intents than SSB or TLC, which is what drives its lower NL
coverage in the paper's Table 1.
"""
from __future__ import annotations

import datetime as _dt

import numpy as np

from ..core.nl_canon import MeasureSense, NLVocab
from ..core.schema import Column, Dimension, FactTable, Hierarchy, StarSchema
from ..olap.columnar import ColumnData, Dataset, TableData
from .base import Intent, Workload

STATES = ["CA", "NY", "TX", "WA", "IL", "FL", "GA", "MI", "OH", "PA"]
CHANNELS = ["email", "tv", "radio", "web"]
CATEGORIES = ["Books", "Electronics", "Home", "Jewelry", "Men", "Music",
              "Shoes", "Sports", "Toys", "Women"]


def build_schema() -> StarSchema:
    date_dim = Dimension(
        name="date_dim", fact_fk="ss_sold_date_key", pk="d_key",
        columns=(
            Column("d_key", "int"), Column("d_date", "date"),
            Column("d_yearmonth", "str"), Column("d_quarter", "str"),
            Column("d_year", "int"),
        ),
        hierarchies=(Hierarchy("time", ("d_date", "d_yearmonth", "d_quarter", "d_year")),),
        time_kinds=(
            ("d_date", "date"), ("d_year", "year"),
            ("d_yearmonth", "yearmonth_str"), ("d_quarter", "yearquarter_str"),
        ),
    )
    item = Dimension(
        name="item", fact_fk="ss_item_key", pk="i_key",
        columns=(
            Column("i_key", "int"), Column("i_brand", "str"),
            Column("i_class", "str"), Column("i_category", "str"),
        ),
        hierarchies=(Hierarchy("prod", ("i_brand", "i_class", "i_category")),),
    )
    store = Dimension(
        name="store", fact_fk="ss_store_key", pk="s_key",
        columns=(
            Column("s_key", "int"), Column("s_store_name", "str"),
            Column("s_county", "str"), Column("s_state", "str"),
        ),
        hierarchies=(Hierarchy("geo", ("s_store_name", "s_county", "s_state")),),
    )
    promotion = Dimension(
        name="promotion", fact_fk="ss_promo_key", pk="p_key",
        columns=(Column("p_key", "int"), Column("p_channel", "str")),
    )
    fact = FactTable(
        name="store_sales",
        columns=(
            Column("ss_sold_date_key", "int"), Column("ss_item_key", "int"),
            Column("ss_store_key", "int"), Column("ss_promo_key", "int"),
            Column("ss_quantity", "int"), Column("ss_ext_sales_price", "float"),
            Column("ss_net_paid", "float"), Column("ss_net_profit", "float"),
            Column("ss_coupon_amt", "float"), Column("ss_date", "date"),
        ),
        date_column="ss_date",
    )
    sch = StarSchema("tpcds", fact, (date_dim, item, store, promotion),
                     time_dimension="date_dim")
    sch.validate()
    return sch


def build_dataset(schema: StarSchema, n_fact: int = 150_000, seed: int = 2) -> Dataset:
    rng = np.random.default_rng(seed)
    start = _dt.date(2000, 1, 1)
    days = (_dt.date(2003, 12, 31) - start).days + 1
    all_dates = [start + _dt.timedelta(days=i) for i in range(days)]
    mon = ["Jan", "Feb", "Mar", "Apr", "May", "Jun",
           "Jul", "Aug", "Sep", "Oct", "Nov", "Dec"]
    date_dim = TableData("date_dim", {
        "d_key": ColumnData("int", np.arange(days)),
        "d_date": ColumnData("date", np.asarray([d.isoformat() for d in all_dates])),
        "d_yearmonth": ColumnData("str", np.asarray(
            [f"{mon[d.month - 1]}{d.year}" for d in all_dates])),
        "d_quarter": ColumnData("str", np.asarray(
            [f"{d.year}Q{(d.month - 1) // 3 + 1}" for d in all_dates])),
        "d_year": ColumnData("int", np.asarray([d.year for d in all_dates])),
    })
    classes = [f"{c}_class_{j}" for c in CATEGORIES for j in range(3)]
    class_cat = {cl: CATEGORIES[i // 3] for i, cl in enumerate(classes)}
    brands = [f"{cl}_brand_{k}" for cl in classes for k in range(4)]
    brand_class = {b: classes[i // 4] for i, b in enumerate(brands)}
    n_item = 2000
    bi = rng.integers(0, len(brands), size=n_item)
    bs = np.asarray(brands)[bi]
    item = TableData("item", {
        "i_key": ColumnData("int", np.arange(n_item)),
        "i_brand": ColumnData("str", bs),
        "i_class": ColumnData("str", np.asarray([brand_class[b] for b in bs])),
        "i_category": ColumnData("str", np.asarray(
            [class_cat[brand_class[b]] for b in bs])),
    })
    counties = [f"{s}_county_{j}" for s in STATES for j in range(3)]
    county_state = {c: STATES[i // 3] for i, c in enumerate(counties)}
    n_store = 120
    ci = rng.integers(0, len(counties), size=n_store)
    cs = np.asarray(counties)[ci]
    store = TableData("store", {
        "s_key": ColumnData("int", np.arange(n_store)),
        "s_store_name": ColumnData("str", np.asarray(
            [f"store_{i:03d}" for i in range(n_store)])),
        "s_county": ColumnData("str", cs),
        "s_state": ColumnData("str", np.asarray([county_state[c] for c in cs])),
    })
    promotion = TableData("promotion", {
        "p_key": ColumnData("int", np.arange(len(CHANNELS))),
        "p_channel": ColumnData("str", np.asarray(CHANNELS)),
    })
    dk = rng.integers(0, days, size=n_fact)
    qty = rng.integers(1, 20, size=n_fact)
    price = np.round(rng.uniform(5, 300, size=n_fact) * qty, 2)
    coupon = np.round(np.where(rng.random(n_fact) < 0.2, price * 0.1, 0.0), 2)
    paid = np.round(price - coupon, 2)
    profit = np.round(paid - price * rng.uniform(0.5, 0.9, size=n_fact), 2)
    fact = TableData("store_sales", {
        "ss_sold_date_key": ColumnData("int", dk),
        "ss_item_key": ColumnData("int", rng.integers(0, n_item, size=n_fact)),
        "ss_store_key": ColumnData("int", rng.integers(0, n_store, size=n_fact)),
        "ss_promo_key": ColumnData("int", rng.integers(0, len(CHANNELS), size=n_fact)),
        "ss_quantity": ColumnData("int", qty),
        "ss_ext_sales_price": ColumnData("float", price),
        "ss_net_paid": ColumnData("float", paid),
        "ss_net_profit": ColumnData("float", profit),
        "ss_coupon_amt": ColumnData("float", coupon),
        "ss_date": ColumnData("date", date_dim.columns["d_date"].data[dk].copy()),
    })
    return Dataset(schema, fact, {
        "date_dim": date_dim, "item": item, "store": store, "promotion": promotion,
    })


def build_vocab() -> NLVocab:
    return NLVocab(
        schema="tpcds",
        measures={
            "sales": (MeasureSense("store_sales.ss_ext_sales_price", "SUM"),),
            "profit": (MeasureSense("store_sales.ss_net_profit", "SUM"),),
            "net paid": (MeasureSense("store_sales.ss_net_paid", "SUM"),),
            "coupon savings": (MeasureSense("store_sales.ss_coupon_amt", "SUM"),),
            "units sold": (MeasureSense("store_sales.ss_quantity", "SUM"),),
            "transactions": (MeasureSense("*", "COUNT"),),
            # adversarial: 'revenue' net-vs-gross
            "revenue": (
                MeasureSense("store_sales.ss_ext_sales_price", "SUM"),
                MeasureSense("store_sales.ss_net_paid", "SUM"),
            ),
        },
        levels={
            "year": ("date_dim.d_year",),
            "quarter": ("date_dim.d_quarter",),
            "month": ("date_dim.d_yearmonth",),
            "category": ("item.i_category",),
            "class": ("item.i_class",),
            "brand": ("item.i_brand",),
            "state": ("store.s_state",),
            "county": ("store.s_county",),
            "store": ("store.s_store_name",),
            "channel": ("promotion.p_channel",),
        },
        values={
            **{f"in category {c.lower()}": (("item.i_category", c),) for c in CATEGORIES},
            **{f"in state {s.lower()}": (("store.s_state", s),) for s in STATES},
            **{f"via {ch}": (("promotion.p_channel", ch),) for ch in CHANNELS},
        },
        numeric_cols={"quantity": "store_sales.ss_quantity"},
        agg_ambiguous_nouns=("units sold",),
    )


_JD = "JOIN date_dim ON store_sales.ss_sold_date_key = date_dim.d_key "
_JI = "JOIN item ON store_sales.ss_item_key = item.i_key "
_JS = "JOIN store ON store_sales.ss_store_key = store.s_key "
_JP = "JOIN promotion ON store_sales.ss_promo_key = promotion.p_key "

_INTENTS = [
    Intent(
        "ds_01",
        f"SELECT i_category, SUM(ss_ext_sales_price) AS sales FROM store_sales {_JI}{_JD}"
        "WHERE d_year = 2002 GROUP BY i_category",
        nl_measures=("total sales",), nl_levels=("category",), nl_time="in 2002",
    ),
    Intent(
        "ds_02",
        f"SELECT s_state, SUM(ss_net_profit) AS profit FROM store_sales {_JS}{_JD}"
        "WHERE d_year = 2002 GROUP BY s_state",
        nl_measures=("total profit",), nl_levels=("state",), nl_time="in 2002",
    ),
    Intent(
        "ds_03",
        f"SELECT i_brand, SUM(ss_ext_sales_price) AS sales FROM store_sales {_JI}{_JD}"
        "WHERE i_category = 'Electronics' AND d_yearmonth = 'Mar2002' GROUP BY i_brand",
        nl_measures=("total sales",), nl_levels=("brand",),
        nl_filters=("in category electronics",), nl_time="in march 2002",
    ),
    Intent(
        "ds_04",
        f"SELECT d_yearmonth, SUM(ss_ext_sales_price) AS sales, SUM(ss_net_profit) AS profit "
        f"FROM store_sales {_JD}"
        "WHERE d_year = 2001 GROUP BY d_yearmonth",
        nl_measures=("total sales", "total profit"), nl_levels=("month",), nl_time="in 2001",
    ),
    Intent(
        "ds_05",
        f"SELECT i_category, s_state, SUM(ss_net_paid) AS paid FROM store_sales {_JI}{_JS}{_JD}"
        "WHERE d_quarter = '2002Q4' GROUP BY i_category, s_state",
        nl_measures=("total net paid",), nl_levels=("category", "state"),
        nl_time="in q4 2002",
    ),
    Intent(
        "ds_06",
        f"SELECT p_channel, SUM(ss_coupon_amt) AS coupons FROM store_sales {_JP}{_JD}"
        "WHERE d_year = 2003 GROUP BY p_channel",
        nl_measures=("total coupon savings",), nl_levels=("channel",), nl_time="in 2003",
    ),
    Intent(
        "ds_07",
        f"SELECT i_class, SUM(ss_quantity) AS units FROM store_sales {_JI}{_JD}"
        "WHERE i_category = 'Sports' AND d_year = 2002 GROUP BY i_class",
        nl_measures=("total units sold",), nl_levels=("class",),
        nl_filters=("in category sports",), nl_time="in 2002",
    ),
    Intent(
        "ds_08",
        f"SELECT s_state, COUNT(*) AS n FROM store_sales {_JS}{_JD}"
        "WHERE d_quarter = '2003Q1' GROUP BY s_state",
        nl_measures=("number of transactions",), nl_levels=("state",), nl_time="in q1 2003",
    ),
    Intent(
        "ds_09",
        f"SELECT i_category, SUM(ss_ext_sales_price) AS sales FROM store_sales {_JI}{_JD}"
        "WHERE d_year = 2002 GROUP BY i_category "
        "HAVING SUM(ss_ext_sales_price) > 100000",
        nl_measures=("total sales",), nl_levels=("category",), nl_time="in 2002",
        nl_extra="having total sales over 100000",
    ),
    Intent(
        "ds_10",
        f"SELECT i_brand, SUM(ss_ext_sales_price) AS sales FROM store_sales {_JI}{_JD}"
        "WHERE d_year = 2003 GROUP BY i_brand ORDER BY SUM(ss_ext_sales_price) DESC "
        "LIMIT 10",
        nl_measures=("total sales",), nl_levels=("brand",), nl_time="in 2003",
        nl_extra="top 10",
    ),
    Intent(
        "ds_11",
        f"SELECT d_year, AVG(ss_net_paid) AS avg_paid FROM store_sales {_JD}"
        "GROUP BY d_year",
        nl_measures=("average net paid",), nl_levels=("year",),
    ),
    Intent(
        "ds_12",
        f"SELECT s_county, SUM(ss_net_profit) AS profit FROM store_sales {_JS}{_JD}"
        "WHERE s_state = 'CA' AND d_year = 2002 GROUP BY s_county",
        nl_measures=("total profit",), nl_levels=("county",),
        nl_filters=("in state ca",), nl_time="in 2002",
    ),
    Intent(
        "ds_13",
        f"SELECT i_category, SUM(ss_ext_sales_price) AS sales, SUM(ss_coupon_amt) AS coupons "
        f"FROM store_sales {_JI}{_JD}"
        "WHERE d_year = 2002 AND ss_quantity < 10 GROUP BY i_category",
        nl_measures=("total sales", "total coupon savings"), nl_levels=("category",),
        nl_filters=("with quantity under 10",), nl_time="in 2002",
    ),
    Intent(
        "ds_14",
        f"SELECT d_quarter, SUM(ss_ext_sales_price) AS sales, SUM(ss_net_profit) AS profit "
        f"FROM store_sales {_JD}{_JI}"
        "WHERE i_category = 'Books' GROUP BY d_quarter",
        nl_measures=("total sales", "total profit"), nl_levels=("quarter",),
        nl_filters=("in category books",),
    ),
]


def build(n_fact: int = 150_000, seed: int = 2) -> Workload:
    schema = build_schema()
    return Workload(
        name="tpcds",
        schema=schema,
        dataset=build_dataset(schema, n_fact=n_fact, seed=seed),
        intents=list(_INTENTS),
        vocab=build_vocab(),
        spatial_ambiguous=(),
    )
