"""Star Schema Benchmark workload (13 canonical intents, §5.1).

Synthetic SSB-shaped data: lineorder fact + date/customer/supplier/part
dimensions with the classic hierarchies (date < month < quarter < year;
city < nation < region; brand < category < mfgr).  Query intents adapt the
13 SSB flights to the paper's §3.1 subset (weeknum predicates become quarter
windows; IN-lists become equality filters) plus COUNT/AVG dashboard intents.
"""
from __future__ import annotations

import datetime as _dt

import numpy as np

from ..core.nl_canon import MeasureSense, NLVocab
from ..core.schema import Column, Dimension, FactTable, Hierarchy, StarSchema
from ..olap.columnar import ColumnData, Dataset, TableData
from .base import Intent, Workload

REGIONS = ["AFRICA", "AMERICA", "ASIA", "EUROPE", "MIDDLE EAST"]


def build_schema() -> StarSchema:
    dates = Dimension(
        name="dates", fact_fk="lo_orderdate", pk="d_key",
        columns=(
            Column("d_key", "int"), Column("d_date", "date"),
            Column("d_yearmonth", "str"), Column("d_quarter", "str"),
            Column("d_year", "int"), Column("d_yearmonthnum", "int"),
            Column("d_weeknuminyear", "int"),
        ),
        hierarchies=(Hierarchy("time", ("d_date", "d_yearmonth", "d_quarter", "d_year")),),
        time_kinds=(
            ("d_date", "date"), ("d_year", "year"),
            ("d_yearmonthnum", "yearmonthnum"), ("d_yearmonth", "yearmonth_str"),
            ("d_quarter", "yearquarter_str"),
        ),
    )
    customer = Dimension(
        name="customer", fact_fk="lo_custkey", pk="c_key",
        columns=(
            Column("c_key", "int"), Column("c_city", "str"),
            Column("c_nation", "str"), Column("c_region", "str"),
        ),
        hierarchies=(Hierarchy("geo", ("c_city", "c_nation", "c_region")),),
    )
    supplier = Dimension(
        name="supplier", fact_fk="lo_suppkey", pk="s_key",
        columns=(
            Column("s_key", "int"), Column("s_city", "str"),
            Column("s_nation", "str"), Column("s_region", "str"),
        ),
        hierarchies=(Hierarchy("geo", ("s_city", "s_nation", "s_region")),),
    )
    part = Dimension(
        name="part", fact_fk="lo_partkey", pk="p_key",
        columns=(
            Column("p_key", "int"), Column("p_brand", "str"),
            Column("p_category", "str"), Column("p_mfgr", "str"),
        ),
        hierarchies=(Hierarchy("prod", ("p_brand", "p_category", "p_mfgr")),),
    )
    fact = FactTable(
        name="lineorder",
        columns=(
            Column("lo_orderdate", "int"), Column("lo_custkey", "int"),
            Column("lo_suppkey", "int"), Column("lo_partkey", "int"),
            Column("lo_quantity", "int"), Column("lo_extendedprice", "float"),
            Column("lo_discount", "int"), Column("lo_revenue", "float"),
            Column("lo_supplycost", "float"), Column("lo_date", "date"),
        ),
        date_column="lo_date",
    )
    sch = StarSchema("ssb", fact, (dates, customer, supplier, part), time_dimension="dates")
    sch.validate()
    return sch


def build_dataset(schema: StarSchema, n_fact: int = 120_000, seed: int = 0) -> Dataset:
    rng = np.random.default_rng(seed)
    # ---- dates: 1992-01-01 .. 1998-12-31
    start = _dt.date(1992, 1, 1)
    days = (
        _dt.date(1998, 12, 31) - start
    ).days + 1
    all_dates = [start + _dt.timedelta(days=i) for i in range(days)]
    mon_names = ["Jan", "Feb", "Mar", "Apr", "May", "Jun",
                 "Jul", "Aug", "Sep", "Oct", "Nov", "Dec"]
    dates = TableData("dates", {
        "d_key": ColumnData("int", np.arange(days)),
        "d_date": ColumnData("date", np.asarray([d.isoformat() for d in all_dates])),
        "d_yearmonth": ColumnData("str", np.asarray(
            [f"{mon_names[d.month - 1]}{d.year}" for d in all_dates])),
        "d_quarter": ColumnData("str", np.asarray(
            [f"{d.year}Q{(d.month - 1) // 3 + 1}" for d in all_dates])),
        "d_year": ColumnData("int", np.asarray([d.year for d in all_dates])),
        "d_yearmonthnum": ColumnData("int", np.asarray(
            [d.year * 100 + d.month for d in all_dates])),
        "d_weeknuminyear": ColumnData("int", np.asarray(
            [d.isocalendar()[1] for d in all_dates])),
    })
    # ---- geography: 5 regions x 5 nations x 10 cities (functional)
    nations = [f"{r[:4]}_NATION_{i}" for r in REGIONS for i in range(5)]
    nation_region = {n: REGIONS[i // 5] for i, n in enumerate(nations)}
    cities = [f"{n}_C{j}" for n in nations for j in range(10)]
    city_nation = {c: nations[i // 10] for i, c in enumerate(cities)}

    def geo_table(name: str, prefix: str, n_rows: int) -> TableData:
        city_idx = rng.integers(0, len(cities), size=n_rows)
        cs = np.asarray(cities)[city_idx]
        ns = np.asarray([city_nation[c] for c in cs])
        rs = np.asarray([nation_region[n] for n in ns])
        return TableData(name, {
            f"{prefix}_key": ColumnData("int", np.arange(n_rows)),
            f"{prefix}_city": ColumnData("str", cs),
            f"{prefix}_nation": ColumnData("str", ns),
            f"{prefix}_region": ColumnData("str", rs),
        })

    customer = geo_table("customer", "c", 3000)
    supplier = geo_table("supplier", "s", 1000)
    # ---- parts: 5 mfgr x 5 categories x 8 brands (functional)
    mfgrs = [f"MFGR#{i+1}" for i in range(5)]
    categories = [f"MFGR#{i+1}{j+1}" for i in range(5) for j in range(5)]
    cat_mfgr = {c: mfgrs[i // 5] for i, c in enumerate(categories)}
    brands = [f"{c}{k+1:02d}" for c in categories for k in range(8)]
    brand_cat = {b: categories[i // 8] for i, b in enumerate(brands)}
    n_part = 1200
    bidx = rng.integers(0, len(brands), size=n_part)
    bs = np.asarray(brands)[bidx]
    part = TableData("part", {
        "p_key": ColumnData("int", np.arange(n_part)),
        "p_brand": ColumnData("str", bs),
        "p_category": ColumnData("str", np.asarray([brand_cat[b] for b in bs])),
        "p_mfgr": ColumnData("str", np.asarray([cat_mfgr[brand_cat[b]] for b in bs])),
    })
    # ---- fact
    od = rng.integers(0, days, size=n_fact)
    qty = rng.integers(1, 51, size=n_fact)
    price = np.round(rng.uniform(100, 10_000, size=n_fact), 2)
    disc = rng.integers(0, 11, size=n_fact)
    revenue = np.round(price * (1 - disc / 100.0), 2)
    cost = np.round(price * rng.uniform(0.4, 0.8, size=n_fact), 2)
    fact = TableData("lineorder", {
        "lo_orderdate": ColumnData("int", od),
        "lo_custkey": ColumnData("int", rng.integers(0, customer.num_rows, size=n_fact)),
        "lo_suppkey": ColumnData("int", rng.integers(0, supplier.num_rows, size=n_fact)),
        "lo_partkey": ColumnData("int", rng.integers(0, n_part, size=n_fact)),
        "lo_quantity": ColumnData("int", qty),
        "lo_extendedprice": ColumnData("float", price),
        "lo_discount": ColumnData("int", disc),
        "lo_revenue": ColumnData("float", revenue),
        "lo_supplycost": ColumnData("float", cost),
        "lo_date": ColumnData("date", dates.columns["d_date"].data[od].copy()),
    })
    return Dataset(schema, fact, {
        "dates": dates, "customer": customer, "supplier": supplier, "part": part,
    })


def build_vocab() -> NLVocab:
    return NLVocab(
        schema="ssb",
        measures={
            "revenue": (MeasureSense("lineorder.lo_revenue", "SUM"),),
            "discounted revenue": (
                MeasureSense("(lineorder.lo_discount*lineorder.lo_extendedprice)", "SUM"),),
            "profit": (
                MeasureSense("(lineorder.lo_revenue-lineorder.lo_supplycost)", "SUM"),),
            "orders": (MeasureSense("*", "COUNT"),),
            "quantity": (MeasureSense("lineorder.lo_quantity", "SUM"),),
            "supply cost": (MeasureSense("lineorder.lo_supplycost", "SUM"),),
        },
        levels={
            "year": ("dates.d_year",),
            "quarter": ("dates.d_quarter",),
            "month": ("dates.d_yearmonth",),
            "customer region": ("customer.c_region",),
            "customer nation": ("customer.c_nation",),
            "customer city": ("customer.c_city",),
            "supplier region": ("supplier.s_region",),
            "supplier nation": ("supplier.s_nation",),
            "supplier city": ("supplier.s_city",),
            "brand": ("part.p_brand",),
            "category": ("part.p_category",),
            "manufacturer": ("part.p_mfgr",),
            # deliberately ambiguous (adversarial use only)
            "region": ("customer.c_region", "supplier.s_region"),
            "nation": ("customer.c_nation", "supplier.s_nation"),
            "city": ("customer.c_city", "supplier.s_city"),
        },
        values={
            # context-qualified phrases keep the controlled workload unambiguous
            **{f"customers in {r.lower()}": (("customer.c_region", r),) for r in REGIONS},
            **{f"suppliers in {r.lower()}": (("supplier.s_region", r),) for r in REGIONS},
            **{f"category mfgr#{i+1}{j+1}": (("part.p_category", f"MFGR#{i+1}{j+1}"),)
               for i in range(5) for j in range(5)},
            "brand mfgr#2239": (("part.p_brand", "MFGR#2308"),),
            "nation asia_nation_0": (("customer.c_nation", "ASIA_NATION_0"),),
            # bare region names are ambiguous customer-vs-supplier (adversarial)
            **{r.lower(): (("customer.c_region", r), ("supplier.s_region", r))
               for r in REGIONS},
        },
        numeric_cols={
            "quantity": "lineorder.lo_quantity",
            "discount": "lineorder.lo_discount",
        },
        agg_ambiguous_nouns=("quantity",),
    )


# canonical SQL intents (adapted SSB flights + dashboard intents)
_INTENTS = [
    Intent(
        "ssb_q1_1",
        "SELECT SUM(lo_extendedprice * lo_discount) AS revenue FROM lineorder "
        "JOIN dates ON lineorder.lo_orderdate = dates.d_key "
        "WHERE d_year = 1993 AND lo_discount BETWEEN 1 AND 3 AND lo_quantity < 25",
        nl_measures=("total discounted revenue",),
        nl_filters=("with discount between 1 and 3", "and quantity under 25"),
        nl_time="in 1993",
    ),
    Intent(
        "ssb_q1_2",
        "SELECT SUM(lo_extendedprice * lo_discount) AS revenue FROM lineorder "
        "JOIN dates ON lineorder.lo_orderdate = dates.d_key "
        "WHERE d_yearmonthnum = 199401 AND lo_discount BETWEEN 4 AND 6 "
        "AND lo_quantity BETWEEN 26 AND 35",
        nl_measures=("total discounted revenue",),
        nl_filters=("with discount between 4 and 6", "and quantity between 26 and 35"),
        nl_time="in january 1994",
    ),
    Intent(
        "ssb_q1_3",
        "SELECT SUM(lo_extendedprice * lo_discount) AS revenue FROM lineorder "
        "JOIN dates ON lineorder.lo_orderdate = dates.d_key "
        "WHERE d_quarter = '1994Q1' AND lo_discount BETWEEN 5 AND 7",
        nl_measures=("total discounted revenue",),
        nl_filters=("with discount between 5 and 7",),
        nl_time="in q1 1994",
    ),
    Intent(
        "ssb_q2_1",
        "SELECT d_year, p_brand, SUM(lo_revenue) AS revenue FROM lineorder "
        "JOIN dates ON lineorder.lo_orderdate = dates.d_key "
        "JOIN part ON lineorder.lo_partkey = part.p_key "
        "JOIN supplier ON lineorder.lo_suppkey = supplier.s_key "
        "WHERE p_category = 'MFGR#12' AND s_region = 'AMERICA' "
        "GROUP BY d_year, p_brand",
        nl_measures=("total revenue",),
        nl_levels=("year", "brand"),
        nl_filters=("for category mfgr#12", "from suppliers in america"),
    ),
    Intent(
        "ssb_q2_2",
        "SELECT d_year, p_brand, SUM(lo_revenue) AS revenue FROM lineorder "
        "JOIN dates ON lineorder.lo_orderdate = dates.d_key "
        "JOIN part ON lineorder.lo_partkey = part.p_key "
        "JOIN supplier ON lineorder.lo_suppkey = supplier.s_key "
        "WHERE p_category = 'MFGR#22' AND s_region = 'ASIA' "
        "GROUP BY d_year, p_brand",
        nl_measures=("total revenue",),
        nl_levels=("year", "brand"),
        nl_filters=("for category mfgr#22", "from suppliers in asia"),
    ),
    Intent(
        "ssb_q2_3",
        "SELECT d_year, SUM(lo_revenue) AS revenue FROM lineorder "
        "JOIN dates ON lineorder.lo_orderdate = dates.d_key "
        "JOIN part ON lineorder.lo_partkey = part.p_key "
        "JOIN supplier ON lineorder.lo_suppkey = supplier.s_key "
        "WHERE p_brand = 'MFGR#2308' AND s_region = 'EUROPE' "
        "GROUP BY d_year",
        nl_measures=("total revenue",),
        nl_levels=("year",),
        nl_filters=("for brand mfgr#2239", "from suppliers in europe"),
    ),
    Intent(
        "ssb_q3_1",
        "SELECT c_nation, s_nation, d_year, SUM(lo_revenue) AS revenue FROM lineorder "
        "JOIN dates ON lineorder.lo_orderdate = dates.d_key "
        "JOIN customer ON lineorder.lo_custkey = customer.c_key "
        "JOIN supplier ON lineorder.lo_suppkey = supplier.s_key "
        "WHERE c_region = 'ASIA' AND s_region = 'ASIA' AND d_year BETWEEN 1992 AND 1997 "
        "GROUP BY c_nation, s_nation, d_year",
        nl_measures=("total revenue",),
        nl_levels=("customer nation", "supplier nation", "year"),
        nl_filters=("for customers in asia", "and suppliers in asia"),
        nl_time="from 1992 to 1997",
    ),
    Intent(
        "ssb_q3_2",
        "SELECT c_city, s_city, d_year, SUM(lo_revenue) AS revenue FROM lineorder "
        "JOIN dates ON lineorder.lo_orderdate = dates.d_key "
        "JOIN customer ON lineorder.lo_custkey = customer.c_key "
        "JOIN supplier ON lineorder.lo_suppkey = supplier.s_key "
        "WHERE c_nation = 'ASIA_NATION_0' AND d_year BETWEEN 1992 AND 1997 "
        "GROUP BY c_city, s_city, d_year",
        nl_measures=("total revenue",),
        nl_levels=("customer city", "supplier city", "year"),
        nl_filters=("for nation asia_nation_0",),
        nl_time="from 1992 to 1997",
    ),
    Intent(
        "ssb_q4_1",
        "SELECT d_year, c_nation, SUM(lo_revenue - lo_supplycost) AS profit FROM lineorder "
        "JOIN dates ON lineorder.lo_orderdate = dates.d_key "
        "JOIN customer ON lineorder.lo_custkey = customer.c_key "
        "JOIN supplier ON lineorder.lo_suppkey = supplier.s_key "
        "WHERE c_region = 'AMERICA' AND s_region = 'AMERICA' "
        "GROUP BY d_year, c_nation",
        nl_measures=("total profit",),
        nl_levels=("year", "customer nation"),
        nl_filters=("for customers in america", "and suppliers in america"),
    ),
    Intent(
        "ssb_q4_2",
        "SELECT d_year, s_nation, SUM(lo_revenue - lo_supplycost) AS profit FROM lineorder "
        "JOIN dates ON lineorder.lo_orderdate = dates.d_key "
        "JOIN supplier ON lineorder.lo_suppkey = supplier.s_key "
        "WHERE s_region = 'EUROPE' AND d_year BETWEEN 1997 AND 1998 "
        "GROUP BY d_year, s_nation",
        nl_measures=("total profit",),
        nl_levels=("year", "supplier nation"),
        nl_filters=("from suppliers in europe",),
        nl_time="from 1997 to 1998",
    ),
    Intent(
        "ssb_q5_count",
        "SELECT d_year, COUNT(*) AS n_orders FROM lineorder "
        "JOIN dates ON lineorder.lo_orderdate = dates.d_key "
        "GROUP BY d_year",
        nl_measures=("number of orders",),
        nl_levels=("year",),
    ),
    Intent(
        "ssb_q6_avg",
        "SELECT c_region, AVG(lo_quantity) AS avg_qty FROM lineorder "
        "JOIN customer ON lineorder.lo_custkey = customer.c_key "
        "JOIN dates ON lineorder.lo_orderdate = dates.d_key "
        "WHERE d_year = 1995 GROUP BY c_region",
        nl_measures=("average quantity",),
        nl_levels=("customer region",),
        nl_time="in 1995",
    ),
    Intent(
        "ssb_q7_monthly",
        "SELECT d_yearmonth, SUM(lo_revenue) AS revenue FROM lineorder "
        "JOIN dates ON lineorder.lo_orderdate = dates.d_key "
        "WHERE d_year = 1996 GROUP BY d_yearmonth",
        nl_measures=("total revenue",),
        nl_levels=("month",),
        nl_time="in 1996",
    ),
]


def build(n_fact: int = 120_000, seed: int = 0) -> Workload:
    schema = build_schema()
    return Workload(
        name="ssb",
        schema=schema,
        dataset=build_dataset(schema, n_fact=n_fact, seed=seed),
        intents=list(_INTENTS),
        vocab=build_vocab(),
        spatial_ambiguous=(
            ("region", ("customer.c_region", "supplier.s_region")),
            ("city", ("customer.c_city", "supplier.s_city")),
        ),
    )
