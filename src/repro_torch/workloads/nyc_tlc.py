"""NYC TLC trip-record workload (18 canonical intents, §5.1).

Dashboard-oriented star schema over taxi trips.  Role-playing zone joins
(pickup vs dropoff) are declared as *separate* dimensions with distinct fact
FKs, which keeps join paths unique (§3.3); the paper's dimension-ambiguity
adversarial cases ('area' -> zone vs borough) come from this schema's vocab.
"""
from __future__ import annotations

import datetime as _dt

import numpy as np

from ..core.nl_canon import MeasureSense, NLVocab
from ..core.schema import Column, Dimension, FactTable, Hierarchy, StarSchema
from ..olap.columnar import ColumnData, Dataset, TableData
from .base import Intent, Workload

BOROUGHS = ["Manhattan", "Brooklyn", "Queens", "Bronx", "Staten Island", "EWR"]
PAYMENTS = ["Credit card", "Cash", "No charge", "Dispute", "Unknown"]


def build_schema() -> StarSchema:
    dates = Dimension(
        name="dates", fact_fk="pickup_date_key", pk="d_key",
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
    zones_pu = Dimension(
        name="zones_pu", fact_fk="pu_zone_key", pk="zpu_key",
        columns=(
            Column("zpu_key", "int"), Column("pu_zone", "str"), Column("pu_borough", "str"),
        ),
        hierarchies=(Hierarchy("geo", ("pu_zone", "pu_borough")),),
    )
    zones_do = Dimension(
        name="zones_do", fact_fk="do_zone_key", pk="zdo_key",
        columns=(
            Column("zdo_key", "int"), Column("do_zone", "str"), Column("do_borough", "str"),
        ),
        hierarchies=(Hierarchy("geo", ("do_zone", "do_borough")),),
    )
    payment = Dimension(
        name="payment", fact_fk="payment_key", pk="pay_key",
        columns=(Column("pay_key", "int"), Column("payment_type", "str")),
    )
    fact = FactTable(
        name="trips",
        columns=(
            Column("pickup_date_key", "int"), Column("pu_zone_key", "int"),
            Column("do_zone_key", "int"), Column("payment_key", "int"),
            Column("fare_amount", "float"), Column("tip_amount", "float"),
            Column("total_amount", "float"), Column("trip_distance", "float"),
            Column("passenger_count", "int"), Column("trip_date", "date"),
        ),
        date_column="trip_date",
    )
    sch = StarSchema("nyc_tlc", fact, (dates, zones_pu, zones_do, payment),
                     time_dimension="dates")
    sch.validate()
    return sch


def build_dataset(schema: StarSchema, n_fact: int = 150_000, seed: int = 1) -> Dataset:
    rng = np.random.default_rng(seed)
    start = _dt.date(2023, 1, 1)
    days = (_dt.date(2024, 12, 31) - start).days + 1
    all_dates = [start + _dt.timedelta(days=i) for i in range(days)]
    mon = ["Jan", "Feb", "Mar", "Apr", "May", "Jun",
           "Jul", "Aug", "Sep", "Oct", "Nov", "Dec"]
    dates = TableData("dates", {
        "d_key": ColumnData("int", np.arange(days)),
        "d_date": ColumnData("date", np.asarray([d.isoformat() for d in all_dates])),
        "d_yearmonth": ColumnData("str", np.asarray(
            [f"{mon[d.month - 1]}{d.year}" for d in all_dates])),
        "d_quarter": ColumnData("str", np.asarray(
            [f"{d.year}Q{(d.month - 1) // 3 + 1}" for d in all_dates])),
        "d_year": ColumnData("int", np.asarray([d.year for d in all_dates])),
    })
    zones = [f"{b.replace(' ', '')}_Zone_{i:03d}" for b in BOROUGHS for i in range(12)]
    zone_borough = {z: BOROUGHS[i // 12] for i, z in enumerate(zones)}

    def zone_table(name: str, prefix: str) -> TableData:
        return TableData(name, {
            f"z{prefix}_key": ColumnData("int", np.arange(len(zones))),
            f"{prefix}_zone": ColumnData("str", np.asarray(zones)),
            f"{prefix}_borough": ColumnData("str", np.asarray(
                [zone_borough[z] for z in zones])),
        })

    payment = TableData("payment", {
        "pay_key": ColumnData("int", np.arange(len(PAYMENTS))),
        "payment_type": ColumnData("str", np.asarray(PAYMENTS)),
    })
    dk = rng.integers(0, days, size=n_fact)
    dist = np.round(rng.gamma(2.0, 1.8, size=n_fact), 2)
    fare = np.round(3.0 + dist * 2.6 + rng.normal(0, 2, size=n_fact).clip(-2, 8), 2)
    tip = np.round(np.where(rng.random(n_fact) < 0.65, fare * rng.uniform(0, 0.3, n_fact), 0), 2)
    fact = TableData("trips", {
        "pickup_date_key": ColumnData("int", dk),
        "pu_zone_key": ColumnData("int", rng.integers(0, len(zones), size=n_fact)),
        "do_zone_key": ColumnData("int", rng.integers(0, len(zones), size=n_fact)),
        "payment_key": ColumnData("int", rng.choice(
            len(PAYMENTS), size=n_fact, p=[0.62, 0.30, 0.03, 0.02, 0.03])),
        "fare_amount": ColumnData("float", fare),
        "tip_amount": ColumnData("float", tip),
        "total_amount": ColumnData("float", np.round(fare + tip + 1.75, 2)),
        "trip_distance": ColumnData("float", dist),
        "passenger_count": ColumnData("int", rng.integers(1, 7, size=n_fact)),
        "trip_date": ColumnData("date", dates.columns["d_date"].data[dk].copy()),
    })
    return Dataset(schema, fact, {
        "dates": dates, "zones_pu": zone_table("zones_pu", "pu"),
        "zones_do": zone_table("zones_do", "do"), "payment": payment,
    })


def build_vocab() -> NLVocab:
    return NLVocab(
        schema="nyc_tlc",
        measures={
            "earnings": (MeasureSense("trips.total_amount", "SUM"),),
            "fare": (MeasureSense("trips.fare_amount", "SUM"),),
            "tip": (MeasureSense("trips.tip_amount", "SUM"),),
            "trips": (MeasureSense("*", "COUNT"),),
            "rides": (MeasureSense("*", "COUNT"),),
            "distance": (MeasureSense("trips.trip_distance", "SUM"),),
            "passengers": (MeasureSense("trips.passenger_count", "SUM"),),
            # adversarial: 'revenue' is net-vs-gross ambiguous on this schema
            "revenue": (
                MeasureSense("trips.total_amount", "SUM"),
                MeasureSense("trips.fare_amount", "SUM"),
            ),
        },
        levels={
            "year": ("dates.d_year",),
            "quarter": ("dates.d_quarter",),
            "month": ("dates.d_yearmonth",),
            "pickup borough": ("zones_pu.pu_borough",),
            "dropoff borough": ("zones_do.do_borough",),
            "pickup zone": ("zones_pu.pu_zone",),
            "dropoff zone": ("zones_do.do_zone",),
            "payment type": ("payment.payment_type",),
            # adversarial dimension ambiguity
            "borough": ("zones_pu.pu_borough", "zones_do.do_borough"),
            "zone": ("zones_pu.pu_zone", "zones_do.do_zone"),
            "area": ("zones_pu.pu_zone", "zones_pu.pu_borough"),
        },
        values={
            **{f"picked up in {b.lower()}": (("zones_pu.pu_borough", b),) for b in BOROUGHS},
            **{f"dropped off in {b.lower()}": (("zones_do.do_borough", b),) for b in BOROUGHS},
            "paid by credit card": (("payment.payment_type", "Credit card"),),
            "paid in cash": (("payment.payment_type", "Cash"),),
            # bare borough names: pickup-vs-dropoff ambiguous (adversarial)
            **{b.lower(): (("zones_pu.pu_borough", b), ("zones_do.do_borough", b))
               for b in BOROUGHS},
        },
        numeric_cols={
            "distance": "trips.trip_distance",
            "passenger count": "trips.passenger_count",
        },
        agg_ambiguous_nouns=("trips", "rides", "passengers"),
    )


_J = "JOIN dates ON trips.pickup_date_key = dates.d_key "
_JPU = "JOIN zones_pu ON trips.pu_zone_key = zones_pu.zpu_key "
_JDO = "JOIN zones_do ON trips.do_zone_key = zones_do.zdo_key "
_JPAY = "JOIN payment ON trips.payment_key = payment.pay_key "

_INTENTS = [
    Intent(
        "tlc_01",
        f"SELECT pu_borough, SUM(total_amount) AS earnings FROM trips {_JPU}{_J}"
        "WHERE d_year = 2024 GROUP BY pu_borough",
        nl_measures=("total earnings",), nl_levels=("pickup borough",), nl_time="in 2024",
    ),
    Intent(
        "tlc_02",
        f"SELECT d_yearmonth, SUM(total_amount) AS earnings FROM trips {_J}"
        "WHERE d_year = 2024 GROUP BY d_yearmonth",
        nl_measures=("total earnings",), nl_levels=("month",), nl_time="in 2024",
    ),
    Intent(
        "tlc_03",
        f"SELECT payment_type, COUNT(*) AS n FROM trips {_JPAY}{_J}"
        "WHERE d_quarter = '2024Q1' GROUP BY payment_type",
        nl_measures=("number of trips",), nl_levels=("payment type",), nl_time="in q1 2024",
    ),
    Intent(
        "tlc_04",
        f"SELECT pu_zone, SUM(tip_amount) AS tips FROM trips {_JPU}{_J}"
        "WHERE d_yearmonth = 'Jun2024' GROUP BY pu_zone",
        nl_measures=("total tips",), nl_levels=("pickup zone",), nl_time="in june 2024",
    ),
    Intent(
        "tlc_05",
        f"SELECT d_year, AVG(fare_amount) AS avg_fare FROM trips {_J}"
        "GROUP BY d_year",
        nl_measures=("average fare",), nl_levels=("year",),
    ),
    Intent(
        "tlc_06",
        f"SELECT do_borough, COUNT(*) AS n FROM trips {_JDO}{_J}"
        "WHERE d_year = 2023 GROUP BY do_borough",
        nl_measures=("number of rides",), nl_levels=("dropoff borough",), nl_time="in 2023",
    ),
    Intent(
        "tlc_07",
        f"SELECT pu_borough, SUM(trip_distance) AS dist FROM trips {_JPU}{_J}"
        "WHERE d_year = 2024 GROUP BY pu_borough",
        nl_measures=("total distance",), nl_levels=("pickup borough",), nl_time="in 2024",
    ),
    Intent(
        "tlc_08",
        f"SELECT d_quarter, SUM(total_amount) AS earnings FROM trips {_J}{_JPU}"
        "WHERE pu_borough = 'Manhattan' GROUP BY d_quarter",
        nl_measures=("total earnings",), nl_levels=("quarter",),
        nl_filters=("picked up in manhattan",),
    ),
    Intent(
        "tlc_09",
        f"SELECT payment_type, SUM(tip_amount) AS tips FROM trips {_JPAY}{_J}"
        "WHERE d_year = 2024 GROUP BY payment_type",
        nl_measures=("total tips",), nl_levels=("payment type",), nl_time="in 2024",
    ),
    Intent(
        "tlc_10",
        f"SELECT pu_zone, SUM(total_amount) AS earnings FROM trips {_JPU}{_J}"
        "WHERE d_yearmonth = 'Jul2024' GROUP BY pu_zone "
        "ORDER BY SUM(total_amount) DESC LIMIT 10",
        nl_measures=("total earnings",), nl_levels=("pickup zone",),
        nl_time="in july 2024", nl_extra="top 10",
    ),
    Intent(
        "tlc_11",
        f"SELECT d_yearmonth, COUNT(*) AS n FROM trips {_J}{_JPU}"
        "WHERE pu_borough = 'Brooklyn' AND d_year = 2024 GROUP BY d_yearmonth",
        nl_measures=("number of trips",), nl_levels=("month",),
        nl_filters=("picked up in brooklyn",), nl_time="in 2024",
    ),
    Intent(
        "tlc_12",
        f"SELECT pu_borough, do_borough, COUNT(*) AS n FROM trips {_JPU}{_JDO}{_J}"
        "WHERE d_quarter = '2024Q2' GROUP BY pu_borough, do_borough",
        nl_measures=("number of trips",),
        nl_levels=("pickup borough", "dropoff borough"), nl_time="in q2 2024",
    ),
    Intent(
        "tlc_13",
        f"SELECT d_year, SUM(passenger_count) AS pax FROM trips {_J}"
        "GROUP BY d_year",
        nl_measures=("total passengers",), nl_levels=("year",),
    ),
    Intent(
        "tlc_14",
        f"SELECT pu_borough, AVG(trip_distance) AS avg_dist FROM trips {_JPU}{_J}"
        "WHERE d_year = 2024 GROUP BY pu_borough",
        nl_measures=("average distance",), nl_levels=("pickup borough",), nl_time="in 2024",
    ),
    Intent(
        "tlc_15",
        f"SELECT d_yearmonth, SUM(fare_amount) AS fares FROM trips {_J}{_JPAY}"
        "WHERE payment_type = 'Cash' AND d_year = 2024 GROUP BY d_yearmonth",
        nl_measures=("total fares",), nl_levels=("month",),
        nl_filters=("paid in cash",), nl_time="in 2024",
    ),
    Intent(
        "tlc_16",
        f"SELECT do_zone, SUM(total_amount) AS earnings FROM trips {_JDO}{_J}"
        "WHERE d_yearmonth = 'Dec2023' GROUP BY do_zone",
        nl_measures=("total earnings",), nl_levels=("dropoff zone",),
        nl_time="in december 2023",
    ),
    Intent(
        "tlc_17",
        f"SELECT d_quarter, COUNT(*) AS n FROM trips {_J}"
        "WHERE trip_distance > 10 GROUP BY d_quarter",
        nl_measures=("number of trips",), nl_levels=("quarter",),
        nl_filters=("with distance over 10",),
    ),
    Intent(
        "tlc_18",
        f"SELECT pu_borough, SUM(fare_amount) AS fares, SUM(tip_amount) AS tips "
        f"FROM trips {_JPU}{_J}"
        "WHERE d_year = 2024 GROUP BY pu_borough",
        nl_measures=("total fares", "total tips"), nl_levels=("pickup borough",),
        nl_time="in 2024",
    ),
]


def build(n_fact: int = 150_000, seed: int = 1) -> Workload:
    schema = build_schema()
    return Workload(
        name="nyc_tlc",
        schema=schema,
        dataset=build_dataset(schema, n_fact=n_fact, seed=seed),
        intents=list(_INTENTS),
        vocab=build_vocab(),
        spatial_ambiguous=(
            ("area", ("zones_pu.pu_zone", "zones_pu.pu_borough")),
            ("zone", ("zones_pu.pu_zone", "zones_do.do_zone")),
            ("borough", ("zones_pu.pu_borough", "zones_do.do_borough")),
        ),
    )


QUALIFIED_PHRASES = (
    "pickup zone", "dropoff zone", "pickup borough", "dropoff borough",
)
