"""Star Schema Benchmark data at the sizes of SSB revision 3 (O'Neil,
O'Neil, Chen and Revilla, "The Star Schema Benchmark", 2009, section 2).

A frozen copy, with changes, of the port's SSB generator
(``src/repro_torch/workloads/ssb.py``: ``build_schema`` and
``build_dataset``).  Kept here so that later changes to the port's
workloads cannot move the benchmark.  What was changed:

* sizes: per scale factor SF, LINEORDER 6,000,000 x SF rows, CUSTOMER
  30,000 x SF, SUPPLIER 2,000 x SF, PART 200,000 x floor(1 + log2 SF),
  1,000 brands (40 per category), 250 cities (10 per nation), dates
  1992-01-01 to 1998-12-31 (the source had 3,000 customers, 1,000
  suppliers, 1,200 parts and 200 brands);
* names: the 25 nations and 5 regions of TPC-H, cities as the first nine
  letters of the nation and a digit, brands as the category and 1 to 40
  (MFGR#111 to MFGR#5540; the
  source had synthetic nation and brand names);
* values as SSB's generator derives them: order dates over TPC-H's
  1992-01-01 to 1998-08-02, lo_extendedprice = lo_quantity x the part's
  retail price (TPC-H's formula), lo_revenue = lo_extendedprice x (100 -
  lo_discount) / 100 and lo_supplycost = 6 / 10 of the retail price, in
  cents (the source drew prices and costs independently);
* columns are made in their physical form (dictionary codes over a sorted
  vocabulary, dates as days since 1970-01-01) in bulk with numpy, so that
  60 million rows take seconds; the source converted strings row by row;
* every table has all of SSB's columns (``SSB_COLUMNS``), the source only
  those that SSB's 13 queries read: the others are drawn from a stream of
  their own (``_rest``), so that the queried columns are the same for a
  seed with or without them.  The date table keeps the port's two
  columns that SSB has not (``d_quarter``, and ``d_date`` as a date where
  SSB's D_DATE is its text), and LINEORDER the port's ``lo_date``.

The schema is the port's SSB schema with SSB's other columns added.
``generate`` returns plain numpy arrays (:class:`SSBData`), which the
reference reads; ``port_dataset`` wraps the same arrays in the port's
public classes.
"""
from __future__ import annotations

import dataclasses
import datetime as _dt
import itertools
import math

import numpy as np

REGIONS = ("AFRICA", "AMERICA", "ASIA", "EUROPE", "MIDDLE EAST")
# TPC-H's 25 nations with their regions (TPC-H 2.17, section 4.2.3)
NATIONS = (
    ("ALGERIA", "AFRICA"), ("ARGENTINA", "AMERICA"), ("BRAZIL", "AMERICA"),
    ("CANADA", "AMERICA"), ("EGYPT", "MIDDLE EAST"), ("ETHIOPIA", "AFRICA"),
    ("FRANCE", "EUROPE"), ("GERMANY", "EUROPE"), ("INDIA", "ASIA"),
    ("INDONESIA", "ASIA"), ("IRAN", "MIDDLE EAST"), ("IRAQ", "MIDDLE EAST"),
    ("JAPAN", "ASIA"), ("JORDAN", "MIDDLE EAST"), ("KENYA", "AFRICA"),
    ("MOROCCO", "AFRICA"), ("MOZAMBIQUE", "AFRICA"), ("PERU", "AMERICA"),
    ("CHINA", "ASIA"), ("ROMANIA", "EUROPE"), ("SAUDI ARABIA", "MIDDLE EAST"),
    ("VIETNAM", "ASIA"), ("RUSSIA", "EUROPE"), ("UNITED KINGDOM", "EUROPE"),
    ("UNITED STATES", "AMERICA"),
)
# SSB rev. 3, section 2: every column of each table, as the port names it
# (D_DATEKEY is d_key, P_BRAND1 p_brand, C_CUSTKEY c_key, and so on)
SSB_COLUMNS = {
    "lineorder": ("lo_orderkey", "lo_linenumber", "lo_custkey", "lo_partkey", "lo_suppkey",
                  "lo_orderdate", "lo_orderpriority", "lo_shippriority", "lo_quantity",
                  "lo_extendedprice", "lo_ordtotalprice", "lo_discount", "lo_revenue",
                  "lo_supplycost", "lo_tax", "lo_commitdate", "lo_shipmode"),
    "customer": ("c_key", "c_name", "c_address", "c_city", "c_nation", "c_region",
                 "c_phone", "c_mktsegment"),
    "supplier": ("s_key", "s_name", "s_address", "s_city", "s_nation", "s_region",
                 "s_phone"),
    "part": ("p_key", "p_name", "p_mfgr", "p_category", "p_brand", "p_color", "p_type",
             "p_size", "p_container"),
    "dates": ("d_key", "d_date", "d_dayofweek", "d_month", "d_year", "d_yearmonthnum",
              "d_yearmonth", "d_daynuminweek", "d_daynuminmonth", "d_daynuminyear",
              "d_monthnuminyear", "d_weeknuminyear", "d_sellingseason", "d_lastdayinweekfl",
              "d_lastdayinmonthfl", "d_holidayfl", "d_weekdayfl"),
}
# TPC-H's 92 colour words (TPC-H 2.17, section 4.2.3), of which SSB's
# P_NAME takes two and P_COLOR one
COLORS = tuple("""almond antique aquamarine azure beige bisque black blanched blue blush
brown burlywood burnished chartreuse chiffon chocolate coral cornflower cornsilk cream cyan
dark deep dim dodger drab firebrick floral forest frosted gainsboro ghost goldenrod green
grey honeydew hot indian ivory khaki lace lavender lawn lemon light lime linen magenta
maroon medium metallic midnight mint misty moccasin navajo navy olive orange orchid pale
papaya peach peru pink plum powder puff purple red rose rosy royal saddle salmon sandy
seashell sienna sky slate smoke snow spring steel tan thistle tomato turquoise violet
wheat white yellow""".split())
TYPES = (("STANDARD", "SMALL", "MEDIUM", "LARGE", "ECONOMY", "PROMO"),
         ("ANODIZED", "BURNISHED", "PLATED", "POLISHED", "BRUSHED"),
         ("TIN", "NICKEL", "BRASS", "STEEL", "COPPER"))
CONTAINERS = (("SM", "LG", "MED", "JUMBO", "WRAP"),
              ("CASE", "BOX", "BAG", "JAR", "PKG", "PACK", "CAN", "DRUM"))
SEGMENTS = ("AUTOMOBILE", "BUILDING", "FURNITURE", "HOUSEHOLD", "MACHINERY")
PRIORITIES = ("1-URGENT", "2-HIGH", "3-MEDIUM", "4-NOT SPECI", "5-LOW")
SHIPMODES = ("AIR", "FOB", "MAIL", "RAIL", "REG AIR", "SHIP", "TRUCK")
DAYS = ("Monday", "Tuesday", "Wednesday", "Thursday", "Friday", "Saturday", "Sunday")
MONTH_NAMES = ("January", "February", "March", "April", "May", "June", "July", "August",
               "September", "October", "November", "December")
# D_SELLINGSEASON by month, and the days that D_HOLIDAYFL marks (month, day)
SEASONS = ("Winter", "Winter", "Spring", "Spring", "Summer", "Summer", "Summer", "Summer",
           "Fall", "Fall", "Christmas", "Christmas")
HOLIDAYS = ((1, 1), (7, 4), (11, 11), (12, 24), (12, 25), (12, 31))
ALNUM = np.frombuffer(b"0123456789ABCDEFGHIJKLMNOPQRSTUVWXYZabcdefghijklmnopqrstuvwxyz",
                      np.uint8)
MONTHS = ("Jan", "Feb", "Mar", "Apr", "May", "Jun",
          "Jul", "Aug", "Sep", "Oct", "Nov", "Dec")
FIRST_DAY = _dt.date(1992, 1, 1)
LAST_DAY = _dt.date(1998, 12, 31)
LAST_ORDER = _dt.date(1998, 8, 2)  # TPC-H: ENDDATE - 151 days
EPOCH = _dt.date(1970, 1, 1)
YEARS = tuple(range(1992, 1999))


def table_sizes(sf: int) -> dict[str, int]:
    """Rows per table at scale factor ``sf`` (SSB rev. 3, section 2)."""
    return {
        "lineorder": 6_000_000 * sf,
        "customer": 30_000 * sf,
        "supplier": 2_000 * sf,
        "part": 200_000 * int(math.floor(1 + math.log2(sf))),
        "dates": (LAST_DAY - FIRST_DAY).days + 1,
    }


def city_name(nation: str, i: int) -> str:
    """SSB's city: the nation's name cut or padded to nine letters, then a
    digit."""
    return f"{nation[:9]:<9}{i}"


def categories() -> list[str]:
    return [f"MFGR#{m}{c}" for m in range(1, 6) for c in range(1, 6)]


def brands() -> list[str]:
    return [f"{cat}{b}" for cat in categories() for b in range(1, 41)]


@dataclasses.dataclass
class Column:
    """One column in its physical form: ``data`` holds numbers, dictionary
    codes into the sorted ``vocab`` (``kind`` "str") or days since
    1970-01-01 (``kind`` "date")."""

    kind: str  # 'int' | 'float' | 'str' | 'date'
    data: np.ndarray
    vocab: np.ndarray | None = None

    def decode(self, physical: np.ndarray) -> np.ndarray:
        if self.kind == "str":
            return self.vocab[physical]
        return physical


@dataclasses.dataclass
class SSBData:
    sf: int
    tables: dict[str, dict[str, Column]]  # table -> column -> Column
    fk: dict[str, str]  # dimension -> the LINEORDER column that joins it

    def rows(self, table: str) -> int:
        return len(next(iter(self.tables[table].values())).data)


def _encode(values: list[str], picks: np.ndarray) -> Column:
    """Dictionary-encode ``values[picks]`` over a sorted vocabulary."""
    vocab = np.asarray(sorted(set(values)))
    codes = np.searchsorted(vocab, np.asarray(values)).astype(np.int32)
    return Column("str", codes[picks], vocab)


def _dates() -> dict[str, Column]:
    days = [FIRST_DAY + _dt.timedelta(days=i) for i in range((LAST_DAY - FIRST_DAY).days + 1)]
    idx = np.arange(len(days))
    return {
        "d_key": Column("int", idx.astype(np.int32)),
        "d_date": Column("date", np.asarray([(d - EPOCH).days for d in days], np.int32)),
        "d_yearmonth": _encode([f"{MONTHS[d.month - 1]}{d.year}" for d in days], idx),
        "d_quarter": _encode([f"{d.year}Q{(d.month - 1) // 3 + 1}" for d in days], idx),
        "d_year": Column("int", np.asarray([d.year for d in days], np.int32)),
        "d_yearmonthnum": Column("int", np.asarray([d.year * 100 + d.month for d in days],
                                                   np.int32)),
        "d_weeknuminyear": Column("int", np.asarray([d.isocalendar()[1] for d in days],
                                                    np.int32)),
    }


def _geo(prefix: str, n: int, rng: np.random.Generator) -> dict[str, Column]:
    cities = [(city_name(nat, i), nat, reg) for nat, reg in NATIONS for i in range(10)]
    pick = rng.integers(0, len(cities), size=n)
    return {
        f"{prefix}_key": Column("int", np.arange(n, dtype=np.int32)),
        f"{prefix}_city": _encode([c for c, _, _ in cities], pick),
        f"{prefix}_nation": _encode([nat for _, nat, _ in cities], pick),
        f"{prefix}_region": _encode([reg for _, _, reg in cities], pick),
    }


def retail_cents(partkey: np.ndarray) -> np.ndarray:
    """TPC-H's P_RETAILPRICE in cents for 1-based part keys:
    90000 + ((key / 10) mod 20001) + 100 (key mod 1000)."""
    k = partkey.astype(np.int64)
    return 90_000 + (k // 10) % 20_001 + 100 * (k % 1000)


def generate(sf: int, seed: int, sizes: dict[str, int] | None = None) -> SSBData:
    """SSB at scale factor ``sf`` from ``seed``: the same seed gives the same
    arrays.  ``sizes`` replaces the row counts of ``table_sizes(sf)`` (the
    tests' small copies)."""
    sizes = {**table_sizes(sf), **(sizes or {})}
    rng = np.random.default_rng(seed)
    dates = _dates()
    customer = _geo("c", sizes["customer"], rng)
    supplier = _geo("s", sizes["supplier"], rng)
    brs = brands()
    bpick = rng.integers(0, len(brs), size=sizes["part"])
    part = {
        "p_key": Column("int", np.arange(sizes["part"], dtype=np.int32)),
        "p_brand": _encode(brs, bpick),
        "p_category": _encode([b[:7] for b in brs], bpick),
        "p_mfgr": _encode([b[:6] for b in brs], bpick),
    }
    n = sizes["lineorder"]
    n_order_days = (LAST_ORDER - FIRST_DAY).days + 1
    orderdate = rng.integers(0, n_order_days, size=n, dtype=np.int32)
    partkey = rng.integers(0, sizes["part"], size=n, dtype=np.int32)
    quantity = rng.integers(1, 51, size=n, dtype=np.int32)
    discount = rng.integers(0, 11, size=n, dtype=np.int32)
    retail = retail_cents(partkey + 1)
    ext_cents = quantity.astype(np.int64) * retail
    lineorder = {
        "lo_orderdate": Column("int", orderdate),
        "lo_custkey": Column("int", rng.integers(0, sizes["customer"], size=n,
                                                 dtype=np.int32)),
        "lo_suppkey": Column("int", rng.integers(0, sizes["supplier"], size=n,
                                                 dtype=np.int32)),
        "lo_partkey": Column("int", partkey),
        "lo_quantity": Column("int", quantity),
        "lo_extendedprice": Column("float", ext_cents / 100.0),
        "lo_discount": Column("int", discount),
        # integer cents, rounded half up, then to currency
        "lo_revenue": Column("float", ((ext_cents * (100 - discount) + 50) // 100) / 100.0),
        "lo_supplycost": Column("float", ((6 * retail + 5) // 10) / 100.0),
        "lo_date": Column("date", dates["d_date"].data[orderdate]),
    }
    tables = {"lineorder": lineorder, "dates": dates, "customer": customer,
              "supplier": supplier, "part": part}
    _rest(tables, np.random.default_rng([seed, 1]))
    return SSBData(sf, tables, {"dates": "lo_orderdate", "customer": "lo_custkey",
                                "supplier": "lo_suppkey", "part": "lo_partkey"})


# ------------------------------------------- the columns no SSB query reads

def _strings(strings: np.ndarray) -> Column:
    """Dictionary-encode an array of strings over its sorted vocabulary."""
    vocab, codes = np.unique(strings, return_inverse=True)
    return Column("str", codes.astype(np.int32), vocab)


def _vstrings(rng: np.random.Generator, n: int, lo: int, hi: int) -> np.ndarray:
    """``n`` random alphanumeric strings of ``lo`` to ``hi`` characters."""
    chars = ALNUM[rng.integers(0, len(ALNUM), size=(n, hi))]
    chars[np.arange(hi) >= rng.integers(lo, hi + 1, size=n)[:, None]] = 0
    return np.ascontiguousarray(chars).view(f"S{hi}").ravel().astype(f"U{hi}")


def _digits(rng: np.random.Generator, n: int, lo: int, hi: int) -> np.ndarray:
    return rng.integers(lo, hi + 1, size=n).astype("U4")


def _named(prefix: str, n: int) -> np.ndarray:
    return np.char.add(prefix, np.char.zfill(np.arange(1, n + 1).astype("U9"), 9))


def _people(cols: dict[str, Column], p: str, who: str, rng: np.random.Generator) -> None:
    """Name, address and phone of a customer or supplier, as TPC-H's
    generator makes them: ``Customer#000000001``, an address of 10 to 25
    characters, a phone whose country code is the nation's key plus 10."""
    n = len(cols[f"{p}_key"].data)
    nation = cols[f"{p}_nation"]
    key_of = np.asarray([[nat for nat, _ in NATIONS].index(v) for v in nation.vocab])
    code = (key_of[nation.data] + 10).astype("U2")
    phone = code
    for lo, hi in ((100, 999), (100, 999), (1000, 9999)):
        phone = np.char.add(np.char.add(phone, "-"), _digits(rng, n, lo, hi))
    cols[f"{p}_name"] = Column("str", np.arange(n, dtype=np.int32), _named(who, n))
    cols[f"{p}_address"] = _strings(_vstrings(rng, n, 10, 25))
    cols[f"{p}_phone"] = _strings(phone)


def _rest(tables: dict[str, dict[str, Column]], rng: np.random.Generator) -> None:
    """Add to ``tables`` SSB's columns that none of its queries reads, drawn
    from ``rng`` alone."""
    lo = tables["lineorder"]
    n = len(lo["lo_orderdate"].data)
    # 1 to 7 lines an order, numbered from 1, orders numbered from 1
    lines = rng.integers(1, 8, size=n // 4 + 8)
    while lines.sum() < n:
        lines = np.concatenate([lines, rng.integers(1, 8, size=n // 40 + 8)])
    ends = np.cumsum(lines)
    m = int(np.searchsorted(ends, n)) + 1
    order = np.repeat(np.arange(m, dtype=np.int32), lines[:m])[:n]
    first = (ends[:m] - lines[:m])[order]
    tax = rng.integers(0, 9, size=n, dtype=np.int32)
    # TPC-H's O_TOTALPRICE: the order's lines at their price, taxed and discounted
    line_cents = (np.rint(lo["lo_extendedprice"].data * 100) * (100 + tax)
                  * (100 - lo["lo_discount"].data) / 1e4)
    total = np.rint(np.bincount(order, weights=line_cents, minlength=m)) / 100.0
    lo["lo_orderkey"] = Column("int", order + 1)
    lo["lo_linenumber"] = Column("int", (np.arange(n) - first + 1).astype(np.int32))
    lo["lo_orderpriority"] = Column("str", rng.integers(0, len(PRIORITIES), size=n,
                                                        dtype=np.int32), np.asarray(PRIORITIES))
    lo["lo_shippriority"] = Column("str", np.zeros(n, np.int32), np.asarray(["0"]))
    lo["lo_ordtotalprice"] = Column("float", total[order])
    lo["lo_tax"] = Column("int", tax)
    lo["lo_commitdate"] = Column("int", lo["lo_orderdate"].data
                                 + rng.integers(30, 91, size=n, dtype=np.int32))
    lo["lo_shipmode"] = Column("str", rng.integers(0, len(SHIPMODES), size=n,
                                                   dtype=np.int32), np.asarray(SHIPMODES))

    _people(tables["customer"], "c", "Customer#", rng)
    cust = tables["customer"]
    cust["c_mktsegment"] = _encode(list(SEGMENTS),
                                   rng.integers(0, len(SEGMENTS), size=len(cust["c_key"].data)))
    _people(tables["supplier"], "s", "Supplier#", rng)

    part = tables["part"]
    k = len(part["p_key"].data)
    colors = np.asarray(COLORS)
    first_word = rng.integers(0, len(COLORS), size=k)
    second_word = (first_word + rng.integers(1, len(COLORS), size=k)) % len(COLORS)
    part["p_name"] = _strings(np.char.add(np.char.add(colors[first_word], " "),
                                          colors[second_word]))
    part["p_color"] = _encode(list(COLORS), rng.integers(0, len(COLORS), size=k))
    types = [" ".join(t) for t in itertools.product(*TYPES)]
    part["p_type"] = _encode(types, rng.integers(0, len(types), size=k))
    part["p_size"] = Column("int", rng.integers(1, 51, size=k, dtype=np.int32))
    containers = [" ".join(c) for c in itertools.product(*CONTAINERS)]
    part["p_container"] = _encode(containers, rng.integers(0, len(containers), size=k))

    dates = tables["dates"]
    days = [FIRST_DAY + _dt.timedelta(days=i) for i in range(len(dates["d_key"].data))]
    idx = np.arange(len(days))

    def ints(xs):
        return Column("int", np.asarray(xs, np.int32))

    dates["d_dayofweek"] = _encode([DAYS[d.weekday()] for d in days], idx)
    dates["d_month"] = _encode([MONTH_NAMES[d.month - 1] for d in days], idx)
    dates["d_daynuminweek"] = ints([d.isoweekday() for d in days])
    dates["d_daynuminmonth"] = ints([d.day for d in days])
    dates["d_daynuminyear"] = ints([d.timetuple().tm_yday for d in days])
    dates["d_monthnuminyear"] = ints([d.month for d in days])
    dates["d_sellingseason"] = _encode([SEASONS[d.month - 1] for d in days], idx)
    dates["d_lastdayinweekfl"] = ints([d.isoweekday() == 7 for d in days])
    dates["d_lastdayinmonthfl"] = ints([(d + _dt.timedelta(days=1)).day == 1 for d in days])
    dates["d_holidayfl"] = ints([(d.month, d.day) in HOLIDAYS for d in days])
    dates["d_weekdayfl"] = ints([d.isoweekday() <= 5 for d in days])


# --------------------------------------------------------- the port's side

# kinds of the columns that ``_rest`` adds, per table
REST_KINDS = {
    "lineorder": (("lo_orderkey", "int"), ("lo_linenumber", "int"),
                  ("lo_orderpriority", "str"), ("lo_shippriority", "str"),
                  ("lo_ordtotalprice", "float"), ("lo_tax", "int"), ("lo_commitdate", "int"),
                  ("lo_shipmode", "str")),
    "customer": (("c_name", "str"), ("c_address", "str"), ("c_phone", "str"),
                 ("c_mktsegment", "str")),
    "supplier": (("s_name", "str"), ("s_address", "str"), ("s_phone", "str")),
    "part": (("p_name", "str"), ("p_color", "str"), ("p_type", "str"), ("p_size", "int"),
             ("p_container", "str")),
    "dates": (("d_dayofweek", "str"), ("d_month", "str"), ("d_daynuminweek", "int"),
              ("d_daynuminmonth", "int"), ("d_daynuminyear", "int"),
              ("d_monthnuminyear", "int"), ("d_sellingseason", "str"),
              ("d_lastdayinweekfl", "int"), ("d_lastdayinmonthfl", "int"),
              ("d_holidayfl", "int"), ("d_weekdayfl", "int")),
}


def port_schema():
    """The port's ``StarSchema`` of SSB (as ``repro_torch.workloads.ssb``
    declares it) with SSB's other columns added, built through the port's
    public classes."""
    from repro_torch.core.schema import Column as C, Dimension, FactTable, Hierarchy, StarSchema

    def rest(table):
        return tuple(C(name, kind) for name, kind in REST_KINDS[table])

    dates = Dimension(
        name="dates", fact_fk="lo_orderdate", pk="d_key",
        columns=(C("d_key", "int"), C("d_date", "date"), C("d_yearmonth", "str"),
                 C("d_quarter", "str"), C("d_year", "int"), C("d_yearmonthnum", "int"),
                 C("d_weeknuminyear", "int")) + rest("dates"),
        hierarchies=(Hierarchy("time", ("d_date", "d_yearmonth", "d_quarter", "d_year")),),
        time_kinds=(("d_date", "date"), ("d_year", "year"),
                    ("d_yearmonthnum", "yearmonthnum"), ("d_yearmonth", "yearmonth_str"),
                    ("d_quarter", "yearquarter_str")))

    def geo(name, p, fk):
        return Dimension(
            name=name, fact_fk=fk, pk=f"{p}_key",
            columns=(C(f"{p}_key", "int"), C(f"{p}_city", "str"),
                     C(f"{p}_nation", "str"), C(f"{p}_region", "str")) + rest(name),
            hierarchies=(Hierarchy("geo", (f"{p}_city", f"{p}_nation", f"{p}_region")),))

    part = Dimension(
        name="part", fact_fk="lo_partkey", pk="p_key",
        columns=(C("p_key", "int"), C("p_brand", "str"), C("p_category", "str"),
                 C("p_mfgr", "str")) + rest("part"),
        hierarchies=(Hierarchy("prod", ("p_brand", "p_category", "p_mfgr")),))
    fact = FactTable(
        name="lineorder",
        columns=(C("lo_orderdate", "int"), C("lo_custkey", "int"), C("lo_suppkey", "int"),
                 C("lo_partkey", "int"), C("lo_quantity", "int"),
                 C("lo_extendedprice", "float"), C("lo_discount", "int"),
                 C("lo_revenue", "float"), C("lo_supplycost", "float"), C("lo_date", "date"))
        + rest("lineorder"),
        date_column="lo_date")
    schema = StarSchema("ssb", fact, (dates, geo("customer", "c", "lo_custkey"),
                                      geo("supplier", "s", "lo_suppkey"), part),
                        time_dimension="dates")
    schema.validate()
    return schema


def port_dataset(data: SSBData):
    """The port's ``Dataset`` over ``data``'s arrays (shared, not copied)."""
    from repro_torch.olap.columnar import ColumnData, Dataset, TableData

    def table(name):
        return TableData(name, {c: ColumnData(col.kind, col.data, col.vocab)
                                for c, col in data.tables[name].items()})

    schema = port_schema()
    return Dataset(schema, table("lineorder"),
                   {d.name: table(d.name) for d in schema.dimensions})
