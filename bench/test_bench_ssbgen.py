"""The frozen SSB generator: SSB rev. 3's sizes, its value derivations,
and the port's schema."""
import numpy as np
import pytest

from yardstick import ssbgen

SMALL = {"lineorder": 20_000, "customer": 3_000, "supplier": 500, "part": 4_000}


def test_sizes_at_sf1_are_ssb_rev3():
    assert ssbgen.table_sizes(1) == {"lineorder": 6_000_000, "customer": 30_000,
                                     "supplier": 2_000, "part": 200_000, "dates": 2_557}


def test_sizes_at_sf10_computed():
    s = ssbgen.table_sizes(10)
    assert (s["lineorder"], s["customer"], s["supplier"], s["part"]) == \
        (60_000_000, 300_000, 20_000, 800_000)


@pytest.fixture(scope="module")
def data():
    return ssbgen.generate(1, 2**33 + 7, sizes=SMALL)


def test_domains(data):
    cust, part = data.tables["customer"], data.tables["part"]
    assert len(cust["c_city"].vocab) == 250 and len(cust["c_nation"].vocab) == 25
    assert len(cust["c_region"].vocab) == 5
    assert len(ssbgen.brands()) == 1000 and len(set(b[:7] for b in ssbgen.brands())) == 25
    assert set(part["p_mfgr"].vocab) <= {f"MFGR#{i}" for i in range(1, 6)}
    d = data.tables["dates"]
    assert d["d_year"].data.min() == 1992 and d["d_year"].data.max() == 1998


@pytest.mark.parametrize("table,path", [
    ("customer", ("c_city", "c_nation", "c_region")),
    ("supplier", ("s_city", "s_nation", "s_region")),
    ("part", ("p_brand", "p_category", "p_mfgr")),
    ("dates", ("d_yearmonth", "d_quarter", "d_year")),
])
def test_hierarchies_are_functional(data, table, path):
    cols = data.tables[table]
    for fine, coarse in zip(path, path[1:]):
        pairs = set(zip(cols[fine].data.tolist(), cols[coarse].data.tolist()))
        assert len(pairs) == len({f for f, _ in pairs})


def test_values_derive_as_ssb(data):
    lo = data.tables["lineorder"]
    retail = ssbgen.retail_cents(lo["lo_partkey"].data + 1)
    np.testing.assert_array_equal(np.round(lo["lo_extendedprice"].data * 100),
                                  lo["lo_quantity"].data * retail)
    rev = np.round(lo["lo_revenue"].data * 100)
    want = (lo["lo_quantity"].data * retail * (100 - lo["lo_discount"].data) + 50) // 100
    np.testing.assert_array_equal(rev, want)
    np.testing.assert_array_equal(lo["lo_date"].data,
                                  data.tables["dates"]["d_date"].data[lo["lo_orderdate"].data])
    assert lo["lo_quantity"].data.min() >= 1 and lo["lo_quantity"].data.max() <= 50


def test_same_seed_same_arrays(data):
    again = ssbgen.generate(1, 2**33 + 7, sizes=SMALL)
    for t, cols in data.tables.items():
        for c, col in cols.items():
            np.testing.assert_array_equal(col.data, again.tables[t][c].data)


def test_port_schema_is_the_ports_ssb_schema():
    """The port's own SSB schema, column for column, hierarchy for
    hierarchy, with SSB's other columns added after its own."""
    import dataclasses

    from repro_torch.core.schema import Column
    from repro_torch.workloads import ssb

    ours, ported = ssbgen.port_schema(), ssb.build_schema()
    pairs = [(ours.fact, ported.fact)] + list(zip(ours.dimensions, ported.dimensions))
    assert [d.name for d in ours.dimensions] == [d.name for d in ported.dimensions]
    for mine, theirs in pairs:
        table = "lineorder" if mine is ours.fact else mine.name
        assert mine.columns == theirs.columns + tuple(
            Column(n, k) for n, k in ssbgen.REST_KINDS[table])
        assert dataclasses.replace(mine, columns=theirs.columns) == theirs
    assert dataclasses.replace(ours, fact=ported.fact, dimensions=ported.dimensions) == ported


@pytest.mark.parametrize("table", sorted(ssbgen.SSB_COLUMNS))
def test_every_table_has_every_ssb_column(data, table):
    """SSB rev. 3's columns, all of them, and the port's own besides."""
    cols = data.tables[table]
    assert set(ssbgen.SSB_COLUMNS[table]) <= set(cols)
    assert set(cols) - set(ssbgen.SSB_COLUMNS[table]) <= {"lo_date", "d_quarter"}
    assert {len(c.data) for c in cols.values()} == {data.rows(table)}
    kinds = dict(ssbgen.REST_KINDS[table])
    for name, kind in kinds.items():
        assert cols[name].kind == kind


def test_the_other_columns_leave_the_queried_ones_as_they_were(data, monkeypatch):
    """The columns that no SSB query reads come from a stream of their own:
    the queried columns are the same with or without them."""
    monkeypatch.setattr(ssbgen, "_rest", lambda tables, rng: None)
    narrow = ssbgen.generate(1, 2**33 + 7, sizes=SMALL)
    for t, cols in narrow.tables.items():
        for c, col in cols.items():
            np.testing.assert_array_equal(col.data, data.tables[t][c].data)


def test_orders_lines_and_their_totals(data):
    """1 to 7 lines an order, numbered from 1; an order's total is its
    lines' prices taxed and discounted (TPC-H's O_TOTALPRICE); commit
    30 to 90 days after the order."""
    lo = data.tables["lineorder"]
    key, line = lo["lo_orderkey"].data, lo["lo_linenumber"].data
    assert key[0] == 1 and np.all(np.diff(key) >= 0) and np.all(np.diff(key) <= 1)
    assert line.min() == 1 and line.max() == 7
    np.testing.assert_array_equal(line[1:][np.diff(key) == 1], 1)
    np.testing.assert_array_equal(np.diff(line)[np.diff(key) == 0], 1)
    cents = (np.rint(lo["lo_extendedprice"].data * 100) * (100 + lo["lo_tax"].data)
             * (100 - lo["lo_discount"].data) / 1e4)
    want = np.rint(np.bincount(key - 1, weights=cents)) / 100
    np.testing.assert_allclose(lo["lo_ordtotalprice"].data, want[key - 1], rtol=0, atol=1e-6)
    lag = lo["lo_commitdate"].data - lo["lo_orderdate"].data
    assert lag.min() >= 30 and lag.max() <= 90
    assert lo["lo_commitdate"].data.max() < len(data.tables["dates"]["d_key"].data)


def test_port_dataset_shares_the_arrays(data):
    ds = ssbgen.port_dataset(data)
    assert ds.fact.columns["lo_revenue"].data is data.tables["lineorder"]["lo_revenue"].data
    assert ds.fact.num_rows == SMALL["lineorder"]
    assert list(ds.dims["customer"].columns["c_nation"].vocab) == \
        list(data.tables["customer"]["c_nation"].vocab)
