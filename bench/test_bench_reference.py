"""The plain reference against a brute-force loop over the rows, and its
bfloat16 control against the comparison."""
import collections
import random

import pytest

from yardstick import compare, flights, ssbgen
from yardstick.reference import Reference, gap

SMALL = {"lineorder": 3_000, "customer": 600, "supplier": 100, "part": 800}


@pytest.fixture(scope="module")
def data():
    return ssbgen.generate(1, 11, sizes=SMALL)


def brute(data, it):
    """One Python loop over the fact rows: each predicate read through the
    foreign key, each group summed."""
    fact = data.tables["lineorder"]

    def value(col, row):
        t, c = col.split(".")
        cd = data.tables[t][c]
        r = row if t == "lineorder" else int(fact[data.fk[t]].data[row])
        v = cd.data[r]
        return cd.vocab[v] if cd.kind == "str" else v

    def ok(p, row):
        v = value(p.col, row)
        return {"=": lambda: v == p.val[0], "in": lambda: v in p.val,
                "between": lambda: p.val[0] <= v <= p.val[1],
                "<": lambda: v < p.val[0], ">=": lambda: v >= p.val[0]}[p.op]()

    def measure(tree, row):
        if isinstance(tree, str):
            return float(value(tree, row))
        op, a, b = tree
        x, y = measure(a, row), measure(b, row)
        return {"*": x * y, "-": x - y, "+": x + y}[op]

    out = collections.defaultdict(float)
    if not it.levels:
        out[()] = 0.0
    for row in range(len(fact["lo_revenue"].data)):
        if all(ok(p, row) for p in it.preds):
            key = tuple(str(int(v)) if not isinstance(v, str) else v
                        for v in (value(lv, row) for lv in it.levels))
            out[key] += measure(flights.MEASURES[it.measure][1], row)
    return dict(out)


def intents():
    rng = random.Random(3)
    out = []
    for name in sorted(flights.FLIGHTS):
        it = flights.draw(rng, name)
        out += [it, flights.with_price_floor(it, rng), flights.regroup(it, rng),
                flights.drill(it, rng, 0.5), flights.roll(it, rng)]
        out += flights.tiles(it)[:2]
    # wide predicates, so that groups have rows at this size
    out.append(flights.Intent("wide", "revenue", ("customer.c_region", "dates.d_year"), ()))
    out.append(flights.Intent("wide", "profit", ("part.p_mfgr",), (
        flights.Pred("lineorder.lo_quantity", "<", (30,)),)))
    return out


@pytest.mark.parametrize("i", range(len(intents())))
def test_reference_equals_brute_force(data, i):
    it = intents()[i]
    ref = Reference(data).answer(it)
    want = brute(data, it)
    assert set(ref) == set(want)
    for k in want:
        assert ref[k] == pytest.approx(want[k], rel=1e-12, abs=1e-9)


def test_the_bfloat16_control_is_not_correct(data):
    """The control kept as a test: the reference in bfloat16 in the
    program's place fails the comparison (its reading on the chip at the
    cells' own sizes is in PERF.md)."""
    ref = Reference(data)
    rows = []
    for it in intents():
        differ, widest = gap(ref.answer(it, control=True), ref.answer(it))
        rows.append(("control", differ, widest))
    limits = {"wrong_groups": 0, "widest_gap": 1e-4}
    assert not compare.judge(rows, limits)["correct"]
    assert compare.judge([("x", False, 0.0)], limits)["correct"]


def test_control_py_fails_through_the_declared_modules(monkeypatch):
    """``bench/control.py`` for the cell: its data and answers come from
    the modules that the configuration names, and it is not correct."""
    import control
    from yardstick import modules

    loaded = []
    load = modules.load
    monkeypatch.setattr(modules, "load", lambda rel: loaded.append(rel) or load(rel))
    out = control.control_numbers("ssb-sf10.refresh", 2**32 + 9, 30, "cpu", sizes=SMALL)
    assert out["correct"] is False and out["numbers"]["answers"]["value"] == 30
    assert loaded == ["yardstick/ssbgen.py", "yardstick/reference.py"]
