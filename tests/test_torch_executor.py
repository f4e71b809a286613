"""Parity of the port's OlapExecutor (plain PyTorch path on the CPU) with the
JAX executor (``impl='xla'``) and the port's own numpy oracle, on the
``ssb_small``/``tlc_small``/``tpcds_small`` data carried across with
``from_reference``.  Tables are compared with ``ResultTable.equals``
(rtol 1e-4)."""
import numpy as np
import pytest

from repro.core.sql_canon import SQLCanonicalizer as JSQLCanonicalizer
from repro.olap.executor import OlapExecutor as JOlapExecutor
from repro_torch.core.sql_canon import SQLCanonicalizer
from repro_torch.kernels.seg_agg import ops as seg_ops
from repro_torch.olap.columnar import from_reference
from repro_torch.olap.executor import OlapExecutor

J = ("JOIN customer ON lineorder.lo_custkey = customer.c_key "
     "JOIN dates ON lineorder.lo_orderdate = dates.d_key ")


def _port(wl):
    ds = from_reference(wl.dataset)
    return (ds, SQLCanonicalizer(ds.schema),
            OlapExecutor(ds, device="cpu"), OlapExecutor(ds, impl="numpy"))


def test_from_reference_copies_schema_and_data(ssb_small):
    ds = from_reference(ssb_small.dataset)
    assert ds.schema.name == ssb_small.schema.name
    assert [d.name for d in ds.schema.dimensions] == \
        [d.name for d in ssb_small.schema.dimensions]
    for name, col in ssb_small.dataset.fact.columns.items():
        np.testing.assert_array_equal(ds.fact.columns[name].data, col.data)
        assert ds.fact.columns[name].data is not col.data
    assert ds.column("customer.c_region").decode(np.array([0]))[0] == \
        ssb_small.dataset.column("customer.c_region").decode(np.array([0]))[0]


@pytest.mark.parametrize("fixture", ["ssb_small", "tlc_small", "tpcds_small"])
def test_every_intent_matches_jax_and_oracle(fixture, request):
    """execute and execute_batch, per intent signature, against the JAX
    executor and the numpy oracle."""
    wl = request.getfixturevalue(fixture)
    _, canon, ex, oracle = _port(wl)
    jcanon = JSQLCanonicalizer(wl.schema)
    jex = JOlapExecutor(wl.dataset, impl="xla")
    sigs, jsigs = [], []
    for intent in wl.intents:
        sig, jsig = canon.canonicalize(intent.sql), jcanon.canonicalize(intent.sql)
        assert sig.key() == jsig.key(), intent.id
        ordered = bool(sig.order_by)
        got = ex.execute(sig)
        assert got.equals(jex.execute(jsig), ordered=ordered), intent.id
        assert got.equals(oracle.execute(sig), ordered=ordered), intent.id
        sigs.append(sig)
        jsigs.append(jsig)
    for sig, got, want in zip(sigs, ex.execute_batch(sigs), jex.execute_batch(jsigs)):
        assert got.equals(want, ordered=bool(sig.order_by)), sig.canonical_json()


def test_shared_scan_group_is_one_launch(ssb_small):
    """A dashboard refresh (same levels and measures, different filters) is
    one shared scan: one launch for a SUM-only block, one more for a MIN/MAX
    block, rows scanned once."""
    ds, canon, ex, oracle = _port(ssb_small)
    sum_only = [canon.canonicalize(
        f"SELECT c_nation, SUM(lo_revenue) AS r, COUNT(*) AS n, AVG(lo_quantity) AS q "
        f"FROM lineorder {J}WHERE d_year = {y} GROUP BY c_nation")
        for y in (1993, 1994, 1995)]
    with_mm = [canon.canonicalize(
        f"SELECT c_region, SUM(lo_revenue) AS r, MIN(lo_supplycost) AS lo, "
        f"MAX(lo_supplycost) AS hi FROM lineorder {J}WHERE d_year = {y} "
        f"GROUP BY c_region") for y in (1992, 1996)]
    for sigs, launches in ((sum_only, 1), (with_mm, 2)):
        ex.execute_batch(sigs)  # warm the device caches
        seg_ops.reset_launch_count()
        rows, groups = ex.rows_scanned, ex.batch_groups
        tables = ex.execute_batch(sigs)
        assert seg_ops.launch_count() == launches
        assert ex.rows_scanned - rows == ds.fact.num_rows
        assert ex.batch_groups - groups == 1
        for sig, t in zip(sigs, tables):
            assert t.equals(oracle.execute(sig)), sig.canonical_json()


def test_host_mask_branch(ssb_small):
    """A filter on a float column not exact in f32 takes the host-mask
    branch: one masked launch, oracle-equal, JAX-equal."""
    ds, canon, ex, oracle = _port(ssb_small)
    sql = (f"SELECT c_region, SUM(lo_revenue) AS r, COUNT(*) AS n FROM lineorder "
           f"{J}WHERE lo_extendedprice > 5000.25 GROUP BY c_region")
    sig = canon.canonicalize(sql)
    assert ex._predicate_plan(sig) is None
    seg_ops.reset_launch_count()
    got = ex.execute(sig)
    assert seg_ops.launch_count() == 1
    assert got.equals(oracle.execute(sig))
    jwl = JOlapExecutor(ssb_small.dataset, impl="xla")
    assert got.equals(jwl.execute(JSQLCanonicalizer(ssb_small.schema).canonicalize(sql)))


def test_legacy_per_measure_path(ssb_small):
    ds, canon, _, oracle = _port(ssb_small)
    ex = OlapExecutor(ds, fused=False, device="cpu")
    sig = canon.canonicalize(
        "SELECT c_region, SUM(lo_revenue) AS r, AVG(lo_quantity) AS q, "
        f"MAX(lo_supplycost) AS hi, COUNT(*) AS n FROM lineorder {J}GROUP BY c_region")
    seg_ops.reset_launch_count()
    assert ex.execute(sig).equals(oracle.execute(sig))
    assert seg_ops.launch_count() == 4  # count col + SUM + AVG + MAX


def test_execute_raw_and_stats(ssb_small):
    ds, _, ex, _ = _port(ssb_small)
    assert ex.execute_raw("SELECT * FROM lineorder") is None
    t = ex.execute_raw(f"SELECT d_year, COUNT(*) AS n FROM lineorder {J}GROUP BY d_year")
    assert t.num_rows == 7
    st = ex.stats()
    assert st["executions"] == 2 and st["rows_scanned"] == 2 * ds.fact.num_rows
    assert st["device"] == "cpu" and st["memo_sizes"]["measure_plans"] == 1
    assert ds.device("cpu").nbytes() > 0


def test_scan_plane_options_not_ported(ssb_small):
    ds = from_reference(ssb_small.dataset)
    with pytest.raises(NotImplementedError):
        OlapExecutor(ds, partitions=2, device="cpu")
    with pytest.raises(NotImplementedError):
        OlapExecutor(ds, max_device_rows=1000, device="cpu")
    with pytest.raises(ValueError):
        OlapExecutor(ds, impl="xla", device="cpu")
