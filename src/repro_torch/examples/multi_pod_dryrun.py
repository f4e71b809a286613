"""Partitioned cold-scan walkthrough: a dashboard miss burst served by the
partition-parallel scan plane, on one card or several.

Registers an SSB tenant whose backend is ``OlapExecutor(partitions=8)`` on
``--device`` and submits a cold dashboard through :class:`CacheService`.
The miss burst runs ONE shared partitioned scan: on one card each
partition launches the seg_agg kernels on a CUDA stream of its own; with
several cards the partitions are pinned to them in turn (on the CPU they
run the plain versions on pool threads).  The merged results are
cross-checked against an unpartitioned ``partitions=1`` executor.  Prints
per-partition row/launch accounting and the warm-pass hit statuses.  (The
JAX script of this name forces 8 virtual host devices, one per partition.)

    PYTHONPATH=src python -m repro_torch.examples.multi_pod_dryrun [n_fact_rows] [--device cpu]
"""
from __future__ import annotations

import argparse
import time

from ..olap.columnar import resolve_device
from ..olap.executor import OlapExecutor, scan_devices
from ..service.api import QueryRequest
from ..service.service import CacheService
from ..workloads import ssb

PARTITIONS = 8

_JOINS = ("JOIN dates ON lineorder.lo_orderdate = dates.d_key "
          "JOIN customer ON lineorder.lo_custkey = customer.c_key "
          "JOIN supplier ON lineorder.lo_suppkey = supplier.s_key "
          "JOIN part ON lineorder.lo_partkey = part.p_key ")
_DASHBOARD = [
    f"SELECT c_region, SUM(lo_revenue) AS rev, AVG(lo_quantity) AS q, "
    f"COUNT(*) AS n FROM lineorder {_JOINS}WHERE d_year = {y} GROUP BY c_region"
    for y in (1993, 1995, 1997)
] + [
    f"SELECT p_mfgr, SUM(lo_revenue) AS rev, MIN(lo_supplycost) AS lo, "
    f"MAX(lo_supplycost) AS hi FROM lineorder {_JOINS}"
    f"WHERE s_region = 'AMERICA' GROUP BY p_mfgr",
]


def main(argv=None, served: list | None = None) -> dict:
    """Run the burst; ``served``, where given, receives the cold burst's
    results (their tables are what a caller holds to an oracle)."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("n_fact", nargs="?", type=int, default=200_000, help="LINEORDER rows")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    n_fact = args.n_fact

    device = resolve_device(args.device)
    devices = scan_devices(device) or [device]
    print(f"== scan plane across {len(devices)} torch device(s) "
          f"({', '.join(map(str, devices))}), {PARTITIONS} partitions")

    print(f"building SSB: {n_fact:,} fact rows ...")
    wl = ssb.build(n_fact=n_fact, seed=0)

    svc = CacheService()
    svc.register_tenant("dash", schema=wl.schema,
                        backend=OlapExecutor(wl.dataset, partitions=PARTITIONS,
                                             device=device))

    reqs = [QueryRequest(sql=q, tenant="dash") for q in _DASHBOARD]
    t0 = time.perf_counter()
    cold = svc.submit_batch(reqs)
    cold_s = time.perf_counter() - t0
    print(f"\ncold burst: {len(cold)} queries in {cold_s:.2f}s "
          f"(statuses: {sorted({r.status for r in cold})})")
    print(f"  provenance tail: {cold[0].provenance[-2:]}")
    if served is not None:
        served.extend(cold)

    st = svc.tenant("dash").backend.stats()
    print(f"  partitioned scans : {st['partitioned_scans']} "
          f"(one shared scan for the whole burst)")
    print(f"  rows scanned      : {st['rows_scanned']:,} "
          f"(same-shape queries share one pass over the {n_fact:,} rows)")
    print("  per-partition accounting:")
    for p in st["per_partition"]:
        print(f"    rows [{p['start']:>7,}, {p['end']:>7,})  "
              f"scanned {p['rows_scanned']:>9,}  launches {p['executions']}")

    warm = svc.submit_batch([QueryRequest(sql=q, tenant="dash") for q in _DASHBOARD])
    print(f"\nwarm pass: statuses {sorted({r.status for r in warm})} "
          f"(served from cache, no scan)")

    print("\ncross-checking merged results vs partitions=1 oracle ...")
    svc2 = CacheService()
    svc2.register_tenant("oracle", schema=wl.schema,
                         backend=OlapExecutor(wl.dataset, partitions=1, device=device))
    expect = svc2.submit_batch([QueryRequest(sql=q, tenant="oracle") for q in _DASHBOARD])
    bad = [i for i, (g, e) in enumerate(zip(cold, expect))
           if not g.table.equals(e.table, rtol=1e-3)]
    if bad:
        raise AssertionError(f"MISMATCH vs unpartitioned oracle: queries {bad}")
    print(f"  all {len(cold)} merged results match the unpartitioned oracle")
    return {"n_fact": n_fact, "cold_statuses": sorted({r.status for r in cold}),
            "provenance_tail": list(cold[0].provenance[-2:]),
            "partitioned_scans": st["partitioned_scans"], "rows_scanned": st["rows_scanned"],
            "per_partition": [{k: p[k] for k in ("start", "end", "rows_scanned", "executions")}
                              for p in st["per_partition"]],
            "warm_statuses": sorted({r.status for r in warm}), "matched": len(cold)}


if __name__ == "__main__":
    main()
