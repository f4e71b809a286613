#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--n-fact 6000000] [--seed 0]

Phases, in order; any failed check raises and the script exits non-zero:

1. build   — compile every CUDA kernel from the sources in this checkout
             (one nvcc per source, all started together).
2. kernels — hold each kernel against its plain PyTorch version on the card:
             a small case with NaN values, NaN-sentinel and pad ranges and an
             empty mask, then a sweep at main-path shapes (N = n_fact).
             Tolerance: rtol 1e-4, atol 1e-4, NaN where the plain version has
             NaN (sums use atomics, so their last bits vary run to run).
             Times the kernel, the plain version and, where one exists, one
             PyTorch library call computing the same function.
3. serve   — SSB at ``--n-fact`` rows (SF1's LINEORDER has 6,000,000)
             through the SQL pipeline and the semantic cache: the SSB SQL
             stream, the hierarchical drill stream, a 6-tile dashboard
             refresh (one shared scan) and one request whose filter needs
             the host-mask branch.  Every served table is checked against
             the numpy oracle; the kernel launch counts are read from this
             phase alone.  Prints per-stage p50/p95 of the request path.
4. profile — a fresh dataset and tenant replay the first 64 SSB requests
             under ``torch.profiler`` (device busy share of a cold start, the
             kernels and copies that took the most device time), and again
             under ``cProfile`` (host functions by own time).

The last three lines of standard output are the ``kernels`` JSON line, the
card's name and power limit, and ``{"ok": true, "device": {...}}``.  Exits
non-zero without a result where CUDA is absent, or where the port's sources
are not beside this script.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 (NVIDIA data sheet)
F32_OPS_PER_S = 67e12  # H100 SXM f32 outside the tensor cores
RTOL = ATOL = 1e-4


def _fail(msg: str) -> int:
    print(f"chip_smoke: {msg}", file=sys.stderr)
    return 2


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device milliseconds per call, timed with CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def compare(got, want, what: str) -> float:
    """Max |got - want| over finite entries; raises unless NaNs agree and
    every entry is within rtol/atol."""
    import torch

    got, want = got.double().cpu(), want.double().cpu()
    if got.shape != want.shape:
        raise AssertionError(f"{what}: shape {tuple(got.shape)} != {tuple(want.shape)}")
    if not torch.equal(torch.isnan(got), torch.isnan(want)):
        raise AssertionError(f"{what}: NaN positions differ")
    ok = ~torch.isnan(want)
    g, w = got[ok], want[ok]
    same_inf = torch.isinf(w) & (g == w)
    g, w = g[~same_inf], w[~same_inf]
    err = float((g - w).abs().max()) if g.numel() else 0.0
    if g.numel() and not torch.allclose(g, w, rtol=RTOL, atol=ATOL):
        raise AssertionError(f"{what}: max abs err {err} beyond rtol {RTOL}")
    return err


# --------------------------------------------------------------- kernels


def _bounds(gen, s, p, k, dev, lo=0, hi=10):
    """(S, P, K, 2) random inclusive ranges, last K slot a pad range; the
    first signature's first predicate also accepts NaN (sentinel)."""
    import torch

    a = torch.randint(lo, hi, (s, p, k, 2), generator=gen, device=dev).float()
    b = torch.stack([a.min(-1).values, a.max(-1).values], dim=-1)
    if k > 1:
        b[:, :, -1, 0], b[:, :, -1, 1] = float("inf"), float("-inf")
        if p:
            b[0, 0, -1, 0] = b[0, 0, -1, 1] = float("nan")
    return b.contiguous()


def kernel_checks(n_fact: int, dev, gen) -> dict:
    import torch

    from repro_torch.kernels.seg_agg import kernel as K
    from repro_torch.kernels.seg_agg import ref as R

    errs = {"seg_agg": 0.0, "seg_agg_fused": 0.0}

    def check_a(v, ids, mask, g, op, select, what):
        plain = R.seg_agg_masked_ref if select else R.seg_agg_ref
        got = K.seg_agg_cuda(v, ids, mask, g, op, select=select)
        errs["seg_agg"] = max(errs["seg_agg"], compare(got, plain(v, ids, mask, g, op), what))

    def check_b(v, ids, pred, b, g, op, what):
        got = K.seg_agg_fused_cuda(v, ids, pred, b, g, op)
        want = R.seg_agg_batch_ref(v, ids, pred, b, g, op)
        errs["seg_agg_fused"] = max(errs["seg_agg_fused"], compare(got, want, what))

    # small: NaN values and predicates, sentinel and pad ranges, empty mask
    n, m, g = 5000, 3, 37
    v = torch.randn(n, m, generator=gen, device=dev)
    v[torch.rand(n, m, generator=gen, device=dev) < 0.02] = float("nan")
    ids = torch.randint(0, g, (n,), generator=gen, device=dev, dtype=torch.int32)
    pred = torch.randint(0, 10, (n, 2), generator=gen, device=dev).float()
    pred[torch.rand(n, 2, generator=gen, device=dev) < 0.02] = float("nan")
    mask = (torch.rand(n, generator=gen, device=dev) > 0.3).float()
    empty = torch.zeros(n, device=dev)
    for op in ("sum", "min", "max"):
        for select in (True, False):
            check_a(v, ids, mask, g, op, select, f"A small {op} select={select}")
        check_a(v, ids, empty, g, op, True, f"A small {op} empty mask")
        check_b(v, ids, pred, _bounds(gen, 6, 2, 4, dev), g, op, f"B small {op}")
        never = torch.tensor([[[[float("inf"), float("-inf")]]] * 2], device=dev)
        check_b(v, ids, pred, never, g, op, f"B small {op} empty mask")

    # main-path shapes: N = n_fact, M 1..5, G 1..2500, P <= 3, S in {1, 6}
    for m, g, p, s in ((1, 1, 1, 1), (2, 5, 2, 6), (3, 25, 3, 1), (4, 250, 0, 6),
                       (5, 2500, 1, 6)):
        v = torch.rand(n_fact, m, generator=gen, device=dev)
        ids = torch.randint(0, g, (n_fact,), generator=gen, device=dev, dtype=torch.int32)
        pred = torch.randint(0, 10, (n_fact, p), generator=gen, device=dev).float()
        mask = (torch.rand(n_fact, generator=gen, device=dev) > 0.5).float()
        b = _bounds(gen, s, p, 2, dev)
        for op in ("sum", "min"):
            check_a(v, ids, mask, g, op, True, f"A N={n_fact} M={m} G={g} {op}")
            check_b(v, ids, pred, b, g, op, f"B N={n_fact} M={m} G={g} P={p} S={s} {op}")
    torch.cuda.synchronize()
    return errs


def kernel_times(n_fact: int, dev, gen, iters: int) -> dict:
    """Kernel, plain and library times at the main path's shapes: kernel A
    at the host-mask request's (sum block [COUNT, SUM], 5 regions), kernel
    B at the dashboard refresh's (sum block [COUNT, SUM, AVG], 5 regions,
    one time-window predicate, 6 tiles)."""
    import torch

    from repro_torch.kernels.seg_agg import kernel as K
    from repro_torch.kernels.seg_agg import ref as R

    out = {}
    n, m, g = n_fact, 2, 5
    v = torch.rand(n, m, generator=gen, device=dev)
    ids = torch.randint(0, g, (n,), generator=gen, device=dev, dtype=torch.int32)
    mask = (torch.rand(n, generator=gen, device=dev) > 0.5).float()
    pre = torch.where(mask[:, None] > 0.5, v, torch.zeros((), device=dev))
    ids64 = ids.long()
    byts = n * (m + 2) * 4 + g * m * 4
    out["seg_agg"] = {
        "ms": cuda_ms(lambda: K.seg_agg_cuda(v, ids, mask, g, "sum"), iters),
        "plain_ms": cuda_ms(lambda: R.seg_agg_masked_ref(v, ids, mask, g, "sum"),
                            max(3, iters // 4)),
        "library_ms": cuda_ms(lambda: torch.zeros(g, m, device=dev).index_add_(0, ids64, pre),
                              iters),
        "bytes": byts, "ops": n * m,
        "shape": f"values ({n},{m}) ids ({n},) mask ({n},) G={g} sum",
    }
    m, p, s = 3, 1, 6
    v = torch.rand(n, m, generator=gen, device=dev)
    pred = torch.randint(8000, 10600, (n, p), generator=gen, device=dev).float()
    b = torch.tensor([[[[8035.0 + 365 * i, 8035.0 + 365 * i + 364]]] for i in range(s)],
                     device=dev)
    byts = n * (m + 1 + p) * 4 + s * g * m * 4 + b.numel() * 4
    out["seg_agg_fused"] = {
        "ms": cuda_ms(lambda: K.seg_agg_fused_cuda(v, ids, pred, b, g, "sum"), iters),
        "plain_ms": cuda_ms(lambda: R.seg_agg_batch_ref(v, ids, pred, b, g, "sum"),
                            max(3, iters // 4)),
        "library_ms": None,
        "bytes": byts, "ops": n * p * s * 2 + n * m * s,
        "shape": f"values ({n},{m}) ids ({n},) pred ({n},{p}) bounds {tuple(b.shape)} G={g} sum",
    }
    for t in out.values():
        t["bound_ms"] = max(t["bytes"] / HBM_BYTES_PER_S, t["ops"] / F32_OPS_PER_S) * 1e3
        t["bound_by"] = ("bytes" if t["bytes"] / HBM_BYTES_PER_S
                         >= t["ops"] / F32_OPS_PER_S else "operations")
    return out


# ----------------------------------------------------------------- serve


DASHBOARD = ("SELECT c_region, SUM(lo_revenue) AS rev, AVG(lo_quantity) AS q, "
             "COUNT(*) AS n, MIN(lo_supplycost) AS lo, MAX(lo_supplycost) AS hi "
             "FROM lineorder JOIN customer ON lineorder.lo_custkey = customer.c_key "
             "JOIN dates ON lineorder.lo_orderdate = dates.d_key "
             "WHERE d_year = {y} GROUP BY c_region")
HOST_MASK = ("SELECT c_region, SUM(lo_revenue) AS rev, COUNT(*) AS n FROM lineorder "
             "JOIN customer ON lineorder.lo_custkey = customer.c_key "
             "WHERE lo_extendedprice > 5000.25 GROUP BY c_region")


def serve_phase(n_fact: int, seed: int) -> dict:
    import numpy as np
    import torch

    from repro_torch.kernels.seg_agg.kernel import kernel_launches, reset_kernel_launches
    from repro_torch.launch import serve
    from repro_torch.olap.executor import OlapExecutor
    from repro_torch.service.pipeline import QueryRequest, run_pipeline
    from repro_torch.workloads import ssb

    t0 = time.perf_counter()
    wl = ssb.build(n_fact=n_fact, seed=seed)
    tenant = serve.build_tenant(wl, device="cuda")
    oracle = OlapExecutor(wl.dataset, impl="numpy")
    secs = {"synthesis": time.perf_counter() - t0}
    torch.cuda.reset_peak_memory_stats()

    t0 = time.perf_counter()
    reset_kernel_launches()
    results = []
    for name, sqls in serve.sql_streams(wl).items():
        results += serve.replay(tenant, sqls, batch=8)
    before = kernel_launches()
    groups = tenant.backend.batch_groups
    tiles = run_pipeline(tenant, [QueryRequest(sql=DASHBOARD.format(y=y))
                                  for y in range(1992, 1998)])
    mid = kernel_launches()
    host = run_pipeline(tenant, [QueryRequest(sql=HOST_MASK)])
    torch.cuda.synchronize()
    launches = kernel_launches()
    secs["serve"] = time.perf_counter() - t0
    results += tiles + host

    if [r.status for r in tiles] != ["miss"] * 6 or not all(r.batched for r in tiles):
        raise AssertionError(f"dashboard tiles: {[r.status for r in tiles]}")
    if tenant.backend.batch_groups - groups != 1 \
            or mid["seg_agg_fused"] - before["seg_agg_fused"] != 2 \
            or mid["seg_agg"] != before["seg_agg"]:
        raise AssertionError(f"dashboard was not one shared scan: {before} -> {mid}")
    if host[0].status != "miss" or launches["seg_agg"] - mid["seg_agg"] != 1 \
            or launches["seg_agg_fused"] != mid["seg_agg_fused"]:
        raise AssertionError(f"host-mask request: {host[0].status}, {mid} -> {launches}")

    t0 = time.perf_counter()
    truth: dict[str, object] = {}
    wrong_miss = false_hits = 0
    for r in results:
        if r.table is None:
            raise AssertionError(f"no table for {r.status}: {r.provenance}")
        key = r.signature.key()
        if key not in truth:
            truth[key] = oracle.execute(r.signature)
        if not r.table.equals(truth[key], ordered=bool(r.signature.order_by)):
            if r.hit:
                false_hits += 1
            else:
                wrong_miss += 1
    secs["oracle_check"] = time.perf_counter() - t0
    statuses = dict(sorted(
        {s: sum(r.status == s for r in results) for s in {r.status for r in results}}.items()))
    if false_hits or wrong_miss:
        raise AssertionError(f"{false_hits} false hits, {wrong_miss} wrong miss tables")
    if not {"hit_exact", "hit_rollup", "miss"} <= set(statuses):
        raise AssertionError(f"statuses {statuses}")
    if not all(launches.values()):
        raise AssertionError(f"a kernel was never launched on the main path: {launches}")
    per_req = np.array([sum(r.timings_ms.values()) for r in results])
    stages = {}
    for stage in ("canonicalize", "validate", "lookup", "plan", "execute", "store"):
        ms = np.array([r.timings_ms[stage] for r in results if stage in r.timings_ms])
        stages[stage] = {"n": int(ms.size), "p50_ms": float(np.percentile(ms, 50)),
                         "p95_ms": float(np.percentile(ms, 95)),
                         "sum_ms": float(ms.sum())}
    # execute wall of each miss that ran on the backend (deduped followers
    # excluded); a shared scan's wall is attributed to each of its leaders
    scans = [r.timings_ms["execute"] for r in results
             if r.status == "miss" and not r.deduped]
    s = tenant.cache.stats
    return {
        "launches": launches,
        "summary": {
            "n_fact": n_fact, "requests": len(results), "statuses": statuses,
            "hit_rate": s.hit_rate, "false_hits": false_hits,
            "unique_tables_checked": len(truth),
            "backend_executions": tenant.backend.executions,
            "batch_groups": tenant.backend.batch_groups,
            "rows_scanned": tenant.backend.rows_scanned,
            "request_ms_p50": float(np.percentile(per_req, 50)),
            "request_ms_p95": float(np.percentile(per_req, 95)),
            "miss_request_ms_p50": float(np.percentile(
                [sum(r.timings_ms.values()) for r in results if r.status == "miss"], 50)),
            "miss_execute_ms_p50": float(np.percentile(scans, 50)),
            "miss_execute_ms_p95": float(np.percentile(scans, 95)),
            "stages": stages,
            "device_dataset_bytes": tenant.backend.dev.nbytes(),
            "upload_ms": wl.dataset.upload_time_ms(),
            "max_memory_allocated": torch.cuda.max_memory_allocated(),
            "phase_s": secs,
        },
    }


def _cold_tenant(n_fact: int, seed: int, requests: int):
    from repro_torch.launch import serve
    from repro_torch.workloads import ssb

    wl = ssb.build(n_fact=n_fact, seed=seed)
    return serve.build_tenant(wl, device="cuda"), serve.sql_streams(wl, requests)["ssb_sql"]


def profile_sample(n_fact: int, seed: int, requests: int = 64) -> dict:
    """Where a cold start's time goes: a fresh dataset and tenant replay the
    first ``requests`` SSB SQL requests under ``torch.profiler`` (device
    time is the summed duration of the kernels and copies it traced), then
    another fresh pair replays them under ``cProfile`` (host functions by
    own time)."""
    import cProfile
    import pstats

    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.launch import serve

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts):  # the tracer's start-up stays out of the window
        torch.ones(1, device="cuda").add_(1)
        torch.cuda.synchronize()
    tenant, sqls = _cold_tenant(n_fact, seed, requests)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=acts) as prof:
        serve.replay(tenant, sqls, batch=8)
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    tenant, sqls = _cold_tenant(n_fact, seed, requests)
    host = cProfile.Profile()
    host.runcall(serve.replay, tenant, sqls, 8)
    torch.cuda.synchronize()
    st = pstats.Stats(host).stats
    hot = sorted(st.items(), key=lambda kv: -kv[1][2])[:8]
    host_top = {f"{Path(f).name}:{ln}:{fn}": round(v[2] * 1e3, 1)
                for (f, ln, fn), v in hot}
    by_name: dict[str, float] = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
    device_ms = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    return {"requests": len(sqls), "wall_ms": wall_ms,
            "device_ms": device_ms if by_name else None,
            "device_busy_share": device_ms / wall_ms if by_name else None,
            "top_device_ms": {k[:60]: v for k, v in top},
            "host_own_ms_top": host_top}


SOURCES = {
    "seg_agg": ("src/repro_torch/kernels/seg_agg/csrc/seg_agg.cu",
                "src/repro/kernels/seg_agg/kernel.py:29 _seg_agg_kernel"),
    "seg_agg_fused": ("src/repro_torch/kernels/seg_agg/csrc/seg_agg.cu",
                      "src/repro/kernels/seg_agg/kernel.py:108 _seg_agg_fused_kernel"),
}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="PyTorch/CUDA port smoke run on one GPU")
    ap.add_argument("--n-fact", type=int, default=6_000_000)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args(argv)

    try:
        import torch
    except ImportError:
        return _fail("PyTorch is not installed")
    if not torch.cuda.is_available():
        return _fail("CUDA is not available: this smoke run needs an NVIDIA GPU")
    src = Path(__file__).resolve().parent / "src"
    if not (src / "repro_torch" / "kernels").is_dir():
        return _fail(f"the port's sources are not at {src}/repro_torch")
    sys.path.insert(0, str(src))
    from repro_torch.kernels.build import build_all

    t_all = time.perf_counter()
    card = nvidia_smi()
    t0 = time.perf_counter()
    built = build_all()
    print(f"[build] {json.dumps(built)} in {time.perf_counter() - t0:.1f} s; card: {card}")

    dev = torch.device("cuda", torch.cuda.current_device())
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)
    t0 = time.perf_counter()
    errs = kernel_checks(args.n_fact, dev, gen)
    times = kernel_times(args.n_fact, dev, gen, args.iters)
    print(f"[kernels] {time.perf_counter() - t0:.1f} s; max abs err {json.dumps(errs)}")
    for name, t in times.items():
        print(f"[kernels] {name} {t['shape']}: kernel {t['ms']:.4f} ms, plain "
              f"{t['plain_ms']:.4f} ms, library {t['library_ms']} ms, bound "
              f"{t['bound_ms']:.4f} ms ({t['bound_by']})")

    served = serve_phase(args.n_fact, args.seed)
    print(f"[serve] {json.dumps(served['summary'])}")
    t0 = time.perf_counter()
    print(f"[profile] {json.dumps(profile_sample(args.n_fact, args.seed))} "
          f"in {time.perf_counter() - t0:.1f} s")
    print(f"[total] {time.perf_counter() - t_all:.1f} s")

    kernels = [{
        "name": name, "route": "cuda", "source": SOURCES[name][0],
        "replaces": SOURCES[name][1], "launches": served["launches"][name],
        "max_abs_err": errs[name], "ms": times[name]["ms"],
        "plain_ms": times[name]["plain_ms"], "bound_ms": times[name]["bound_ms"],
        "bound_by": times[name]["bound_by"], "library_ms": times[name]["library_ms"],
    } for name in ("seg_agg", "seg_agg_fused")]
    print(json.dumps({"kernels": kernels}))
    print(nvidia_smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
