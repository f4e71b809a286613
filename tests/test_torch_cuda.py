"""The port's CUDA kernels on the card, against their plain PyTorch versions
and the numpy oracle.  Every test here needs an NVIDIA GPU (marker
``cuda``) and skips without one; the file imports neither JAX nor the JAX
package, so it runs where only PyTorch is installed:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Sums use atomics, whose order changes from run to run: rtol 1e-4.  The
attention kernels are held to their plain versions evaluated on the
inputs' exact float32 values (in bfloat16 ``decode_attention_ref`` would
repeat the JAX oracle's casts, which the kernels do not make): float32 rtol
= atol = 2e-3 (the tolerance of ``tests/test_kernels.py``); bfloat16 rtol
4e-3, atol 5e-4, since a bfloat16 kernel does the float32 arithmetic and
rounds once at the output (at most 2**-9 relative), while the atol stays
far below the 0.02-0.04 outputs of long rows, where a lost key tile would
show.  The SSD scan is held to the sequential ``ssd_ref`` (at the engine
ceiling, S = 512, ``ssd_chunked``) on the inputs' exact float32 values, at
``SSD_TOL``: float32 tighter than the 5e-3 of ``tests/test_kernels.py``,
bfloat16 one output rounding (2**-8 relative) more.
"""
import numpy as np
import pytest
import torch

from repro_torch.core.sql_canon import SQLCanonicalizer
from repro_torch.kernels.binding import launch_counts, reset_launch_counts
from repro_torch.kernels.decode_attn import kernel as dkernel
from repro_torch.kernels.decode_attn import ref as dref
from repro_torch.kernels.flash_attn import kernel as fkernel
from repro_torch.kernels.flash_attn import ref as fref
from repro_torch.kernels.seg_agg import kernel as tkernel
from repro_torch.kernels.seg_agg import ref as tref
from repro_torch.kernels.ssd_scan import kernel as skernel
from repro_torch.kernels.ssd_scan import ref as sref
from repro_torch.olap.executor import OlapExecutor
from repro_torch.workloads import ssb

T = torch.from_numpy

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda", torch.cuda.current_device())


def _close(got, want, tol=1e-4):
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               rtol=tol, atol=tol)


def _rand_bounds(rng, p, k):
    """(P, K, 2) inclusive ranges over 0..9 with never-match pads."""
    b = np.empty((p, k, 2), np.float32)
    b[..., 0], b[..., 1] = np.inf, -np.inf
    for i in range(p):
        for j in range(rng.integers(1, k + 1)):
            a = rng.integers(0, 10, size=2)
            b[i, j] = (min(a), max(a))
    return b


@pytest.mark.parametrize("n,m,g,p,k,s", [
    (5000, 1, 1, 0, 1, 1), (20000, 3, 25, 2, 2, 6), (7777, 2, 2500, 3, 4, 6),
    (50000, 2, 200000, 1, 1, 2), (3000, 5, 250, 1, 2, 70)])
@pytest.mark.parametrize("op", ["sum", "min", "max"])
def test_kernels_match_plain(cuda_device, n, m, g, p, k, s, op):
    """Shared-memory tiles, grid.y tiles and the global-atomic path, NaN
    values and predicates, NaN-sentinel and pad ranges, an empty mask, and
    more signatures than one launch takes."""
    rng = np.random.default_rng(n + g)
    vals = rng.normal(size=(n, m)).astype(np.float32)
    vals[rng.random((n, m)) < 0.01] = np.nan
    ids = rng.integers(0, g, size=n).astype(np.int32)
    pred = rng.integers(0, 10, size=(n, p)).astype(np.float32)
    pred[rng.random((n, p)) < 0.01] = np.nan
    bounds = np.stack([_rand_bounds(rng, p, k) for _ in range(s)])
    if p:
        bounds[0, 0, -1] = (np.nan, np.nan)  # NaN sentinel
    mask = (rng.random(n) > 0.3).astype(np.float32)
    dev = cuda_device
    v, i, pr, b, mk = (T(a).to(dev) for a in (vals, ids, pred, bounds, mask))
    reset_launch_counts()
    _close(tkernel.seg_agg_fused_cuda(v, i, pr, b, g, op),
           tref.seg_agg_batch_ref(v, i, pr, b, g, op))
    assert launch_counts()["seg_agg_fused"] == -(-s // tkernel.MAX_SIGNATURES)
    for select, plain in ((True, tref.seg_agg_masked_ref), (False, tref.seg_agg_ref)):
        _close(tkernel.seg_agg_cuda(v, i, mk, g, op, select=select),
               plain(v, i, mk, g, op))
    empty = torch.zeros_like(mk)
    _close(tkernel.seg_agg_cuda(v, i, empty, g, op),
           tref.seg_agg_masked_ref(v, i, empty, g, op))
    torch.cuda.synchronize()


def _fused_inputs(dev, n, m, g, p, s, seed):
    """The dashboard refresh's kind of inputs: uniform values, ids over g
    groups, a year-like predicate column and s disjoint one-year ranges."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    v = torch.rand((n, m), generator=gen, device=dev)
    ids = torch.randint(0, g, (n,), generator=gen, device=dev, dtype=torch.int32)
    pred = torch.randint(8000, 10600, (n, p), generator=gen, device=dev).float()
    b = torch.tensor([[[[8035.0 + 365 * i, 8035.0 + 365 * i + 364]]] * p for i in range(s)],
                     device=dev)
    return v, ids, pred, b


@pytest.mark.parametrize("g,tier", [(5, "thread"), (37, "block"), (200_000, "global")])
@pytest.mark.parametrize("op", ["sum", "min", "max"])
def test_masked_kernel_matches_plain_in_every_tier(cuda_device, g, tier, op):
    """Kernel A in each slot tier it takes (M 3: per thread up to G 24, per
    block up to ~56 k slots, global atomics past them), under both mask
    contracts, with NaN values (in masked-out rows too: the multiply
    contract's 0 * NaN poisons the group, select keeps it out), NaN and
    fractional masks, an empty mask, and ids outside [0, G) (they reach no
    group: the plain version, which takes ids in range only, gets the rest
    of the rows)."""
    n, m = 30_000, 3
    rng = np.random.default_rng(g)
    vals = rng.normal(size=(n, m)).astype(np.float32)
    vals[rng.random((n, m)) < 0.01] = np.nan
    ids = rng.integers(0, g, size=n).astype(np.int32)
    mask = (rng.random(n) > 0.3).astype(np.float32)
    mask[::13] = 0.5  # not > 0.5: outside the select contract
    mask[1::13] = np.nan
    mask[2::13] = 0.75
    v, i, mk = (T(a).to(cuda_device) for a in (vals, ids, mask))
    assert tkernel.masked_tier(n, m, g, op) == tier
    reset_launch_counts()
    for select, plain in ((True, tref.seg_agg_masked_ref), (False, tref.seg_agg_ref)):
        want = plain(v, i, mk, g, op)
        got = tkernel.seg_agg_cuda(v, i, mk, g, op, select=select)
        np.testing.assert_array_equal(np.isnan(got.cpu().numpy()), np.isnan(want.cpu().numpy()))
        _close(got, want)
    empty = torch.zeros_like(mk)
    _close(tkernel.seg_agg_cuda(v, i, empty, g, op), tref.seg_agg_masked_ref(v, i, empty, g, op))
    assert launch_counts()["seg_agg"] == 3  # one launch per call
    stray = i.clone()
    stray[::97], stray[1::97] = -1, g
    keep = (stray >= 0) & (stray < g)
    _close(tkernel.seg_agg_cuda(v, stray, mk, g, op),
           tref.seg_agg_masked_ref(v[keep], i[keep], mk[keep], g, op))
    torch.cuda.synchronize()


@pytest.mark.parametrize("m,g,tier", [(2, 5, "thread"), (2, 40, "thread"), (1, 1, "thread"),
                                      (2, 84, "block"), (2, 6250, "block")])
@pytest.mark.parametrize("op,select", [("sum", True), ("sum", False), ("min", True),
                                       ("max", True)])
def test_masked_kernel_repeats_bit_for_bit(cuda_device, m, g, tier, op, select):
    """The host-mask request's shape (G 5) and kernel B's per-block shapes
    (G 84, 6250) at 1M rows: two calls give identical bits where the slots
    are per thread (SUM in both contracts too); above that slot count (per
    block, shared atomics) SUM still matches the plain version and MIN/MAX
    repeat exactly."""
    gen = torch.Generator(device=cuda_device).manual_seed(g + m)
    n = 1_000_000
    v = torch.rand((n, m), generator=gen, device=cuda_device)
    ids = torch.randint(0, g, (n,), generator=gen, device=cuda_device, dtype=torch.int32)
    mask = (torch.rand(n, generator=gen, device=cuda_device) > 0.5).float()
    assert tkernel.masked_tier(n, m, g, op, select) == tier
    plain = tref.seg_agg_masked_ref if select else tref.seg_agg_ref
    got = tkernel.seg_agg_cuda(v, ids, mask, g, op, select=select)
    _close(got, plain(v, ids, mask, g, op))
    again = tkernel.seg_agg_cuda(v, ids, mask, g, op, select=select)
    if tier in tkernel.DETERMINISTIC or op != "sum":
        assert torch.equal(got, again)
    else:
        _close(again, got)


@pytest.mark.parametrize("m,g,p,s,tier", [
    (3, 5, 1, 6, "warp"), (2, 5, 1, 1, "thread"), (2, 25, 2, 1, "thread"),
    (2, 250, 1, 2, "warp"), (2, 250, 1, 1, "block"), (2, 6250, 1, 1, "block")])
@pytest.mark.parametrize("op", ["sum", "min"])
def test_fused_repeats_bit_for_bit(cuda_device, m, g, p, s, tier, op):
    """The dashboard refresh's shape and single-signature misses at 1M rows:
    two calls give identical bits where the slots are per thread or per
    warp (SUM too); above that slot count (per block, shared atomics) the
    results still match the plain version, and MIN repeats exactly."""
    v, ids, pred, b = _fused_inputs(cuda_device, 1_000_000, m, g, p, s, g + s)
    assert tkernel.fused_tier(v.shape[0], m, p, 1, s, g, op) == tier
    got = tkernel.seg_agg_fused_cuda(v, ids, pred, b, g, op)
    _close(got, tref.seg_agg_batch_ref(v, ids, pred, b, g, op))
    again = tkernel.seg_agg_fused_cuda(v, ids, pred, b, g, op)
    if tier in tkernel.DETERMINISTIC or op == "min":
        assert torch.equal(got, again)
    else:
        _close(again, got)


def test_wrappers_check_their_inputs(cuda_device):
    v = torch.zeros((8, 2), device=cuda_device)
    ids = torch.zeros(8, dtype=torch.int32, device=cuda_device)
    with pytest.raises(TypeError):
        tkernel.seg_agg_cuda(v, ids.long(), torch.ones(8, device=cuda_device), 2)
    with pytest.raises(ValueError):
        tkernel.seg_agg_cuda(v.t(), ids, torch.ones(2, device=cuda_device), 2)
    with pytest.raises(ValueError):
        tkernel.seg_agg_fused_cuda(v, ids, torch.zeros((8, 1), device=cuda_device),
                                   torch.zeros((1, 2, 1, 2), device=cuda_device), 2)
    wide = torch.zeros((9, 2), device=cuda_device)
    with pytest.raises(ValueError, match="16-byte"):  # rows 1.. start 8 bytes in
        tkernel.seg_agg_fused_cuda(wide[1:], ids, torch.zeros((8, 1), device=cuda_device),
                                   torch.zeros((1, 1, 1, 2), device=cuda_device), 2)
    with pytest.raises(ValueError, match="16-byte"):
        tkernel.seg_agg_cuda(wide[1:], ids, torch.ones(8, device=cuda_device), 2)


def test_executor_on_cuda_matches_oracle(cuda_device):
    """Every SSB intent, single and as one batch, on the card."""
    wl = ssb.build(n_fact=50_000, seed=3)
    canon = SQLCanonicalizer(wl.schema)
    ex = OlapExecutor(wl.dataset, device=cuda_device)
    oracle = OlapExecutor(wl.dataset, impl="numpy")
    sigs = [canon.canonicalize(i.sql) for i in wl.intents]
    reset_launch_counts()
    for sig, batched in zip(sigs, ex.execute_batch(sigs)):
        want = oracle.execute(sig)
        assert ex.execute(sig).equals(want, ordered=bool(sig.order_by))
        assert batched.equals(want, ordered=bool(sig.order_by))
    assert launch_counts()["seg_agg_fused"] > 0


HOST_MASK = ("SELECT c_region, SUM(lo_revenue) AS rev, COUNT(*) AS n FROM lineorder "
             "JOIN customer ON lineorder.lo_custkey = customer.c_key "
             "WHERE lo_extendedprice > 5000.25 GROUP BY c_region")
TILE = ("SELECT c_region, SUM(lo_revenue) AS rev, AVG(lo_quantity) AS q, COUNT(*) AS n, "
        "MIN(lo_supplycost) AS lo, MAX(lo_supplycost) AS hi FROM lineorder "
        "JOIN customer ON lineorder.lo_custkey = customer.c_key "
        "JOIN dates ON lineorder.lo_orderdate = dates.d_key "
        "WHERE d_year = {y} GROUP BY c_region")


def _chip_smoke():
    """``chip_smoke.py``, beside ``tests/``, as a module."""
    import importlib
    import sys
    from pathlib import Path

    root = str(Path(__file__).resolve().parents[1])
    sys.path.insert(0, root)
    try:
        return importlib.import_module("chip_smoke")
    finally:
        sys.path.remove(root)


@pytest.mark.parametrize("shards", [1, 4])
def test_service_on_cuda_matches_the_cpu_and_the_oracle(cuda_device, shards):
    """``CacheService`` over the card's executor: the SSB SQL stream
    interleaved across intents (its batches carry several measure
    families), then a host-mask request (kernel A) with two dashboard tiles
    (kernel B), in batches of 8.  The statuses and tables of a tenant on
    the CPU, every table equal to the numpy oracle, no failure, degraded
    result or error; at ``shards=4`` kernels A and B are called from two or
    more ``shard-miss`` threads within one batch, all on the default
    stream."""
    from repro_torch.launch import serve
    from repro_torch.service import CacheService

    ThreadLaunches = _chip_smoke().ThreadLaunches
    sqls = serve.sql_streams(ssb.build(n_fact=200_000, seed=3), order="interleaved")["ssb_sql"]
    sqls += [HOST_MASK, TILE.format(y=1992), TILE.format(y=1993)]
    tenants = {}
    for device in ("cpu", "cuda"):
        wl = ssb.build(n_fact=200_000, seed=3)
        svc = CacheService()
        tenant = serve.build_tenant(svc, wl, device=device, shards=shards)
        reset_launch_counts()
        res = []
        with ThreadLaunches() as threads:
            for i in range(0, len(sqls), 8):
                threads.batch = i // 8
                res += serve.replay(svc, sqls[i:i + 8])
        tenants[device] = (wl, tenant, res, launch_counts())
    wl, tenant, res, launches = tenants["cuda"]
    cpu_res = tenants["cpu"][2]
    assert [r.status for r in res] == [r.status for r in cpu_res]
    assert tenant.stats.failures == tenant.stats.degraded == 0
    assert all(r.error is None and r.table is not None for r in res)
    oracle = OlapExecutor(wl.dataset, impl="numpy")
    for r, c in zip(res, cpu_res):
        want = oracle.execute(r.signature)
        assert r.table.equals(want, ordered=bool(r.signature.order_by)), r.provenance
        assert r.table.equals(c.table, ordered=bool(r.signature.order_by))
    assert launches["seg_agg"] >= 1 and launches["seg_agg_fused"] >= 1
    # ``threads`` recorded the card's run, the last of the loop
    shard_threads = {b: threads.shard_threads(b) for b in threads.calls}
    if shards == 4:
        assert any(len(ths) >= 2 for ths in shard_threads.values()), dict(threads.calls)
        last = threads.calls[(len(sqls) - 1) // 8]
        assert {k for _, k in last} == {"seg_agg_cuda", "seg_agg_fused_cuda"}
    else:
        assert not any(shard_threads.values())


def test_kernels_on_several_streams_at_once_match_plain(cuda_device):
    """Kernels A and B launched from four threads at once, each on a
    stream of its own (the scan plane's pattern), in the per-thread,
    per-block and global slot tiers: every output equals the plain
    version, and each stream has its own scratch."""
    import threading

    gen = torch.Generator(device=cuda_device)
    gen.manual_seed(7)
    n = 1 << 20
    cases = []
    for i, g in enumerate((5, 84, 6250, 400_000)):
        v = torch.rand(n, 2, generator=gen, device=cuda_device)
        ids = torch.randint(0, g, (n,), generator=gen, device=cuda_device, dtype=torch.int32)
        pred = torch.randint(0, 10, (n, 1), generator=gen, device=cuda_device).float()
        bounds = torch.tensor([[[[0.0, 4.0]]], [[[3.0, 9.0]]]], device=cuda_device)
        mask = (torch.rand(n, generator=gen, device=cuda_device) < 0.5).float()
        cases.append((v, ids, pred, bounds, mask, g))
    torch.cuda.synchronize()
    streams = [torch.cuda.Stream(cuda_device) for _ in cases]
    outs: dict = {}
    errors: list = []

    def worker(i):
        v, ids, pred, bounds, mask, g = cases[i]
        try:
            with torch.cuda.stream(streams[i]):
                for _ in range(10):
                    b = tkernel.seg_agg_fused_cuda(v, ids, pred, bounds, g, "sum")
                    a = tkernel.seg_agg_cuda(v, ids, mask, g, "sum")
                    mn = tkernel.seg_agg_fused_cuda(v, ids, pred, bounds, g, "min")
                streams[i].synchronize()
            outs[i] = (b, a, mn)
        except Exception as e:  # re-raised below in the test's thread
            errors.append(e)

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(len(cases))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads) and not errors, errors
    for i, (v, ids, pred, bounds, mask, g) in enumerate(cases):
        b, a, mn = outs[i]
        _close(b, tref.seg_agg_batch_ref(v, ids, pred, bounds, g, "sum"))
        _close(a, tref.seg_agg_masked_ref(v, ids, mask, g, "sum"))
        _close(mn, tref.seg_agg_batch_ref(v, ids, pred, bounds, g, "min"))
    keys = {(cuda_device.index, s.cuda_stream) for s in streams}
    assert keys <= set(tkernel._SCRATCH)
    assert len({id(tkernel._SCRATCH[k][0]) for k in keys}) == len(streams)


def test_scan_plane_on_cuda_matches_the_oracle(cuda_device):
    """``OlapExecutor(partitions=4, max_device_rows=...)`` on the card:
    every SSB intent alone and in one batch, plus the host-mask request,
    equal to the numpy oracle; the shared scan launches kernels from two
    or more ``scan-part`` threads on two or more streams; a delta scan
    (``execute_batch(partition=)``) runs on the card over its rows only."""
    ThreadLaunches = _chip_smoke().ThreadLaunches
    wl = ssb.build(n_fact=300_000, seed=4)
    canon = SQLCanonicalizer(wl.schema)
    sigs = [canon.canonicalize(i.sql) for i in wl.intents] + [canon.canonicalize(HOST_MASK)]
    oracle = OlapExecutor(wl.dataset, impl="numpy")
    ex = OlapExecutor(wl.dataset, partitions=4, max_device_rows=1 << 16, device=cuda_device)
    reset_launch_counts()
    with ThreadLaunches() as threads:
        threads.batch = "batch"
        batched = ex.execute_batch(sigs)
        threads.batch = "single"
        for sig, b in zip(sigs, batched):
            want = oracle.execute(sig)
            assert b.equals(want, ordered=bool(sig.order_by)), sig.canonical_json()
            assert ex.execute(sig).equals(want, ordered=bool(sig.order_by))
        threads.batch = "delta"
        delta = ex.execute_batch(sigs, partition=(1000, 7000))
    part = {(th, st) for th, st, _, _ in threads.detail["batch"] if th.startswith("scan-part")}
    assert len({th for th, _ in part}) >= 2 and len({st for _, st in part}) >= 2
    assert {k for _, _, k, _ in threads.detail["batch"]} == {"seg_agg_cuda", "seg_agg_fused_cuda"}
    assert {r for *_, r in threads.detail["delta"]} == {6000}
    sliced = OlapExecutor(wl.dataset.slice_rows(1000, 7000), impl="numpy")
    for sig, d in zip(sigs, delta):
        assert d.equals(sliced.execute(sig), ordered=bool(sig.order_by))
    st = ex.stats()
    assert st["streaming_chunks"] > 0 and st["partition_fallbacks"] == 0
    delta_rows = st["rows_scanned"] - sum(p["rows_scanned"] for p in st["per_partition"])
    assert delta_rows > 0 and delta_rows % 6000 == 0  # the delta scan, outside the plane
    assert launch_counts()["seg_agg"] > 0 and launch_counts()["seg_agg_fused"] > 0


ATTN_TOL = {torch.float32: (2e-3, 2e-3), torch.bfloat16: (4e-3, 5e-4)}  # (rtol, atol)


def _attn_close(got, want, dtype):
    rtol, atol = ATTN_TOL[dtype]
    np.testing.assert_allclose(got.float().cpu().numpy(), want.float().cpu().numpy(),
                               rtol=rtol, atol=atol)


# GQA groups G in {1, 2, 3, 4, 8} at the tile edges S in {2, 63, 64, 65, 129}:
# the bf16 kernel packs the G heads of a KV head into 64-row tiles by position
FLASH_EDGES = [(2, 2 * g, 2, s, 64) for g in (1, 2, 3, 4, 8) for s in (2, 63, 64, 65, 129)] \
    + [(1, 2 * g, 2, s, 128) for g in (2, 8) for s in (65, 129)]


# every other head dim the kernels are built for, at the head counts of the
# configs that use it (reduced configs 16 at 4/2, kimi-k2 112 at 64/8,
# zamba2-7b 112 at 32/32, nemotron-4-340b 192 at 96/8, gemma-2b 256 at 8/1),
# at tile edges
HEAD_DIM_CASES = [(1, h, hkv, s, dh) for dh, h, hkv in ((16, 4, 2), (32, 8, 1), (112, 64, 8),
                                                       (112, 32, 32), (192, 96, 8),
                                                       (256, 8, 1))
                  for s in (1, 65, 129)]


@pytest.mark.parametrize("b,h,hkv,s,dh", [
    (2, 4, 2, 256, 64), (1, 8, 1, 128, 32), (1, 8, 1, 128, 128), (1, 4, 4, 100, 64),
    (2, 2, 2, 64, 128), (3, 12, 4, 77, 64), (8, 12, 4, 77, 64), (1, 3, 1, 1, 64),
    (1, 6, 2, 1000, 128), *FLASH_EDGES, *HEAD_DIM_CASES])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_matches_plain(cuda_device, b, h, hkv, s, dh, causal, dtype):
    gen = torch.Generator(device=cuda_device).manual_seed(b * 1000 + s)
    q, k, v = (torch.randn(shape, generator=gen, device=cuda_device).to(dtype)
               for shape in ((b, h, s, dh), (b, hkv, s, dh), (b, hkv, s, dh)))
    reset_launch_counts()
    got = fkernel.flash_attention_cuda(q, k, v, causal=causal)
    assert launch_counts()["flash_attn"] == 1
    assert got.dtype == dtype and got.shape == q.shape
    _attn_close(got, fref.mha_ref(q.float(), k.float(), v.float(), causal=causal), dtype)
    torch.cuda.synchronize()


@pytest.mark.parametrize("b,h,hkv,s,dh", [
    (2, 8, 2, 512, 64), (1, 4, 1, 300, 128), (3, 4, 4, 128, 32), (3, 4, 4, 128, 64),
    (4, 12, 4, 4096, 64), (4, 4, 2, 512, 16), (4, 64, 8, 512, 112), (4, 32, 32, 512, 112),
    (4, 96, 8, 512, 192), (4, 8, 1, 512, 256)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_attention_matches_plain(cuda_device, b, h, hkv, s, dh, dtype):
    gen = torch.Generator(device=cuda_device).manual_seed(b * 1000 + s)
    q = torch.randn((b, h, dh), generator=gen, device=cuda_device).to(dtype)
    k, v = (torch.randn((b, hkv, s, dh), generator=gen, device=cuda_device).to(dtype)
            for _ in range(2))
    pos = torch.tensor([1, 77, s - 1, s][:b], dtype=torch.int32, device=cuda_device)
    reset_launch_counts()
    got = dkernel.decode_attention_cuda(q, k, v, pos)
    assert launch_counts()["decode_attn"] == 1
    _attn_close(got, dref.decode_attention_ref(q.float(), k.float(), v.float(), pos), dtype)
    # slots at or past pos are never read: changing them changes nothing
    k2, v2 = k.clone(), v.clone()
    for i, p in enumerate(pos.tolist()):
        k2[i, :, p:] = 999.0
        v2[i, :, p:] = float("nan")
    assert torch.equal(dkernel.decode_attention_cuda(q, k2, v2, pos), got)
    torch.cuda.synchronize()


@pytest.mark.parametrize("g", [1, 3, 4, 8])
@pytest.mark.parametrize("s,dh", [(32, 64), (33, 128), (512, 64), (512, 128)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_attention_chunk_edges(cuda_device, g, s, dh, dtype):
    """pos at the edges of the kernel's chunks of cache slots, mixed in one
    batch (whole chunks empty for one row and live for another), a row with
    pos 0 (zeros, as the Pallas kernel gives), and two calls bit-identical
    (the partials combine in a fixed order)."""
    c = dkernel.CHUNK
    pos = torch.tensor([min(p, s) for p in (1, c - 1, c, c + 1, 2 * c + 1, s, s, 0)],
                       dtype=torch.int32, device=cuda_device)
    b, hkv = len(pos), 2
    gen = torch.Generator(device=cuda_device).manual_seed(100 * g + s)
    q = torch.randn((b, hkv * g, dh), generator=gen, device=cuda_device).to(dtype)
    k, v = (torch.randn((b, hkv, s, dh), generator=gen, device=cuda_device).to(dtype)
            for _ in range(2))
    reset_launch_counts()
    got = dkernel.decode_attention_cuda(q, k, v, pos)
    assert launch_counts()["decode_attn"] == 1
    live = pos > 0
    _attn_close(got[live], dref.decode_attention_ref(q.float(), k.float(), v.float(),
                                                     pos)[live], dtype)
    assert not got[~live].any()
    assert torch.equal(dkernel.decode_attention_cuda(q, k, v, pos), got)
    torch.cuda.synchronize()


@pytest.mark.parametrize("s", [1, 63, 64, 65, 77, 129])
@pytest.mark.parametrize("g", [1, 3, 8, 20])
@pytest.mark.parametrize("dh", fkernel.HEAD_DIMS)
def test_bf16_decode_is_the_prefill_row_bit_for_bit(cuda_device, s, g, dh):
    """A bf16 decode step over a cache of S tokens gives exactly the prefill
    kernel's output for the newest token (the serving engine's decode then
    agrees with a forward pass, which bf16 rounding would not survive)."""
    b, hkv = 2, 2
    gen = torch.Generator(device=cuda_device).manual_seed(100 * g + s)
    q, k, v = (torch.randn(shape, generator=gen, device=cuda_device).to(torch.bfloat16)
               for shape in ((b, hkv * g, s, dh), (b, hkv, s, dh), (b, hkv, s, dh)))
    last = fkernel.flash_attention_cuda(q, k, v)[:, :, -1]
    pad = torch.full((b, hkv, 11, dh), float("nan"), dtype=torch.bfloat16, device=cuda_device)
    pos = torch.full((b,), s, dtype=torch.int32, device=cuda_device)
    got = dkernel.decode_attention_cuda(q[:, :, -1].contiguous(), torch.cat([k, pad], 2),
                                        torch.cat([v, pad], 2), pos)
    assert torch.equal(got, last)
    torch.cuda.synchronize()


def test_attention_wrappers_refuse_other_head_dims(cuda_device):
    q = torch.zeros((1, 4, 8, 320), device=cuda_device)
    kv = torch.zeros((1, 2, 8, 320), device=cuda_device)
    with pytest.raises(ValueError, match="head dim 320"):
        fkernel.flash_attention_cuda(q, kv, kv)
    qd = torch.zeros((1, 4, 96), device=cuda_device)
    kd = torch.zeros((1, 2, 16, 96), device=cuda_device)
    pos = torch.ones(1, dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError, match="head dim 96"):
        dkernel.decode_attention_cuda(qd, kd, kd, pos)
    with pytest.raises(TypeError):
        fkernel.flash_attention_cuda(*[torch.zeros((1, 2, 8, 32), dtype=torch.float16,
                                                   device=cuda_device)] * 3)
    with pytest.raises(ValueError):
        dkernel.decode_attention_cuda(torch.zeros((1, 4, 64), device=cuda_device),
                                      torch.zeros((1, 3, 16, 64), device=cuda_device),
                                      torch.zeros((1, 3, 16, 64), device=cuda_device), pos)
    # a contiguous view that starts inside a row cannot be read in 16-byte vectors
    kv16 = torch.zeros(1 + 2 * 8 * 64, dtype=torch.bfloat16, device=cuda_device)
    with pytest.raises(ValueError, match="16-byte"):
        fkernel.flash_attention_cuda(kv16[1:].view(1, 2, 8, 64), kv16[1:].view(1, 2, 8, 64),
                                     kv16[1:].view(1, 2, 8, 64))


SSD_TOL = {torch.float32: (1e-3, 1e-3), torch.bfloat16: (4e-3, 1e-3)}  # (rtol, atol)


def _ssd_inputs(dev, b, s, h, p, n, dtype, dt_hi, seed):
    """dt in [0.001, 0.001 + dt_hi): 0.1 as tests/test_kernels.py, 2.0 as
    large as mamba2's init gives; A in (-8, -1) as mamba2's a_log."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((b, s, h, p), generator=gen, device=dev).to(dtype)
    dt = 0.001 + torch.rand((b, s, h), generator=gen, device=dev) * dt_hi
    A = -1.0 - 7.0 * torch.rand(h, generator=gen, device=dev)
    Bm, Cm = (torch.randn((b, s, n), generator=gen, device=dev) for _ in range(2))
    return x, dt, A, Bm, Cm


@pytest.mark.parametrize("b,s,h,p,n", [
    (2, 1, 3, 16, 16), (2, 77, 3, 64, 128), (1, 100, 48, 64, 128), (2, 128, 1, 16, 64),
    (1, 300, 3, 32, 16), (1, 4096, 3, 64, 128), (8, 77, 48, 64, 128),
    # zamba2-7b: 112 heads, P 64, N 64 (the last block's group holds one head)
    (2, 77, 112, 64, 64), (1, 300, 112, 64, 64)])
@pytest.mark.parametrize("dt_hi", [0.1, 2.0])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_scan_matches_plain(cuda_device, b, s, h, p, n, dt_hi, dtype):
    x, dt, A, Bm, Cm = _ssd_inputs(cuda_device, b, s, h, p, n, dtype, dt_hi, s + n)
    reset_launch_counts()
    y, state = skernel.ssd_scan_cuda(x, dt, A, Bm, Cm, return_state=True)
    assert launch_counts()["ssd_scan"] == 1
    assert y.dtype == dtype and y.shape == x.shape and state.shape == (b, h, p, n)
    assert torch.equal(skernel.ssd_scan_cuda(x, dt, A, Bm, Cm), y)
    # the sequential scan at every S (ssd_final_state loses ~1e-3 relative
    # at S = 4096: benchmarks/bench_torch_ssd_precision.py)
    want_y, want_state = sref.ssd_ref(x.float(), dt, A, Bm, Cm)
    rtol, atol = SSD_TOL[dtype]
    np.testing.assert_allclose(y.float().cpu().numpy(), want_y.cpu().numpy(),
                               rtol=rtol, atol=atol)
    rtol, atol = SSD_TOL[torch.float32]  # the state is float32 in both
    np.testing.assert_allclose(state.cpu().numpy(), want_state.cpu().numpy(),
                               rtol=rtol, atol=atol)
    torch.cuda.synchronize()


def test_ssd_scan_at_the_engine_ceiling(cuda_device):
    """8 prompts of 512 tokens (16 chunks per block), bf16 x, dt as large as
    mamba2's init gives, against ``ssd_chunked`` + ``ssd_final_state``."""
    x, dt, A, Bm, Cm = _ssd_inputs(cuda_device, 8, 512, 48, 64, 128, torch.bfloat16, 2.0, 5)
    y, state = skernel.ssd_scan_cuda(x, dt, A, Bm, Cm, return_state=True)
    want_y = sref.ssd_chunked(x.float(), dt, A, Bm, Cm)
    want_state = sref.ssd_final_state(x.float(), dt, A, Bm)
    rtol, atol = SSD_TOL[torch.bfloat16]
    np.testing.assert_allclose(y.float().cpu().numpy(), want_y.cpu().numpy(),
                               rtol=rtol, atol=atol)
    rtol, atol = SSD_TOL[torch.float32]
    np.testing.assert_allclose(state.cpu().numpy(), want_state.cpu().numpy(),
                               rtol=rtol, atol=atol)


def test_ssd_scan_reads_nothing_past_s(cuda_device):
    """With B = 1 a prefix of S rows is contiguous: the storage past S holds
    NaN, and the kernel's output and state equal those of exact-size
    tensors."""
    s, big = 77, 128
    x, dt, A, Bm, Cm = _ssd_inputs(cuda_device, 1, big, 48, 64, 128, torch.bfloat16,
                                   2.0, 1)
    for t in (x, dt, Bm, Cm):
        t[:, s:] = float("nan")
    views = [t[:, :s] for t in (x, dt, Bm, Cm)]
    assert all(v.is_contiguous() for v in views)
    y, state = skernel.ssd_scan_cuda(views[0], views[1], A, views[2], views[3],
                                     return_state=True)
    want = skernel.ssd_scan_cuda(*(v.clone() for v in views[:2]), A,
                                 *(v.clone() for v in views[2:]), return_state=True)
    assert torch.isfinite(y.float()).all() and torch.isfinite(state).all()
    assert torch.equal(y, want[0]) and torch.equal(state, want[1])


def test_ssd_wrapper_checks_its_inputs(cuda_device):
    x, dt, A, Bm, Cm = _ssd_inputs(cuda_device, 1, 8, 2, 16, 16, torch.float32, 0.1, 0)
    with pytest.raises(TypeError):
        skernel.ssd_scan_cuda(x, dt.to(torch.bfloat16), A, Bm, Cm)
    with pytest.raises(TypeError):
        skernel.ssd_scan_cuda(x.half(), dt, A, Bm, Cm)
    with pytest.raises(ValueError, match="CUDA tensors"):
        skernel.ssd_scan_cuda(x, dt, A.cpu(), Bm, Cm)
    with pytest.raises(ValueError, match="do not match"):
        skernel.ssd_scan_cuda(x, dt[:, :4], A, Bm, Cm)
    with pytest.raises(ValueError, match="contiguous"):
        skernel.ssd_scan_cuda(x.transpose(1, 2), dt, A, Bm, Cm)
    x48 = torch.zeros((1, 8, 2, 48), device=cuda_device)
    with pytest.raises(ValueError, match="head dim 48"):
        skernel.ssd_scan_cuda(x48, dt, A, Bm, Cm)
    b100 = torch.zeros((1, 8, 100), device=cuda_device)
    with pytest.raises(ValueError, match="state size 100"):
        skernel.ssd_scan_cuda(x, dt, A, b100, b100)
    wide = torch.zeros(8 * 16 + 1, device=cuda_device)
    with pytest.raises(ValueError, match="16-byte"):  # starts 4 bytes in
        skernel.ssd_scan_cuda(x, dt, A, wide[1:].view(1, 8, 16), Cm)


def test_mamba2_on_the_card_matches_the_cpu(cuda_device):
    """The reduced Mamba2 in float32: prefill through the kernel, the decode
    step in plain PyTorch on the card, against the same model on the CPU."""
    import dataclasses

    from repro_torch.configs.registry import reduced
    from repro_torch.models import mamba2

    cfg = dataclasses.replace(reduced("mamba2-780m"), dtype=torch.float32)
    params = mamba2.init_params(cfg, 0, device="cpu")
    tokens = torch.randint(0, cfg.vocab, (3, 40), generator=torch.Generator().manual_seed(0))
    out = {}
    for dev in ("cpu", cuda_device):
        p = mamba2.to_device(params, dev)
        with torch.inference_mode():
            logits, caches, pos = mamba2.prefill(cfg, p, tokens=tokens.to(dev))
            step = mamba2.decode_step(cfg, p, tokens[:, -1].to(dev), caches, pos)[0]
        out[str(dev)] = (logits.cpu(), step.cpu(), caches["state"].cpu())
    reset_launch_counts()
    with torch.inference_mode():
        mamba2.forward(cfg, mamba2.to_device(params, cuda_device), tokens=tokens.to(cuda_device))
    assert launch_counts()["ssd_scan"] == cfg.n_layers
    for got, want in zip(out[str(cuda_device)], out["cpu"]):
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-3, atol=1e-3)


# (rtol, atol) of the backward kernel against ``mha_bwd_ref`` on the inputs'
# exact float32 values.  float32: only the order of f32 sums differs.
# bfloat16: the kernel does the f32 arithmetic but takes D = rowsum(dO * O)
# from the forward's bf16 output and rounds dq, dk, dv once (2**-9
# relative); at the training shape the plain rehearsal of that arithmetic
# (``flash_bwd_tiled_ref``) lies 0.0066 past rtol 1e-2 on gradients up to 10.
BWD_TOL = {torch.float32: (1e-3, 1e-3), torch.bfloat16: (1e-2, 2e-2)}

# the training shape (canonicalizer-100m: batch 16, 12 heads over 4, S 192),
# tile edges of both tilings (64 rows to head dim 128, 32 past it), GQA
# groups 1, 3 and 8, and every head dim the kernels are built for
BWD_CASES = [(16, 12, 4, 192, 64), (2, 4, 2, 77, 64), (1, 3, 1, 1, 64), (2, 8, 1, 65, 32),
             (2, 4, 4, 129, 128), (1, 8, 2, 100, 16), (1, 16, 2, 33, 112),
             (1, 6, 2, 65, 192), (1, 8, 1, 97, 256), (1, 2, 2, 31, 256)]


def _bwd_inputs(dev, b, h, hkv, s, dh, dtype, seed):
    gen = torch.Generator(device=dev).manual_seed(seed)
    q, do = (torch.randn((b, h, s, dh), generator=gen, device=dev).to(dtype)
             for _ in range(2))
    k, v = (torch.randn((b, hkv, s, dh), generator=gen, device=dev).to(dtype)
            for _ in range(2))
    return q, k, v, do


@pytest.mark.parametrize("b,h,hkv,s,dh", BWD_CASES)
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_bwd_matches_plain(cuda_device, b, h, hkv, s, dh, causal, dtype):
    """dq, dk, dv of the backward kernel against the plain backward, and two
    calls bit for bit (no atomics: every sum in a fixed order)."""
    q, k, v, do = _bwd_inputs(cuda_device, b, h, hkv, s, dh, dtype, b * 1000 + s + dh)
    o = fkernel.flash_attention_cuda(q, k, v, causal=causal)
    reset_launch_counts()
    got = fkernel.flash_attention_bwd_cuda(q, k, v, o, do, causal=causal)
    assert launch_counts()["flash_attn_bwd"] == 1
    want = fref.mha_bwd_ref(q.float(), k.float(), v.float(), do.float(), causal=causal)
    rtol, atol = BWD_TOL[dtype]
    for name, g, w, x in zip(("dq", "dk", "dv"), got, want, (q, k, v)):
        assert g.dtype == dtype and g.shape == x.shape, name
        np.testing.assert_allclose(g.float().cpu().numpy(), w.cpu().numpy(), rtol=rtol,
                                   atol=atol, err_msg=name)
    again = fkernel.flash_attention_bwd_cuda(q, k, v, o, do, causal=causal)
    assert all(torch.equal(x, y) for x, y in zip(got, again))
    torch.cuda.synchronize()


def test_flash_attention_bwd_refuses_other_head_dims(cuda_device):
    q = torch.zeros((1, 4, 8, 320), device=cuda_device)
    kv = torch.zeros((1, 2, 8, 320), device=cuda_device)
    with pytest.raises(ValueError, match="head dim 320"):
        fkernel.flash_attention_bwd_cuda(q, kv, kv, q, q)
    q, k, v, do = _bwd_inputs(cuda_device, 1, 4, 2, 8, 64, torch.float32, 0)
    with pytest.raises(ValueError, match="o .* does not match q"):
        fkernel.flash_attention_bwd_cuda(q, k, v, q[:, :, :4].contiguous(), do)
    with pytest.raises(TypeError, match="dtypes differ"):
        fkernel.flash_attention_bwd_cuda(q, k, v, q, do.to(torch.bfloat16))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_autograd_launches_both_kernels(cuda_device, dtype):
    """``flash_attention`` under grad goes through ``FlashAttention``: the
    forward and the backward kernel once each, and the gradients of the
    plain version (which the CPU tensors take under autograd)."""
    from repro_torch.kernels.flash_attn.ops import flash_attention

    q, k, v, do = _bwd_inputs(cuda_device, 2, 6, 2, 77, 64, dtype, 7)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    reset_launch_counts()
    out = flash_attention(*leaves)
    out.backward(do)
    assert launch_counts()["flash_attn"] == 1 and launch_counts()["flash_attn_bwd"] == 1
    cpu = [t.detach().float().cpu().requires_grad_() for t in (q, k, v)]
    flash_attention(*cpu).backward(do.float().cpu())
    rtol, atol = BWD_TOL[dtype]
    for leaf, ref_leaf in zip(leaves, cpu):
        np.testing.assert_allclose(leaf.grad.float().cpu().numpy(), ref_leaf.grad.numpy(),
                                   rtol=rtol, atol=atol)


def test_transformer_forward_on_cuda_reaches_the_attention_weights(cuda_device):
    """A loss through ``transformer.forward`` on the card gives every
    layer's wq, wk and wv a finite gradient (the forward kernel alone, a
    ctypes launch into a new tensor, would cut the graph there)."""
    import dataclasses

    from repro_torch.configs.registry import reduced
    from repro_torch.models import transformer

    cfg = dataclasses.replace(reduced("canonicalizer-100m"), dtype=torch.float32)
    params = transformer.init_params(cfg, 0, device=cuda_device)
    for lp in params["layers"]:
        for name in ("wq", "wk", "wv"):
            lp[name].requires_grad_()
    tokens = torch.randint(0, cfg.vocab, (2, 33), device=cuda_device)
    reset_launch_counts()
    transformer.forward(cfg, params, tokens=tokens).square().mean().backward()
    counts = launch_counts()
    assert counts["flash_attn"] == counts["flash_attn_bwd"] == cfg.n_layers
    for lp in params["layers"]:
        for name in ("wq", "wk", "wv"):
            assert lp[name].grad is not None and bool(torch.isfinite(lp[name].grad).all())


def test_kernels_without_a_backward_refuse_grad(cuda_device):
    """decode_attn, seg_agg and ssd_scan raise on CUDA inputs that require
    grad, instead of returning a tensor cut off from the graph; under
    no_grad they launch as before."""
    from repro_torch.kernels.decode_attn.ops import decode_attention
    from repro_torch.kernels.seg_agg import ops as seg_ops
    from repro_torch.kernels.ssd_scan.ops import ssd_scan

    q = torch.randn((2, 4, 64), device=cuda_device, requires_grad=True)
    kv = torch.randn((2, 2, 16, 64), device=cuda_device)
    pos = torch.full((2,), 16, dtype=torch.int32, device=cuda_device)
    with pytest.raises(NotImplementedError, match="decode_attention"):
        decode_attention(q, kv, kv, pos)
    vals = torch.randn((100, 2), device=cuda_device, requires_grad=True)
    ids = torch.zeros(100, dtype=torch.int32, device=cuda_device)
    mask = torch.ones(100, device=cuda_device)
    with pytest.raises(NotImplementedError, match="seg_agg"):
        seg_ops.seg_agg(vals, ids, mask, 1)
    cols = torch.zeros((100, 1), device=cuda_device)
    bounds = torch.tensor([[[0.0, 1.0]]], device=cuda_device)
    with pytest.raises(NotImplementedError, match="seg_agg"):
        seg_ops.seg_agg_fused(vals, ids, cols, bounds, 1)
    x = torch.randn((1, 8, 2, 64), device=cuda_device, requires_grad=True)
    dt = torch.full((1, 8, 2), 0.1, device=cuda_device)
    A = -torch.ones(2, device=cuda_device)
    bm = torch.randn((1, 8, 16), device=cuda_device)
    with pytest.raises(NotImplementedError, match="ssd_scan backward"):
        ssd_scan(x, dt, A, bm, bm)
    with torch.no_grad():
        reset_launch_counts()
        decode_attention(q, kv, kv, pos)
        ssd_scan(x, dt, A, bm, bm)
        seg_ops.seg_agg(vals, ids, mask, 1)
    counts = launch_counts()
    assert counts["decode_attn"] == counts["ssd_scan"] == counts["seg_agg"] == 1


def _moe_cfg(name, **kw):
    import dataclasses

    from repro_torch.configs.registry import reduced

    return dataclasses.replace(reduced(name), dtype=torch.float32, **kw)


@pytest.mark.parametrize("name,kw", [
    ("kimi-k2-1t-a32b", {}), ("qwen3-moe-235b-a22b", {"n_experts": 32, "top_k": 4}),
    ("qwen3-moe-235b-a22b", {"capacity_factor": 0.25})])
def test_moe_ffn_on_the_card_matches_the_cpu(cuda_device, name, kw):
    """The MoE FFN (plain PyTorch on both devices, no kernel) in float32:
    the same routes kept and dropped, the same output within 1e-4."""
    from repro_torch.models import moe, transformer

    cfg = _moe_cfg(name, **kw)
    lp = transformer.init_params(cfg, 0, device="cpu")["layers"][-1]
    x = torch.randn((3, 20, cfg.d_model), generator=torch.Generator().manual_seed(1))
    x[0, :4] = 0.0  # rows whose router logits all tie
    out = {}
    for dev in ("cpu", cuda_device):
        p = {k: t.to(dev) for k, t in lp.items()}
        with moe.count_dropped() as dropped:
            y = moe.moe_ffn(p, x.to(dev), cfg)
        _, ids, slots, _ = moe.route(p, x.to(dev).reshape(60, -1), cfg)
        out[str(dev)] = (y.cpu(), ids.cpu(), slots.cpu(), int(sum(dropped)))
    got, want = out[str(cuda_device)], out["cpu"]
    np.testing.assert_allclose(got[0].numpy(), want[0].numpy(), rtol=1e-4, atol=1e-4)
    assert torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])
    assert got[3] == want[3]


def test_moe_ffn_on_the_card_repeats_bit_for_bit(cuda_device):
    """bf16, 16 expert shards: a token's outputs from several shards in one
    step are summed in a fixed order, so two calls agree bit for bit."""
    import dataclasses

    from repro_torch.configs.registry import reduced
    from repro_torch.models import moe, transformer

    cfg = dataclasses.replace(reduced("qwen3-moe-235b-a22b"), n_experts=32, top_k=8,
                              capacity_factor=64.0)
    lp = transformer.init_params(cfg, 0, device=cuda_device)["layers"][0]
    x = torch.randn((4, 64, cfg.d_model), generator=torch.Generator().manual_seed(3))
    x = x.to(cuda_device, torch.bfloat16)
    first = moe.moe_ffn(lp, x, cfg)
    assert all(torch.equal(moe.moe_ffn(lp, x, cfg), first) for _ in range(3))


@pytest.mark.parametrize("name", ["kimi-k2-1t-a32b", "qwen3-moe-235b-a22b", "zamba2-7b"])
def test_new_families_on_the_card_match_the_cpu(cuda_device, name):
    """The reduced MoE and hybrid models in float32: prefill and two decode
    steps on the card (the attention kernels; zamba2 also the SSD-scan
    kernel once per Mamba layer) against the same model on the CPU."""
    from repro_torch.models import zamba2

    cfg = _moe_cfg(name)
    mod = cfg.build()
    params = mod.init_params(cfg, 0, device="cpu")
    tokens = torch.randint(0, cfg.vocab, (3, 40), generator=torch.Generator().manual_seed(0))
    out, counts = {}, None
    for dev in ("cpu", cuda_device):
        p = mod.to_device(params, dev)
        reset_launch_counts()
        with torch.inference_mode():
            logits, caches, pos = mod.prefill(cfg, p, tokens=tokens.to(dev), cache_len=48)
            steps = []
            for i in range(2):
                step, caches, pos = mod.decode_step(cfg, p, tokens[:, i].to(dev), caches, pos)
                steps.append(step.cpu())
        counts = launch_counts()
        out[str(dev)] = (logits.cpu(), *steps)
    apps = zamba2.attn_apps(cfg) if cfg.kind == "hybrid" else cfg.n_layers
    assert counts["flash_attn"] == apps and counts["decode_attn"] == 2 * apps
    assert counts["ssd_scan"] == (cfg.n_layers if cfg.kind == "hybrid" else 0)
    for got, want in zip(out[str(cuda_device)], out["cpu"]):
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-3, atol=1e-3)
