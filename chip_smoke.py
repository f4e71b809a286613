#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--n-fact 6000000] [--seed 0] [--baseline DIR]

Phases, in order; any failed check raises and the script exits non-zero:

1. build   — compile every CUDA kernel from the sources in this checkout
             (one nvcc per compilation unit, all started together: the
             attention sources once per head dim); print the registers,
             spills and static shared memory from ``ptxas -v`` of each
             instance of the tensor-core kernels (attention, SSD scan) and
             of kernels A and B, and its HMMA (tensor-core) instruction
             count from ``cuobjdump -sass`` where installed (fails if a
             bf16 flash or an SSD-scan instance has none).  With
             ``--baseline DIR`` (a checkout of an earlier commit whose
             kernel A entry takes no scratch) also DIR's seg_agg,
             flash_attn and decode_attn, whose kernels are timed in turns
             with this checkout's, and their ptxas figures.
2. kernels — hold each kernel against its plain PyTorch version on the card.
             seg_agg / seg_agg_fused: a small case with NaN values,
             NaN-sentinel and pad ranges and an empty mask, kernel A in
             each of its slot tiers (per thread, per block, global) under
             both mask contracts and with ids outside [0, G), then a sweep
             at main-path shapes (N = n_fact); rtol 1e-4, atol 1e-4, NaN
             where the plain version has NaN; two calls of kernel A
             bit-identical where its slots are per thread and for MIN/MAX
             (per-block and global sums use atomics, so their last bits
             vary run to run).  flash_attn: head dims 64 and 128 over GQA
             groups 1, 2, 3, 4, 8, S in {1, 2, 63, 64, 65, 77, 96, 129, 512,
             1000} (the 64-row tile edges), causal and not; head dims 16,
             32, 112, 192 and 256 at the head counts of ``HEAD_DIM_HEADS``,
             S in {1, 63, 64, 65, 129, 512}.  decode_attn: caches of 512
             and 4096 slots (512 at the other head dims), pos in {1, C-1,
             C, C+1, 77, 511, S} in one batch (C = 32 slots per f32 block),
             two calls bit-identical, cache slots past pos overwritten (999
             keys, NaN values) change nothing, and in bf16 a decode step
             over each causal flash case's keys equals the flash output's
             last row bit for bit, at every head dim.  Both again at the
             main path's shapes (bf16, 8 prompts of 12 heads over 4 KV
             heads, head dim 64; decode at the first, a middle and the last
             decode step's pos on a 512-slot cache) and at the engine's
             ceiling (8 prompts of 512 tokens; decode at pos 512), and at
             the other head dims (8 prompts; decode at pos 512).  The plain
             versions run on the inputs' exact float32 values; tolerances
             (rtol, atol): float32 (2e-3, 2e-3), bfloat16 (4e-3, 5e-4).
             ssd_scan: S in {1, 77, 128, 300, 4096} over (N, P, H) in {(16,
             16, 1), (64, 64, 3), (128, 64, 48), (128, 16, 3)}, dt small
             (0.001-0.1) and as large as mamba2's init gives (up to 2), y
             with and without the final state; against the sequential
             ``ssd_ref`` (``ssd_final_state``'s whole-sequence cumulative
             sum loses ~1e-3 relative at S = 4096:
             ``benchmarks/bench_torch_ssd_precision.py``); tolerances
             (rtol, atol) float32 (1e-3,
             1e-3), bfloat16 y (4e-3, 1e-3); NaN in the storage past S
             changes nothing; again at the main path's shapes (8 prompts,
             48 heads, P 64, N 128, bf16 x) and at the engine's ceiling (8
             prompts of 512).  Times each kernel, its plain version and,
             where one exists, one PyTorch library call computing the same
             function, at the main path's shapes: device time per call
             under ``torch.profiler`` (the median over the calls), the L2
             cache flushed before each call by a read of 8x its size (the
             flush's kernel left out; a call finds no input in L2); kernel
             A also at
             84 and 6250 groups; for the attention kernels also kernel and
             library at the engine's ceiling and at every other head dim,
             for the SSD scan kernel and plain there (printed first), and
             the host microseconds per call of the ``decode_attention``
             dispatcher and of SDPA.  The SSD scan's bound takes its
             operations at the bf16 tensor-core rate (its bf16 instance's
             products run there), with the f32 CUDA-core bound beside it.
3. llm     — canonicalizer-100m at full width (12 layers, d_model 768, 12/4
             heads, head dim 64, d_ff 2048, vocab 8192), weights initialised
             from ``--seed``: (a) teacher forcing on the card, prefill
             logits against ``forward`` (2e-2) and one ``decode_step``
             against ``forward`` over S+1 tokens (3e-2), in float32 and
             bfloat16; (b) the float32 model moved to the CPU (plain
             attention, chosen by the tensors' device) gives the card's
             prefill and decode logits within 1e-3, and the share of
             identical greedy tokens over one generate; (c) 8 SSB NL
             requests, one engine batch, through a ``CacheService`` tenant
             whose NL canonicalizer is
             ``MemoizedNL(CanonicalizerService(engine))`` (bfloat16
             engine): every NLResult keeps the protocol, every served
             table matches the numpy oracle.  The attention kernels'
             launch counts are read from (c) alone.
4. reduced — ``launch.serve --reduced`` on the card: one engine batch of 8
             SSB NL requests through ``serve.llm_canonicalizer(wl,
             "canonicalizer-100m", reduced=True)`` (head dim 16): the
             protocol kept, every table against the oracle, both attention
             kernels launched (counts zeroed before, read after).
5. gemma   — gemma-2b at full width and depth (18 layers, d_model 2048,
             8/1 heads of head dim 256, geglu, tied vocab 256,000), weights
             from ``--seed``: teacher forcing at full depth in float32 and
             bfloat16 (2e-2 prefill, 3e-2 decode), the float32 model's
             first ``GEMMA_CPU_DEPTH`` layers on the CPU against the card
             (1e-3), then 8 token-id prompts prefilled and decoded
             ``GEMMA_STEPS`` greedy steps, one flash launch per layer and
             one decode launch per layer and step.
6. mamba2  — mamba2-780m at full width (48 layers, d_model 1536, d_inner
             3072, 48 SSD heads of 64, state 128, vocab 50280), weights from
             ``--seed``: (a) teacher forcing on the card: float32 at full
             depth, prefill logits against ``forward`` (2e-2) and one
             ``decode_step`` against ``forward`` over S+1 tokens (3e-2);
             bfloat16 prefill at full depth (2e-2) and decode at depth 1
             (3e-2: at random init the bf16 model, JAX's too, amplifies
             rounding layer by layer; ``benchmarks/
             bench_torch_mamba2_drift.py`` reads the drift by depth); (b)
             the float32 model on the CPU (plain SSD scan) against the
             card, prefill and decode logits within 1e-3 at depth 12, and
             the share of identical greedy tokens at full depth; (c) 16 SSB
             NL requests in batches of 8 through a ``CacheService``
             tenant whose NL canonicalizer is ``serve.llm_canonicalizer``'s
             ``MemoizedNL(CanonicalizerService(engine))`` over mamba2-780m
             (bfloat16): the protocol kept, every table against the oracle,
             one ssd_scan launch per layer and engine batch.  The ssd_scan
             launch count is read from (c) alone.
6a. zamba2 — zamba2-7b at full width and depth (81 Mamba2 layers, d_model
             3584, d_inner 7168, 112 SSD heads of 64, state 64; a shared
             attention + geglu MLP block after every 6 layers, 13
             applications, 32/32 heads of head dim 112, d_ff 14,336; vocab
             32,000; ~6.75 B parameters), bf16 weights drawn on the card
             from ``--seed``: (a) ``ssd_scan`` at x (8, 77, 112, 64), N 64,
             ``flash_attn`` at head dim 112 over 32/32 heads (8 prompts of
             77) and ``decode_attn`` there at pos 78 and 512, each checked
             and timed beside its plain version, SDPA and its bound (the
             sweeps of phase 2 also hold these head counts and the SSD scan
             at 8 x {77, 300} x 112 heads); (b) teacher forcing in bf16 at
             the first Mamba layer and the shared block and in f32 at depth
             12 (2e-2 prefill, 3e-2 decode; the bf16 drift at one segment
             of 6 layers and at 81 is printed, not held: the random-init
             bf16 model amplifies rounding), and the f32 model's first 12
             layers on the CPU against the card (1e-3); (c) 16 SSB NL
             requests in 2 engine batches through ``CacheService``: 81
             ``ssd_scan`` and 13 ``flash_attn`` launches per prefill, 13
             ``decode_attn`` per decode step, the protocol kept, every table
             against the oracle; one more batch profiled; the peak memory
             above what was resident before; everything freed after it.
6b. moe    — qwen3-moe-235b-a22b at full width (d_model 4096, 64/4 heads
             of 128 with qk_norm, 128 experts as 16 x 8 of d_ff 1,536, top-8,
             vocab 151,936) and 4 of its 94 layers (~11.2 B parameters, bf16,
             drawn on the card): (a) teacher forcing in bf16 at 4 layers with
             capacity factor 64 (drop-free routing); (b) the f32 model's
             first layer on the CPU against the card at capacity factor 1.25
             (1e-3), the routes dropped for capacity equal on both sides;
             (c) 8 SSB NL requests in one engine batch through
             ``CacheService``: 4 ``flash_attn`` launches per prefill, 4
             ``decode_attn`` per step; one more batch profiled, its device
             time split between the expert products and the routing ops.
             No Pallas kernel computes the MoE layer: it is plain PyTorch.
7. serve   — SSB at ``--n-fact`` rows (SF1's LINEORDER has 6,000,000)
             through ``CacheService`` (``serve.build_tenant``, a one-shard
             cluster cache): the SSB SQL stream, the hierarchical drill
             stream, a 6-tile dashboard refresh (one shared scan) and one
             request whose filter needs the host-mask branch. Every served
             table is checked against the numpy oracle; the seg_agg launch
             counts are read from this phase alone. Prints per-stage p50/p95
             of the request path. Kernel B's launches are recorded by shape
             (N, M, P, K, S, G, op), here and in phases 10-12 (the table
             is printed after phase 12, ``[shapes]``).
8. nl      — the SSB mixed stream (SQL and NL) through a fresh tenant whose
             NL canonicalizer is ``MemoizedNL(SimulatedLLM)``, on the same
             dataset: every served table against the numpy oracle, no false
             hit, at least one NL hit.
9. service — the same dataset through ``register_tenant(..., shards=4)``:
             the SSB SQL and mixed streams interleaved across intents (a
             batch carries several measure families, whose misses run on
             the service's ``shard-miss`` threads at once), the drill
             stream, and a batch of the host-mask request and two
             dashboard tiles (kernels A and B from two shards).  Every
             table against the oracle; kernel A and B calls recorded by
             calling thread and batch: at least one batch with calls from
             two or more ``shard-miss`` threads.  Then four new tiles with
             ``backend.error`` injected once: the retry reaches kernel B
             and the tables equal the oracle's; with the plan cleared,
             nothing is armed and one more batch retries nothing.  Prints
             statuses, request and miss-execute p50/p95, the batches run
             shard-parallel and the wall time.
10. scan    — the scan plane on the same dataset: a fresh tenant over
             ``OlapExecutor(partitions=4, max_device_rows=1 << 20)`` (four
             1,500,000-row partitions, each on a CUDA stream of its own and
             streamed in two chunks, the second staged on another stream)
             serves the SSB SQL stream (its first batch under
             ``torch.profiler``: the staging streams' work that ran while a
             seg_agg kernel ran, from the chrome trace), the drill stream,
             the 6-tile dashboard, the host-mask request (kernel A on each
             chunk) and a ``COUNT(DISTINCT)`` request (the single-partition
             fallback).  Every table against the oracle; ``stats()`` must
             show partitioned scans, streamed chunks and per-partition rows
             that add up to rows x scans; kernel A and B calls recorded by
             thread and stream: at least one batch launched on two or more
             streams from two or more ``scan-part`` threads.  Then four new
             tiles with ``backend.partial`` injected once: the retry
             reaches kernel B and serves the oracle's tables.  Last, the
             dashboard batch's peak device memory above the memory before
             it, streamed and unpartitioned, each on a fresh mirror: the
             streamed peak must be the lower.
11. refresh — incremental refresh on an SSB dataset of its own (appends grow
             it): the SSB SQL stream and the host-mask request, then
             ``advance_snapshot(delta=...)`` with 6,000 new rows of 1998
             (TPC-H's RF1 insert at SF1) drawn from the generator's
             distributions: every kernel A and B launch of the delta scan
             on 6,000 rows (recompute fallbacks on the grown table), at
             least one entry refreshed; the stream again, every table
             against the oracle over the appended dataset.
12. workloads — TPC-DS at SF1's store_sales rows (2,880,404) and NYC TLC at
             January 2023's yellow-taxi trips (3,066,766), each from the
             port's generator: each SQL stream through a tenant at
             ``partitions=1``; then the 63 adversarial NL queries (their
             scores must be Table 2's 28 / 30 / 5) and 150 BIRD-like ones,
             each through one tenant per schema with
             ``MemoizedNL(SimulatedLLM)`` behind the balanced safety policy.
             Every table against the oracle (no false hit); the gate's
             counts printed.  Then ``[shapes]``: at each kernel B shape of
             phases 7 and 10-12, on random inputs, kernel B is checked
             against its plain version, run twice (bit-identical where its
             slots are per thread or warp, and for MIN/MAX everywhere) and
             timed beside its byte bound: the table, with launches by
             phase, and launches x (ms - bound) by phase.
13. train  — the backward of flash_attn (``flash_attn_bwd.cu``, new: no
             Pallas kernel has one; bf16 on the tensor cores), after its
             forward's output is held to ``mha_ref`` (``ATTN_TOL``), held to
             ``mha_bwd_ref`` on the inputs' exact float32 values
             (``BWD_TOL``: float32 1e-3; bfloat16 rtol 1e-2, atol 2e-2), two
             calls bit for bit, at the training shape (q (16,12,192,64), k/v
             (16,4,192,64)) in both dtypes, at head dims 64 and 128 over the
             forward sweep's GQA groups and S, and at every other built head
             dim (``HEAD_DIM_HEADS``), causal and not; then timed at the
             training shape and at ``BWD_MORE``'s (qwen3-moe's 64/4 heads of
             128, zamba2-7b's 32/32 of 112) beside its plain version, the
             backward of SDPA and its bound.  Then reduced kimi-k2-1t-a32b
             (a dense and an MoE layer) trained 2 steps on the card:
             finite losses, one launch of each attention kernel per layer
             per step, a step repeated from the same state bit for bit
             (``moe_train_check``).  Then canonicalizer-100m at full width and depth trained through
             ``train_lib.train`` as examples/train_canonicalizer.py --full
             does (SSB pairs, batch 16, sequence 192, checkpoints every 50
             steps, in a temporary directory): after one step's backward
             every ``wq``, ``wk`` and ``wv`` has a finite gradient and each
             attention kernel launched 12 times; 150 steps, a restart (the
             restored parameters equal the saved ones, ``torch.equal``),
             150 more steps that log "resumed from step 149" and start at
             ``batch_at(150)``; every logged loss finite, the last below the
             first, 12 x 300 launches of each kernel; 3 more steps under
             ``torch.profiler`` (device ms and ops per step), the step wall
             time, the device busy share (device ms per step over the
             unprofiled step's wall) and the peak memory.  Then the newest
             checkpoint restored through ``launch.serve.served_model`` (the
             launcher's restore path and tokenizer) into
             ``ServingEngine(max_len=256)``: examples/train_canonicalizer.py's 8 held-out paraphrases
             (parsed and exact, JSON-constrained and, as a diagnostic, not),
             and the 8 SSB NL questions of phase 3 through ``CacheService``
             (protocol kept, every table against the oracle, 0 false hits).
13a. examples — the five ``repro_torch.examples`` (the JAX package's
             ``examples/*.py`` on the port) through their ``main``, the
             kernel launches counted per run: quickstart,
             dashboard_session, streaming_append (its live backend's delta
             scans through the seg_agg kernels) and multi_pod_dryrun (8
             partitions, each on a CUDA stream of its own) at their
             defaults on the card, each summary equal to its ``--device
             cpu`` run's and at least one seg_agg launch each;
             multi_pod_dryrun and quickstart again at ``--n-fact`` rows,
             every table against the numpy oracle over the examples' data
             (seed 0); the flash backward at the reduced train example's
             shape (q (8,8,128,32), k/v (8,4,128,32), bf16, causal) against
             ``mha_bwd_ref`` (``BWD_TOL``) and timed beside its plain
             version, SDPA's backward and its bound; train_canonicalizer at its
             reduced default (120 steps) and, after a restart from its
             checkpoint in a temporary directory, 20 steps more: losses
             finite, step 119's below step 0's, each run launching
             ``flash_attn``, ``flash_attn_bwd`` and ``decode_attn``.
             Prints each run's summary, wall seconds and launches by kernel.
14. dist   — the distribution (``repro_torch.distributed``) on a one-rank
             NCCL process group, mesh ``build_mesh(plan_remesh(1, 1))``
             (data 1, model 1): canonicalizer-100m trained ``DIST_STEPS``
             steps at [train]'s batches with DTensor parameters and stacked
             ZeRO-1 moments and without DTensor, losses, norms, parameters
             and moments equal bit for bit, ``flash_attn`` and
             ``flash_attn_bwd`` once per layer per step in both (through
             ``local_map``); the same steps under ``ElasticController`` with
             a device loss after step 2 and a restore from its checkpoint,
             final parameters bit for bit; 8 NL prompts' prefill and 8
             greedy decode steps on the mesh (``decode_attn``,
             ``flash_attn``) and mamba2-780m's prefill at 4 layers
             (``ssd_scan`` 4 times), each equal to its plain run bit for
             bit; and ``python -m repro_torch.launch.dryrun`` on mamba2-780m
             decode_32k and gemma-2b train_4k (a fake group of 256 on the
             host's CPU, in processes of their own): ok, argument bytes
             equal to the spec arithmetic.  Wall and device ms per train
             step, DTensor against plain.
15. profile — a fresh dataset and tenant replay the first 64 SSB requests
             under ``torch.profiler`` (device busy share of a cold start, the
             kernels and copies that took the most device time), and again
             under ``cProfile`` (host functions by own time); then one more
             engine batch of 8 NL questions, at most ``PROFILE_STEPS``
             decode steps, under ``torch.profiler``, for each of the two
             engines: device busy share of prefill + decode loop, device ms
             per decode step against host ms per step, and the top device
             ops.

Every phase that goes through ``CacheService`` fails on any failure or
degraded count, any result with ``error`` set, or a status other than a
hit, a miss or a bypass: the service turns a backend exception (a kernel
that fails to launch) into such a result, not into an exception.

The lines of phases 10-14 (13a too) and ``[shapes]`` end with the card's name and
power limit.  The last three lines of standard output are the ``kernels``
JSON line, the card's name and power limit, and ``{"ok": true, "device":
{...}}``.  Exits
non-zero without a result where CUDA is absent, or where the port's sources
are not beside this script.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 (NVIDIA data sheet)
F32_OPS_PER_S = 67e12  # H100 SXM f32 outside the tensor cores
BF16_OPS_PER_S = 989e12  # H100 SXM bf16 dense tensor cores
RTOL = ATOL = 1e-4
# (rtol, atol) of an attention kernel against its plain version evaluated on
# the inputs' exact float32 values (``_f32``): float32 as tests/test_kernels.py;
# a bfloat16 kernel does that float32 arithmetic and rounds once at the output
# (at most 2**-9 relative), and the atol stays far below the 0.02-0.04
# outputs of long rows, where a lost key tile would show
ATTN_TOL = {"float32": (2e-3, 2e-3), "bfloat16": (4e-3, 5e-4)}
NL_BATCH = 8
MAX_NEW_TOKENS = 128  # the decode steps of a CanonicalizerService batch at most
MAX_LEN = 512  # the engine's KV cache slots (prompt + decoded tokens)


def _fail(msg: str) -> int:
    print(f"chip_smoke: {msg}", file=sys.stderr)
    return 2


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def device_ms(fn, iters: int, args=()) -> float:
    """Device milliseconds per call of ``fn(*args)``: the median over
    ``iters`` calls of the summed duration of the kernels and copies
    ``torch.profiler`` traced for each, so the host's gaps between
    launches are not counted.  The L2 cache is flushed before each call,
    and the flush's kernel is left out of the sums
    (``repro_torch.kernels.ablation.device_ms``)."""
    from repro_torch.kernels.ablation import device_ms as flushed_device_ms

    return flushed_device_ms(fn, iters, args)


def abba(kernel, base, iters: int) -> tuple[float, float]:
    """Device ms per call of a kernel and of its baseline, each a (function,
    arguments) pair, timed in turns (baseline, kernel, kernel, baseline) so
    that a drift of the card during the four reads shows in neither mean."""
    b1 = device_ms(base[0], iters, base[1])
    k1 = device_ms(kernel[0], iters, kernel[1])
    k2 = device_ms(kernel[0], iters, kernel[1])
    b2 = device_ms(base[0], iters, base[1])
    return (k1 + k2) / 2, (b1 + b2) / 2


def timed(kernel, plain, library, iters: int) -> dict:
    """Device ms per call of a kernel, its plain version and the library
    call (None where there is none), each a (function, arguments) pair."""
    return {"ms": device_ms(kernel[0], iters, kernel[1]),
            "plain_ms": device_ms(plain[0], max(3, iters // 4), plain[1]),
            "library_ms": None if library is None else device_ms(library[0], iters, library[1])}


def compare(got, want, what: str, rtol: float = RTOL, atol: float = ATOL) -> float:
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
    if g.numel() and not torch.allclose(g, w, rtol=rtol, atol=atol):
        raise AssertionError(f"{what}: max abs err {err} beyond rtol {rtol}, atol {atol}")
    return err


def finite(t, what: str):
    """``t`` unchanged; raises unless every entry is finite (``compare``
    skips NaN positions, so logits are held to this first)."""
    import torch

    if not bool(torch.isfinite(t).all()):
        raise AssertionError(f"{what}: {int((~torch.isfinite(t)).sum())} entries not finite")
    return t


def with_bound(t: dict, ops_per_s: float) -> dict:
    """Adds ``bound_ms`` (the larger of bytes over the HBM rate and
    operations over ``ops_per_s``) and ``bound_by``."""
    by_bytes, by_ops = t["bytes"] / HBM_BYTES_PER_S, t["ops"] / ops_per_s
    t["bound_ms"] = max(by_bytes, by_ops) * 1e3
    t["bound_by"] = "bytes" if by_bytes >= by_ops else "operations"
    return t


# --------------------------------------------------------------- kernels


def _instance(mangled: str) -> str:
    """``flash_attn_bf16_kernel<64>`` from its mangled name: the first
    length-prefixed name ending in ``_kernel`` and its template arguments."""
    import re

    for m in re.finditer(r"(?=(\d\d?)[A-Za-z_])", mangled):  # every 1-2 digit length
        start = m.start() + len(m.group(1))
        name = mangled[start:start + int(m.group(1))]
        rest = mangled[start + len(name):]
        if name.endswith("_kernel") and rest.startswith("I"):
            args = re.match(r"I(.*?)EEv", rest)
            names = [{"13__nv_bfloat16": "bf16", "f": "f32"}.get(a.group(0), a.group(1))
                     for a in re.finditer(r"13__nv_bfloat16|Li(\d+)E?|f",
                                          args.group(1) if args else "")]
            return f"{name}<{','.join(names)}>"
    return mangled


# the kernels whose ptxas and SASS figures [build] prints: the tensor-core
# ones and kernels A and B, one template (instance names start with these)
BUILD_SHOWN = ("flash_attn_", "flash_bwd_", "decode_", "ssd_scan_kernel",
               "seg_agg_tiled_kernel")


def ptxas_info(log: str) -> dict:
    """Registers, spill bytes and static shared memory of each kernel
    instance, as ``ptxas -v`` reported them in a build log."""
    import re

    info: dict = {}
    cur = None
    for line in log.splitlines():
        if m := re.search(r"Compiling entry function '(\w+)'", line):
            cur = info.setdefault(_instance(m.group(1)), {})
        elif cur is not None and (m := re.search(r"(\d+) bytes spill stores, (\d+) bytes "
                                                 r"spill loads", line)):
            cur["spill_bytes"] = int(m.group(1)) + int(m.group(2))
        elif cur is not None and (m := re.search(r"Used (\d+) registers", line)):
            cur["registers"] = int(m.group(1))
            sm = re.search(r"(\d+) bytes smem", line)
            cur["static_smem"] = int(sm.group(1)) if sm else 0
    return info


def build_info(names=("flash_attn", "flash_attn_bwd", "decode_attn", "ssd_scan",
                      "seg_agg")) -> dict:
    """Per kernel instance of each library: registers, spill bytes and
    shared memory as ``ptxas -v`` reported them in the build log, and the
    count of HMMA (tensor-core) instructions in its SASS where
    ``cuobjdump`` is installed (None where it is not).  Fails if a bf16
    flash instance (forward or backward) or an SSD-scan instance has none
    (tf32 products are HMMA too)."""
    import re
    import shutil

    from repro_torch.kernels import build

    info: dict = {}
    for name in names:
        lib = build.library_path(name)
        info.update(ptxas_info(lib.with_suffix(".log").read_text()))
        tool = shutil.which("cuobjdump") or str(Path(build.nvcc()).parent / "cuobjdump")
        if not Path(tool).exists():
            continue
        sass = subprocess.run([tool, "-sass", str(lib)], check=True, capture_output=True,
                              text=True, timeout=120).stdout
        cur = None
        for line in sass.splitlines():
            if m := re.search(r"Function : (\w+)", line):
                cur = info.setdefault(_instance(m.group(1)), {})
                cur["hmma"] = 0
            elif cur is not None and "HMMA" in line:
                cur["hmma"] += 1
    tensor_core = [i for i in info if i.startswith((
        "flash_attn_bf16_kernel", "flash_bwd_dq_bf16_kernel", "flash_bwd_dkdv_bf16_kernel",
        "ssd_scan_kernel"))]
    if len(tensor_core) < 4:
        raise AssertionError(f"no bf16 flash or SSD-scan instance among {sorted(info)}")
    for inst, row in info.items():
        row.setdefault("hmma", None)
        if inst in tensor_core and row["hmma"] == 0:
            raise AssertionError(f"{inst}: no HMMA in its SASS")
    return {i: r for i, r in info.items() if i.startswith(BUILD_SHOWN)}


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
    tiers_a: set = set()

    def check_a(v, ids, mask, g, op, select, what):
        plain = R.seg_agg_masked_ref if select else R.seg_agg_ref
        got = K.seg_agg_cuda(v, ids, mask, g, op, select=select)
        errs["seg_agg"] = max(errs["seg_agg"], compare(got, plain(v, ids, mask, g, op), what))
        tier = K.masked_tier(v.shape[0], v.shape[1], g, op, select)
        tiers_a.add(tier)
        # bit for bit where the slots are per thread (and MIN/MAX everywhere)
        again = K.seg_agg_cuda(v, ids, mask, g, op, select=select)
        same = torch.equal(again.view(torch.int32), got.view(torch.int32))  # NaN bits too
        if not same and (tier in K.DETERMINISTIC or op != "sum"):
            raise AssertionError(f"{what}: two calls differ ({tier} slots)")

    def check_b(v, ids, pred, b, g, op, what):
        got = K.seg_agg_fused_cuda(v, ids, pred, b, g, op)
        want = R.seg_agg_batch_ref(v, ids, pred, b, g, op)
        errs["seg_agg_fused"] = max(errs["seg_agg_fused"], compare(got, want, what))

    # small: NaN values and predicates, sentinel and pad ranges, empty mask;
    # kernel A in each of its tiers (G 5: per thread, 37: per block,
    # 200000: global atomics), both contracts, and ids outside [0, G)
    n, m = 5000, 3
    v = torch.randn(n, m, generator=gen, device=dev)
    v[torch.rand(n, m, generator=gen, device=dev) < 0.02] = float("nan")
    pred = torch.randint(0, 10, (n, 2), generator=gen, device=dev).float()
    pred[torch.rand(n, 2, generator=gen, device=dev) < 0.02] = float("nan")
    mask = (torch.rand(n, generator=gen, device=dev) > 0.3).float()
    empty = torch.zeros(n, device=dev)
    for g in (5, 37, 200_000):
        ids = torch.randint(0, g, (n,), generator=gen, device=dev, dtype=torch.int32)
        for op in ("sum", "min", "max"):
            for select in (True, False):
                check_a(v, ids, mask, g, op, select, f"A small G={g} {op} select={select}")
            check_a(v, ids, empty, g, op, True, f"A small G={g} {op} empty mask")
    # ids outside [0, G) reach no group (the plain version takes ids in range)
    stray = ids.clone()
    stray[::7], stray[1::7] = -3, g + 11
    keep = (stray >= 0) & (stray < g)
    errs["seg_agg"] = max(errs["seg_agg"], compare(
        K.seg_agg_cuda(v, stray, mask, g, "sum"),
        R.seg_agg_masked_ref(v[keep], ids[keep], mask[keep], g, "sum"),
        "A small ids outside [0, G)"))
    g = 37
    ids = torch.randint(0, g, (n,), generator=gen, device=dev, dtype=torch.int32)
    for op in ("sum", "min", "max"):
        check_b(v, ids, pred, _bounds(gen, 6, 2, 4, dev), g, op, f"B small {op}")
        never = torch.tensor([[[[float("inf"), float("-inf")]]] * 2], device=dev)
        check_b(v, ids, pred, never, g, op, f"B small {op} empty mask")

    # main-path shapes: N = n_fact, M 1..5, G 1..2500, P <= 3, S in {1, 6};
    # kernel A also at G 84 and 6250 and under the multiply contract
    for m, g, p, s in ((1, 1, 1, 1), (2, 5, 2, 6), (3, 25, 3, 1), (4, 250, 0, 6),
                       (5, 2500, 1, 6), (2, 84, 1, 1), (2, 6250, 1, 1)):
        v = torch.rand(n_fact, m, generator=gen, device=dev)
        ids = torch.randint(0, g, (n_fact,), generator=gen, device=dev, dtype=torch.int32)
        pred = torch.randint(0, 10, (n_fact, p), generator=gen, device=dev).float()
        mask = (torch.rand(n_fact, generator=gen, device=dev) > 0.5).float()
        b = _bounds(gen, s, p, 2, dev)
        for op in ("sum", "min"):
            check_a(v, ids, mask, g, op, True, f"A N={n_fact} M={m} G={g} {op}")
            check_b(v, ids, pred, b, g, op, f"B N={n_fact} M={m} G={g} P={p} S={s} {op}")
        check_a(v, ids, mask, g, "sum", False, f"A N={n_fact} M={m} G={g} sum multiply")
    if tiers_a != {"thread", "block", "global"}:
        raise AssertionError(f"kernel A checked in tiers {sorted(tiers_a)}")
    torch.cuda.synchronize()
    return errs


class Baseline:
    """The seg_agg and attention kernels of an earlier checkout (``--baseline
    DIR``, whose C entries are kernel A's without scratch, kernel B's with
    its plan, workspace and barrier, and the attention dispatchers as now),
    each source built whole from DIR into ``build/kernels/baseline/``, to
    time this checkout's kernels against in the same run on the same card.
    ``registers`` holds its instances' ptxas figures."""

    NAMES = ("seg_agg", "flash_attn", "decode_attn")

    def __init__(self, root: Path):
        import ctypes

        from repro_torch.kernels import build

        out = build.BUILD_DIR / "baseline"
        jobs = {n: build.Job([(root / "src" / "repro_torch" / "kernels" / n / "csrc" / f"{n}.cu",
                               ())], out / f"lib{n}.so", f"the baseline {n}")
                for n in self.NAMES}
        self.libs, self.registers = {}, {}
        for n, job in jobs.items():
            job.finish()
            self.libs[n] = ctypes.CDLL(str(out / f"lib{n}.so"))
            self.registers.update({k: v for k, v in ptxas_info(
                (out / f"lib{n}.log").read_text()).items() if k.startswith(BUILD_SHOWN)
                or k.startswith("seg_agg_")})
        P, I, L, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
        seg = self.libs["seg_agg"]
        seg.seg_agg_launch.argtypes = [P, P, P, P, L, I, I, I, I, P]
        seg.seg_agg_fused_launch.argtypes = [P, P, P, P, P, L, I, I, I, I, I, I, P, P, P]
        seg.seg_agg_fused_plan.argtypes = [L, I, I, I, I, I, I, ctypes.POINTER(L)]
        self.libs["flash_attn"].flash_attn_launch.argtypes = [P, P, P, P, I, I, I, I, I, I, F,
                                                              I, P]
        self.libs["decode_attn"].decode_attn_launch.argtypes = [P, P, P, P, P, I, I, I, I, I, F,
                                                                I, P, P, P]
        for lib in self.libs.values():
            for fn in ("seg_agg_launch", "seg_agg_fused_launch", "seg_agg_fused_plan",
                       "flash_attn_launch", "decode_attn_launch"):
                if hasattr(lib, fn):
                    getattr(lib, fn).restype = I
        self.bar = None

    @staticmethod
    def _stream(t) -> int:
        import torch

        return torch.cuda.current_stream(t.device).cuda_stream

    @staticmethod
    def _check(rc: int, what: str) -> None:
        if rc:
            raise RuntimeError(f"baseline {what}: CUDA error {rc}")

    def masked(self, values, ids, mask, num_groups: int, op: str, select: bool = True):
        import torch

        n, m = values.shape
        out = torch.empty((num_groups, m), device=values.device)
        self._check(self.libs["seg_agg"].seg_agg_launch(
            values.data_ptr(), ids.data_ptr(), mask.data_ptr(), out.data_ptr(), n, m,
            num_groups, {"sum": 0, "min": 1, "max": 2}[op], int(select),
            self._stream(values)), "seg_agg")
        return out

    def fused(self, values, ids, pred, bounds, num_groups: int, op: str):
        import ctypes

        import torch

        n, m = values.shape
        s, p, k, _ = bounds.shape
        code = {"sum": 0, "min": 1, "max": 2}[op]
        lib = self.libs["seg_agg"]
        work = ctypes.c_longlong(0)
        if lib.seg_agg_fused_plan(n, m, p, k, s, num_groups, code, ctypes.byref(work)) < 0:
            raise RuntimeError("baseline seg_agg_fused plan failed")
        ws = torch.empty(max(work.value, 1), device=values.device)
        if self.bar is None:
            self.bar = torch.zeros(2, dtype=torch.int32, device=values.device)
        out = torch.empty((s, num_groups, m), device=values.device)
        self._check(lib.seg_agg_fused_launch(
            values.data_ptr(), ids.data_ptr(), pred.data_ptr(), bounds.data_ptr(),
            out.data_ptr(), n, m, p, k, s, num_groups, code, self._stream(values),
            ws.data_ptr(), self.bar.data_ptr()), "seg_agg_fused")
        return out

    def flash(self, q, k, v):
        """bf16, causal."""
        import torch

        b, h, s, dh = q.shape
        out = torch.empty_like(q)
        self._check(self.libs["flash_attn"].flash_attn_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, h, k.shape[1], s, dh,
            1, dh ** -0.5, 1, self._stream(q)), "flash_attn")
        return out

    def decode(self, q, k, v, pos):
        """bf16 (no scratch)."""
        import torch

        b, h, dh = q.shape
        out = torch.empty_like(q)
        self._check(self.libs["decode_attn"].decode_attn_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), pos.data_ptr(), out.data_ptr(), b, h,
            k.shape[1], k.shape[2], dh, dh ** -0.5, 1, self._stream(q), None, None),
            "decode_attn")
        return out


def kernel_times(n_fact: int, dev, gen, iters: int, baseline=None) -> dict:
    """Kernel, plain and library times at the main path's shapes: kernel A
    at the host-mask request's (sum block [COUNT, SUM], 5 regions), and in
    ``more`` at 84 and 6250 groups (kernel B's per-block shapes), each with
    its slot tier; kernel B at the dashboard refresh's (sum block [COUNT,
    SUM, AVG], 5 regions, one time-window predicate, 6 tiles).  With a
    baseline, kernel and baseline are timed in turns (``abba``) at each
    shape (``ms``, ``baseline_ms``)."""
    import torch

    from repro_torch.kernels.seg_agg import kernel as K
    from repro_torch.kernels.seg_agg import ref as R

    def kernel_a(g: int) -> dict:
        n, m = n_fact, 2
        v = torch.rand(n, m, generator=gen, device=dev)
        ids = torch.randint(0, g, (n,), generator=gen, device=dev, dtype=torch.int32)
        mask = (torch.rand(n, generator=gen, device=dev) > 0.5).float()
        pre = torch.where(mask[:, None] > 0.5, v, torch.zeros((), device=dev))
        call = (lambda v, i, mk: K.seg_agg_cuda(v, i, mk, g, "sum"), (v, ids, mask))
        t = {
            **timed(call,
                    (lambda v, i, mk: R.seg_agg_masked_ref(v, i, mk, g, "sum"), (v, ids, mask)),
                    (lambda x, i: torch.zeros(g, m, device=dev).index_add_(0, i, x),
                     (pre, ids.long())), iters),
            "bytes": n * (m + 2) * 4 + g * m * 4, "ops": n * m,
            "tier": K.masked_tier(n, m, g, "sum"),
            "shape": f"values ({n},{m}) ids ({n},) mask ({n},) G={g} sum",
        }
        if baseline is not None:
            t["ms"], t["baseline_ms"] = abba(
                call, (lambda v, i, mk: baseline.masked(v, i, mk, g, "sum"), (v, ids, mask)),
                iters)
        return with_bound(t, F32_OPS_PER_S)

    out = {"seg_agg": kernel_a(5)}
    out["seg_agg"]["more"] = [kernel_a(g) for g in (84, 6250)]
    n, m, g, p, s = n_fact, 3, 5, 1, 6
    v = torch.rand(n, m, generator=gen, device=dev)
    ids = torch.randint(0, g, (n,), generator=gen, device=dev, dtype=torch.int32)
    pred = torch.randint(8000, 10600, (n, p), generator=gen, device=dev).float()
    b = torch.tensor([[[[8035.0 + 365 * i, 8035.0 + 365 * i + 364]]] for i in range(s)],
                     device=dev)
    byts = n * (m + 1 + p) * 4 + s * g * m * 4 + b.numel() * 4
    call = (lambda v, i, pr: K.seg_agg_fused_cuda(v, i, pr, b, g, "sum"), (v, ids, pred))
    out["seg_agg_fused"] = {
        **timed(call,
                (lambda v, i, pr: R.seg_agg_batch_ref(v, i, pr, b, g, "sum"), (v, ids, pred)),
                None, iters),
        "bytes": byts, "ops": n * p * s * 2 + n * m * s,
        "shape": f"values ({n},{m}) ids ({n},) pred ({n},{p}) bounds {tuple(b.shape)} G={g} sum",
    }
    if baseline is not None:
        out["seg_agg_fused"]["ms"], out["seg_agg_fused"]["baseline_ms"] = abba(
            call, (lambda v, i, pr: baseline.fused(v, i, pr, b, g, "sum"), (v, ids, pred)),
            iters)
    out["seg_agg_fused"] = with_bound(out["seg_agg_fused"], F32_OPS_PER_S)
    return out


def _f32(*tensors):
    """The tensors' exact values in float32.  The plain attention versions
    run on these: in bfloat16 ``decode_attention_ref`` repeats the JAX
    oracle's casts (scaled q and p rounded to bfloat16), which the kernels,
    like the Pallas ones, do not make."""
    return tuple(t.float() for t in tensors)


# (Dh, H, Hkv) at which each head dim past 64 and 128 is checked and timed:
# the reduced configs' dim 16 at 4/2 heads, the reference's kernel tests' 32
# at 8/1, kimi-k2's 112 at 64/8 and zamba2-7b's at 32/32 (group 1: one live
# row in the bf16 decode's 16-row tile), nemotron-4-340b's 192 at 96/8 and
# gemma-2b's 256 at 8/1
ZAMBA2_HEADS = (112, 32, 32)
HEAD_DIM_HEADS = ((16, 4, 2), (32, 8, 1), (112, 64, 8), ZAMBA2_HEADS, (192, 96, 8),
                  (256, 8, 1))


def _decode_is_the_prefill_row(q, k, v, got, what: str) -> None:
    """A bf16 decode step over the S cached keys equals the prefill's last
    row bit for bit."""
    import torch

    from repro_torch.kernels.decode_attn import kernel as DK

    pos = torch.full((q.shape[0],), q.shape[2], dtype=torch.int32, device=q.device)
    if not torch.equal(DK.decode_attention_cuda(q[:, :, -1].contiguous(), k, v, pos),
                       got[:, :, -1]):
        raise AssertionError(f"{what}: a decode step differs from the prefill's last row")


def _decode_sweep(b_pos, h, hkv, s, dh, dtype, dev, gen, what: str) -> float:
    """The decode kernel at ``b_pos`` (one row each) over an S-slot cache
    against its plain version; two calls bit-identical; slots past pos
    overwritten (999 keys, NaN values) change nothing."""
    import torch

    from repro_torch.kernels.decode_attn import kernel as DK
    from repro_torch.kernels.decode_attn import ref as DR

    pos = torch.tensor(b_pos, dtype=torch.int32, device=dev)
    q = torch.randn(len(pos), h, dh, generator=gen, device=dev).to(dtype)
    k, v = (torch.randn(len(pos), hkv, s, dh, generator=gen, device=dev).to(dtype)
            for _ in range(2))
    got = DK.decode_attention_cuda(q, k, v, pos)
    err = compare(got, DR.decode_attention_ref(*_f32(q, k, v), pos), what,
                  *ATTN_TOL[str(dtype).removeprefix("torch.")])
    if not torch.equal(DK.decode_attention_cuda(q, k, v, pos), got):
        raise AssertionError(f"{what}: two calls differ")
    for i, p in enumerate(pos.tolist()):
        k[i, :, p:], v[i, :, p:] = 999.0, float("nan")
    if not torch.equal(DK.decode_attention_cuda(q, k, v, pos), got):
        raise AssertionError(f"{what}: slots past pos changed the output")
    return err


def attention_checks(dev, gen) -> dict:
    """Max abs error of each attention kernel against its plain version over
    the sweeps, by kernel and dtype: head dims 64 and 128 over GQA groups
    and tile edges, then every other head dim the kernels are built for at
    the head counts of ``HEAD_DIM_HEADS``."""
    import torch

    from repro_torch.kernels.decode_attn import kernel as DK
    from repro_torch.kernels.flash_attn import kernel as FK
    from repro_torch.kernels.flash_attn import ref as FR

    errs = {k: {"float32": 0.0, "bfloat16": 0.0} for k in ("flash_attn", "decode_attn")}
    c = DK.CHUNK

    def flash(b, h, hkv, s, dh, dtype, causal, what):
        q = torch.randn(b, h, s, dh, generator=gen, device=dev).to(dtype)
        k, v = (torch.randn(b, hkv, s, dh, generator=gen, device=dev).to(dtype)
                for _ in range(2))
        name = str(dtype).removeprefix("torch.")
        got = FK.flash_attention_cuda(q, k, v, causal=causal)
        err = compare(got, FR.mha_ref(*_f32(q, k, v), causal=causal), what, *ATTN_TOL[name])
        errs["flash_attn"][name] = max(errs["flash_attn"][name], err)
        if dtype == torch.bfloat16 and causal:  # a decode step is the prefill's row
            _decode_is_the_prefill_row(q, k, v, got, what)

    def decode(b_pos, h, hkv, s, dh, dtype, what):
        name = str(dtype).removeprefix("torch.")
        errs["decode_attn"][name] = max(errs["decode_attn"][name], _decode_sweep(
            b_pos, h, hkv, s, dh, dtype, dev, gen, what))

    for dtype in (torch.float32, torch.bfloat16):
        for dh in (64, 128):
            for g in (1, 2, 3, 4, 8):
                hkv = 2
                for s in (1, 2, 63, 64, 65, 77, 96, 129, 512, 1000):
                    for causal in (False, True):
                        flash(2, hkv * g, hkv, s, dh, dtype, causal,
                              f"flash {dtype} dh={dh} G={g} S={s} causal={causal}")
                for s in (512, 4096):
                    # chunk edges and the engine's pos, mixed in one batch
                    decode([1, c - 1, c, c + 1, 77, 511, s], hkv * g, hkv, s, dh, dtype,
                           f"decode {dtype} dh={dh} G={g} S={s}")
        for dh, h, hkv in HEAD_DIM_HEADS:
            for s in (1, 63, 64, 65, 129, 512):
                for causal in (False, True):
                    flash(1 if h > 16 else 2, h, hkv, s, dh, dtype, causal,
                          f"flash {dtype} dh={dh} H={h}/{hkv} S={s} causal={causal}")
            decode([1, c - 1, c, c + 1, 77, 511, 512], h, hkv, 512, dh, dtype,
                   f"decode {dtype} dh={dh} H={h}/{hkv} S=512")
    torch.cuda.synchronize()
    return errs


def _flash_work(b: int, h: int, hkv: int, s: int, dh: int) -> dict:
    """Bytes and operations one causal bf16 prefill call needs: q, K, V read
    once and the output written once; both products over the valid
    (causal) keys."""
    return {"bytes": 2 * (2 * b * h * s * dh + 2 * b * hkv * s * dh),
            "ops": 4 * b * h * (s * (s + 1) // 2) * dh}


def _decode_work(b: int, h: int, hkv: int, n: int, dh: int) -> dict:
    """Bytes and operations one bf16 decode call over ``n`` valid slots
    needs: q and the output once, the first n keys and values once, pos."""
    return {"bytes": 2 * (2 * b * h * dh + 2 * b * hkv * n * dh) + 4 * b,
            "ops": 4 * b * h * n * dh}


def host_us(fn, calls: int = 1000) -> float:
    """Host microseconds per call: the wall time of enqueueing ``calls``
    calls back to back, before the closing synchronize."""
    import torch

    for _ in range(20):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    took = time.perf_counter() - t0
    torch.cuda.synchronize()
    return took / calls * 1e6


def _sdpa_prefill(q, k, v):
    import torch.nn.functional as F

    return F.scaled_dot_product_attention(q, k, v, is_causal=True, enable_gqa=True)


def _sdpa_decode(q4, k, v, mask):
    import torch.nn.functional as F

    return F.scaled_dot_product_attention(q4, k, v, attn_mask=mask, enable_gqa=True)


def _flash_at(dev, gen, b, h, hkv, s, dh, iters: int) -> tuple[dict, tuple]:
    """The bf16 prefill kernel at (B, H, Hkv, S, Dh), causal: checked
    against its plain version, kernel and SDPA timed, with its bound; and
    the inputs."""
    import torch

    from repro_torch.kernels.flash_attn import kernel as FK
    from repro_torch.kernels.flash_attn import ref as FR

    bf = torch.bfloat16
    q = torch.randn(b, h, s, dh, generator=gen, device=dev).to(bf)
    k, v = (torch.randn(b, hkv, s, dh, generator=gen, device=dev).to(bf) for _ in range(2))
    shape = f"q ({b},{h},{s},{dh}) k/v ({b},{hkv},{s},{dh}) bf16 causal"
    err = compare(FK.flash_attention_cuda(q, k, v), FR.mha_ref(*_f32(q, k, v)),
                  f"flash {shape}", *ATTN_TOL["bfloat16"])
    return with_bound({
        "shape": shape, "max_abs_err": err,
        "ms": device_ms(FK.flash_attention_cuda, iters, (q, k, v)),
        "library_ms": device_ms(_sdpa_prefill, iters, (q, k, v)),
        **_flash_work(b, h, hkv, s, dh)}, BF16_OPS_PER_S), (q, k, v)


def _decode_inputs(dev, gen, b, h, hkv, cache, dh, n):
    """bf16 q (B, H, Dh), a ``cache``-slot K/V cache, pos = n for every row
    and the boolean mask SDPA takes for it."""
    import torch

    bf = torch.bfloat16
    q = torch.randn(b, h, dh, generator=gen, device=dev).to(bf)
    k, v = (torch.randn(b, hkv, cache, dh, generator=gen, device=dev).to(bf)
            for _ in range(2))
    pos = torch.full((b,), n, dtype=torch.int32, device=dev)
    mask = (torch.arange(cache, device=dev) < pos[:, None])[:, None, None, :]
    return q, k, v, pos, mask


def _decode_at(dev, gen, b, h, hkv, cache, dh, n, iters: int) -> dict:
    """The bf16 decode kernel at pos n of a ``cache``-slot cache: checked,
    kernel and SDPA timed, with its bound."""
    from repro_torch.kernels.decode_attn import kernel as DK
    from repro_torch.kernels.decode_attn import ref as DR

    q, k, v, pos, mask = _decode_inputs(dev, gen, b, h, hkv, cache, dh, n)
    shape = f"q ({b},{h},{dh}) cache ({b},{hkv},{cache},{dh}) pos={n} bf16"
    err = compare(DK.decode_attention_cuda(q, k, v, pos),
                  DR.decode_attention_ref(*_f32(q, k, v), pos), f"decode {shape}",
                  *ATTN_TOL["bfloat16"])
    return with_bound({
        "shape": shape, "max_abs_err": err,
        "ms": device_ms(DK.decode_attention_cuda, iters, (q, k, v, pos)),
        "library_ms": device_ms(_sdpa_decode, iters, (q[:, :, None, :], k, v, mask)),
        **_decode_work(b, h, hkv, n, dh)}, BF16_OPS_PER_S)


def attention_times(dev, gen, plen: int, steps: int, cache: int, iters: int,
                    baseline=None) -> dict:
    """Each attention kernel against its plain version, then kernel, plain
    and library times, at the serving engine's shapes: canonicalizer-100m
    (12 heads over 4 KV heads, head dim 64), a batch of 8 prompts padded to
    ``plen`` tokens in bfloat16; decode over a ``cache``-slot cache, checked
    at the first, a middle and the last of ``steps`` decode steps (the kernel
    attends over pos = plen + 1 .. plen + steps keys) and timed at the
    first.  Each entry's ``reach`` holds the kernel and library times at the
    engine's ceiling, 8 prompts of ``cache`` tokens and decode at pos =
    ``cache``, also checked.  ``max_abs_err`` of each entry is the largest
    of its checks; the decode entry's ``host_us`` is the host time per call
    of the dispatcher ``decode_attention`` and of the SDPA call.  With a
    baseline, kernel and baseline are timed in turns at the main path's
    shapes (``ms``, ``baseline_ms``)."""
    from repro_torch.kernels.decode_attn import kernel as DK
    from repro_torch.kernels.decode_attn import ref as DR
    from repro_torch.kernels.decode_attn.ops import decode_attention
    from repro_torch.kernels.flash_attn import ref as FR

    b, h, hkv, dh = 8, 12, 4, 64
    flash, inputs = _flash_at(dev, gen, b, h, hkv, plen, dh, iters)
    reach, _ = _flash_at(dev, gen, b, h, hkv, cache, dh, iters)
    flash["plain_ms"] = device_ms(FR.mha_ref, max(3, iters // 4), inputs)
    flash["max_abs_err"] = max(flash["max_abs_err"], reach["max_abs_err"])
    out = {"flash_attn": {**flash, "reach": reach}}

    q, k, v, pos, mask = _decode_inputs(dev, gen, b, h, hkv, cache, dh, plen + 1)
    err = 0.0
    for n in sorted({plen + 1, plen + (steps + 1) // 2, plen + steps, cache}):
        pn = pos.clone().fill_(n)
        err = max(err, compare(DK.decode_attention_cuda(q, k, v, pn),
                               DR.decode_attention_ref(*_f32(q, k, v), pn),
                               f"decode main path pos={n}", *ATTN_TOL["bfloat16"]))
    q4 = q[:, :, None, :]
    out["decode_attn"] = with_bound({
        "max_abs_err": err,
        **timed((DK.decode_attention_cuda, (q, k, v, pos)),
                (DR.decode_attention_ref, (q, k, v, pos)), (_sdpa_decode, (q4, k, v, mask)),
                iters),
        **_decode_work(b, h, hkv, plen + 1, dh),
        "shape": f"q ({b},{h},{dh}) cache ({b},{hkv},{cache},{dh}) pos={plen + 1} bf16",
        "host_us": {"decode_attention": host_us(lambda: decode_attention(q, k, v, pos)),
                    "sdpa": host_us(lambda: _sdpa_decode(q4, k, v, mask))},
    }, BF16_OPS_PER_S)
    out["decode_attn"]["reach"] = _decode_at(dev, gen, b, h, hkv, cache, dh, cache, iters)
    if baseline is not None:
        from repro_torch.kernels.flash_attn import kernel as FK

        for name, call, base in (
                ("flash_attn", (FK.flash_attention_cuda, inputs), (baseline.flash, inputs)),
                ("decode_attn", (DK.decode_attention_cuda, (q, k, v, pos)),
                 (baseline.decode, (q, k, v, pos)))):
            out[name]["ms"], out[name]["baseline_ms"] = abba(call, base, iters)
    return out


def head_dim_times(dev, gen, plen: int, cache: int, iters: int) -> list[dict]:
    """Both attention kernels at every head dim of ``HEAD_DIM_HEADS``, bf16:
    prefill of 8 prompts of ``plen`` tokens and decode at pos = ``cache`` of
    a ``cache``-slot cache, each checked and timed beside SDPA and its
    bound."""
    rows = []
    for dh, h, hkv in HEAD_DIM_HEADS:
        rows.append({"kernel": "flash_attn", "head_dim": dh,
                     **_flash_at(dev, gen, 8, h, hkv, plen, dh, iters)[0]})
        rows.append({"kernel": "decode_attn", "head_dim": dh,
                     **_decode_at(dev, gen, 8, h, hkv, cache, dh, cache, iters)})
    return rows


# (rtol, atol) of the SSD scan against its plain version on the inputs' exact
# float32 values.  float32: tighter than tests/test_kernels.py's 5e-3 (chunks
# of 32 against the sequential scan change only the order of f32 sums; on an
# H100 the sweep's largest error reads 0.004, on outputs in the hundreds).
# bfloat16 y: one output rounding more (at most 2**-8 relative); the state is
# float32 in both.
SSD_TOL = {"float32": (1e-3, 1e-3), "bfloat16": (4e-3, 1e-3)}
ZAMBA2_SSD = (8, 112, 64, 64)  # (B, H, P, N) of zamba2-7b's SSD scan in an engine batch


def _ssd_inputs(gen, dev, b, s, h, p, n, dtype, dt_hi):
    """dt in [0.001, 0.001 + dt_hi): 0.1 as tests/test_kernels.py, 2.0 as
    large as mamba2's init gives; A in (-8, -1) as mamba2's a_log."""
    import torch

    x = torch.randn(b, s, h, p, generator=gen, device=dev).to(dtype)
    dt = 0.001 + torch.rand(b, s, h, generator=gen, device=dev) * dt_hi
    A = -1.0 - 7.0 * torch.rand(h, generator=gen, device=dev)
    Bm, Cm = (torch.randn(b, s, n, generator=gen, device=dev) for _ in range(2))
    return x, dt, A, Bm, Cm


def _ssd_check(x, dt, A, Bm, Cm, what: str) -> float:
    """The kernel with and without the final state against the plain
    version; returns the max abs error of y and the state."""
    import torch

    from repro_torch.kernels.ssd_scan import kernel as SK
    from repro_torch.kernels.ssd_scan import ref as SR

    y, state = SK.ssd_scan_cuda(x, dt, A, Bm, Cm, return_state=True)
    if not torch.equal(SK.ssd_scan_cuda(x, dt, A, Bm, Cm), y):
        raise AssertionError(f"{what}: y differs with and without the state")
    # the sequential scan at every S: the one-pass ssd_final_state weighs
    # step t by exp(cum_S - cum_t) over the whole sequence, which float32
    # resolves to ~1e-3 relative at S = 4096 and dt up to 2 (past this
    # tolerance against float64: benchmarks/bench_torch_ssd_precision.py)
    want_y, want_state = SR.ssd_ref(x.float(), dt, A, Bm, Cm)
    name = str(x.dtype).removeprefix("torch.")
    return max(compare(finite(y, what), want_y, f"{what} y", *SSD_TOL[name]),
               compare(finite(state, what), want_state, f"{what} state",
                       *SSD_TOL["float32"]))


def ssd_checks(dev, gen) -> dict:
    """Max abs error of the SSD-scan kernel against its plain version over
    the sweep, by dtype, and the check that nothing past S is read."""
    import torch

    from repro_torch.kernels.ssd_scan import kernel as SK

    errs = {"float32": 0.0, "bfloat16": 0.0}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).removeprefix("torch.")
        for s in (1, 77, 128, 300, 4096):
            for n, p, h in ((16, 16, 1), (64, 64, 3), (128, 64, 48), (128, 16, 3)):
                for dt_hi in (0.1, 2.0):
                    b = 1 if s == 4096 else 2
                    args = _ssd_inputs(gen, dev, b, s, h, p, n, dtype, dt_hi)
                    what = f"ssd {name} S={s} N={n} P={p} H={h} dt<{dt_hi}"
                    errs[name] = max(errs[name], _ssd_check(*args, what))
        # zamba2-7b's prefill: 8 prompts, 112 heads of P 64 over N 64 (the
        # kernel blocks heads in groups of 3: the last group holds one head)
        b, h, p, n = ZAMBA2_SSD
        for s in (77, 300):
            for dt_hi in (0.1, 2.0):
                args = _ssd_inputs(gen, dev, b, s, h, p, n, dtype, dt_hi)
                errs[name] = max(errs[name], _ssd_check(
                    *args, f"ssd {name} zamba2 x ({b},{s},{h},{p}) N={n} dt<{dt_hi}"))
    # with B = 1 a prefix of S rows is contiguous: NaN in the storage past S
    s = 77
    x, dt, A, Bm, Cm = _ssd_inputs(gen, dev, 1, 128, 48, 64, 128, torch.bfloat16, 2.0)
    exact = [t[:, :s].clone() for t in (x, dt, Bm, Cm)]
    for t in (x, dt, Bm, Cm):
        t[:, s:] = float("nan")
    got = SK.ssd_scan_cuda(x[:, :s], dt[:, :s], A, Bm[:, :s], Cm[:, :s], return_state=True)
    want = SK.ssd_scan_cuda(exact[0], exact[1], A, exact[2], exact[3], return_state=True)
    if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
        raise AssertionError("ssd: NaN past S changed the output")
    torch.cuda.synchronize()
    return errs


def ssd_ops(b: int, s: int, h: int, p: int, n: int, chunk: int = 128) -> int:
    """Operations the scan with its final state needs (a multiply-add is
    2): the fewer of two exact forms.  Chunked at the Pallas chunk: C Bᵀ
    once per batch row (B and C are shared by the heads) and, per head, the
    masked product with x, both over the causal half only; C against the
    carried state from the second chunk on (the first starts from zero);
    and each chunk's state update.  Or the sequential recurrence, 4 N P per
    step and head."""
    chunked = 0
    for start in range(0, s, chunk):
        l = min(chunk, s - start)
        tri = l * (l + 1)  # 2 x the l (l + 1) / 2 entries with s <= t
        carried = 2 * l * n * p if start else 0
        chunked += b * tri * n + b * h * (tri * p + carried + 2 * l * n * p)
    return min(chunked, 4 * b * h * s * n * p)


def ssd_times(dev, gen, plen: int, cache: int, iters: int) -> dict:
    """The SSD-scan kernel against its plain version, then kernel and plain
    times, at the main path's shapes: mamba2-780m's prefill of the first
    engine batch (8 prompts padded to ``plen`` tokens, 48 heads, P 64, N
    128, bf16 x, the final state written), dt as large as its init gives;
    ``reach`` holds the same at the engine's ceiling, 8 prompts of
    ``cache`` tokens.  The bound takes the operations at the bf16 tensor
    cores' rate, where the bf16 kernel runs its products; ``bound_f32_ms``
    keeps PR 13-14's bound at the f32 CUDA-core rate beside it."""
    rows = {}
    for s in (plen, cache):
        t = _ssd_at(dev, gen, 8, s, 48, 64, 128, iters)
        t["bound_f32_ms"] = max(t["bytes"] / HBM_BYTES_PER_S, t["ops"] / F32_OPS_PER_S) * 1e3
        rows[s] = t
    main = rows[plen]
    main["reach"] = rows[cache]
    main["max_abs_err"] = max(main["max_abs_err"], rows[cache]["max_abs_err"])
    return {"ssd_scan": main}


def _ssd_at(dev, gen, b, s, h, p, n, iters: int) -> dict:
    """The SSD-scan kernel at x (B, S, H, P) bf16 over state N, dt as large
    as the Mamba2 init gives, the final state written: checked, kernel and
    plain timed, with its bound at the bf16 tensor-core rate."""
    import torch

    from repro_torch.kernels.ssd_scan import kernel as SK
    from repro_torch.kernels.ssd_scan import ref as SR

    x, dt, A, Bm, Cm = _ssd_inputs(gen, dev, b, s, h, p, n, torch.bfloat16, 2.0)
    shape = f"x ({b},{s},{h},{p}) bf16 dt ({b},{s},{h}) B/C ({b},{s},{n}), state out"
    return with_bound({
        "shape": shape, "max_abs_err": _ssd_check(x, dt, A, Bm, Cm, f"ssd {shape}"),
        **timed((lambda *a: SK.ssd_scan_cuda(*a, return_state=True), (x, dt, A, Bm, Cm)),
                (lambda x, dt, A, Bm, Cm: (SR.ssd_chunked(x, dt, A, Bm, Cm),
                                           SR.ssd_final_state(x, dt, A, Bm)),
                 (x, dt, A, Bm, Cm)), None, iters),
        "bytes": 2 * 2 * b * s * h * p + 4 * (b * s * h + h + 2 * b * s * n + b * h * p * n),
        "ops": ssd_ops(b, s, h, p, n)}, BF16_OPS_PER_S)


def zamba2_times(dev, gen, plen: int, cache: int, iters: int) -> list[dict]:
    """The kernels at the launch shapes zamba2-7b's engine gives them, each
    checked and timed beside its plain version, SDPA where it applies, and
    its bound: ``ssd_scan`` over the first engine batch (8 prompts padded to
    ``plen``, 112 heads of P 64, N 64), ``flash_attn`` at head dim 112 over
    32/32 heads for the same prompts, ``decode_attn`` at pos ``plen`` + 1
    (the first decode step) and ``cache`` of a ``cache``-slot cache."""
    from repro_torch.kernels.decode_attn import ref as DR
    from repro_torch.kernels.flash_attn import ref as FR

    dh, h, hkv = ZAMBA2_HEADS
    b = NL_BATCH
    flash, inputs = _flash_at(dev, gen, b, h, hkv, plen, dh, iters)
    flash["plain_ms"] = device_ms(FR.mha_ref, max(3, iters // 4), inputs)
    rows = [{"kernel": "ssd_scan", **_ssd_at(dev, gen, b, plen, *ZAMBA2_SSD[1:], iters)},
            {"kernel": "flash_attn", **flash}]
    for n in (plen + 1, cache):
        row = _decode_at(dev, gen, b, h, hkv, cache, dh, n, iters)
        q, k, v, pos, _ = _decode_inputs(dev, gen, b, h, hkv, cache, dh, n)
        row["plain_ms"] = device_ms(DR.decode_attention_ref, max(3, iters // 4), (q, k, v, pos))
        rows.append({"kernel": "decode_attn", **row})
    return rows


def fused_shape_table(phases: dict, dev, gen, iters: int, baseline=None) -> list[dict]:
    """Kernel B at every shape a phase launched it at (``phases``: phase ->
    Counter of (N, M, P, K, S, G, op) -> launches), on random inputs of that
    shape: checked against its plain version, two calls compared bit for
    bit (they must be identical where the slots are per thread or warp, and
    for MIN/MAX everywhere), its device ms (and the baseline's, in turns),
    the L2 cache flushed before each call, and its byte bound N (M+1+P) 4 +
    S G M 4 + bounds over the HBM rate."""
    import collections

    import torch

    from repro_torch.kernels.seg_agg import kernel as K
    from repro_torch.kernels.seg_agg import ref as R

    counts: collections.Counter = collections.Counter()
    for c in phases.values():
        counts.update(c)
    table = []
    for shape, launches in sorted(counts.items(), key=lambda kv: -kv[1]):
        n, m, p, k, s, g, op = shape
        v = torch.rand(n, m, generator=gen, device=dev)
        ids = torch.randint(0, g, (n,), generator=gen, device=dev, dtype=torch.int32)
        pred = torch.randint(0, 10, (n, p), generator=gen, device=dev).float()
        b = _bounds(gen, s, p, k, dev)
        what = f"fused shape N={n} M={m} P={p} K={k} S={s} G={g} {op}"
        got = K.seg_agg_fused_cuda(v, ids, pred, b, g, op)
        err = compare(got, R.seg_agg_batch_ref(v, ids, pred, b, g, op), what)
        tier = K.fused_tier(n, m, p, k, s, g, op)
        same = torch.equal(K.seg_agg_fused_cuda(v, ids, pred, b, g, op), got)
        if not same and (tier in K.DETERMINISTIC or op != "sum"):
            raise AssertionError(f"{what}: two calls differ ({tier} slots)")
        row = {"shape": [n, m, p, k, s, g, op], "launches": launches,
               "by_phase": {ph: cnt[shape] for ph, cnt in phases.items() if cnt[shape]},
               "tier": tier,
               "bit_identical": same, "max_abs_err": err,
               "bound_ms": (n * (m + 1 + p) + s * g * m + b.numel()) * 4 / HBM_BYTES_PER_S * 1e3}
        call = (lambda v, i, pr: K.seg_agg_fused_cuda(v, i, pr, b, g, op), (v, ids, pred))
        if baseline is None:
            row["ms"] = device_ms(*call[:1], iters, call[1])
        else:
            row["ms"], row["baseline_ms"] = abba(
                call, (lambda v, i, pr: baseline.fused(v, i, pr, b, g, op), (v, ids, pred)), iters)
        table.append(row)
    return table


# ---------------------------------------------------------------- oracle


class Oracle:
    """Every served table against the numpy oracle, memoized by signature
    key across phases (they share one dataset)."""

    def __init__(self, wl):
        from repro_torch.olap.executor import OlapExecutor

        self.executor = OlapExecutor(wl.dataset, impl="numpy")
        self.truth: dict[str, object] = {}

    def check(self, results) -> dict:
        false_hits = wrong = checked = 0
        for r in results:
            if r.table is None:
                if r.status != "bypass" or any(p.startswith("execute:")
                                               for p in r.provenance):
                    raise AssertionError(f"no table for {r.status}: {r.provenance}")
                continue  # a bypass that executes nothing serves nothing
            if r.signature is None:
                raise AssertionError(f"a table without a signature: {r.provenance}")
            checked += 1
            if not r.table.equals(self.truth_of(r.signature),
                                  ordered=bool(r.signature.order_by)):
                if r.hit:
                    false_hits += 1
                else:
                    wrong += 1
        if false_hits or wrong:
            raise AssertionError(f"{false_hits} false hits, {wrong} wrong tables")
        return {"tables_checked": checked, "false_hits": false_hits}

    def truth_of(self, sig):
        """The oracle's table for ``sig``, memoized by its key."""
        key = sig.key()
        if key not in self.truth:
            self.truth[key] = self.executor.execute(sig)
        return self.truth[key]


def _statuses(results) -> dict:
    return dict(sorted({s: sum(r.status == s for r in results)
                        for s in {r.status for r in results}}.items()))


SERVED = {"hit_exact", "hit_rollup", "hit_filterdown", "hit_compose", "miss", "bypass"}


def uncontained(tenant, results, what: str) -> None:
    """Raise on anything the service's containment boundary turned into a
    result: a failure or degraded count, a result carrying an error, a
    status other than a hit, a miss or a bypass.  A kernel that fails to
    launch on the card would show here, not as an exception."""
    errors = [r for r in results if r.error is not None or r.status not in SERVED]
    if tenant.stats.failures or tenant.stats.degraded or errors:
        first = errors[0] if errors else None
        raise AssertionError(
            f"{what}: {tenant.stats.failures} failures, {tenant.stats.degraded} "
            f"degraded, {len(errors)} results with an error or another status; first: "
            f"{None if first is None else (first.status, first.error, first.provenance)}")


# ----------------------------------------------------------------- llm


def _nl_texts(wl, n: int, skip: int = 0) -> list[str]:
    return list(dict.fromkeys(q.text for q in wl.queries() if q.kind == "nl"))[skip:skip + n]


def _prompt_len(tok, texts, max_len: int = 512) -> int:
    """Padded prompt length of one engine batch (CanonicalizerService's
    prompts, truncated as ServingEngine.generate truncates them)."""
    return max(len(tok.encode(f"question: {t}\nsignature: ", add_bos=True)[-max_len // 2:])
               for t in texts)


def _nl_batch(nl, wl, oracle, texts) -> dict:
    """``texts`` in engine batches of 8 through a ``CacheService`` tenant
    whose NL canonicalizer is ``nl``, a ``MemoizedNL(CanonicalizerService(engine))``,
    the launch counts zeroed just before and read just after: every
    NLResult keeps the protocol (signature None iff error set), every
    served table matches the oracle, and the model launched its kernels
    once per layer and engine batch (dense and MoE: ``flash_attn``;
    Mamba2: ``ssd_scan`` and no attention; Zamba2: ``ssd_scan`` per Mamba
    layer and ``flash_attn`` per application of the shared block) and
    ``decode_attn`` once per attention layer (application) and decode
    step."""
    import torch

    from repro_torch.kernels.binding import launch_counts, reset_launch_counts
    from repro_torch.launch import serve
    from repro_torch.service import CacheService, QueryRequest
    from repro_torch.training.tokenizer import build_tokenizer

    engine = nl.inner.engine
    cfg = engine.cfg
    svc = CacheService()
    tenant = serve.build_tenant(svc, wl, device="cuda", nl=nl)
    torch.cuda.synchronize()
    steps0, host0, model0 = engine.steps, engine.host_s, engine.model_s
    reset_launch_counts()
    t0 = time.perf_counter()
    results = serve.replay(svc, [QueryRequest(nl=t, tenant=serve.TENANT) for t in texts],
                           batch=NL_BATCH)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = launch_counts()
    uncontained(tenant, results, f"{cfg.name} NL requests")
    steps = engine.steps - steps0
    host_s, model_s = engine.host_s - host0, engine.model_s - model0
    for r in nl._memo.values():
        if (r.signature is None) != (r.error is not None):
            raise AssertionError(f"NLResult breaks the protocol: {r}")
    if nl.calls != len(texts):
        raise AssertionError(f"{nl.calls} canonicalizer calls for {len(texts)} texts")
    batches = -(-len(texts) // NL_BATCH)
    attn = {"ssm": 0, "hybrid": cfg.n_layers // max(cfg.attn_every, 1)}.get(cfg.kind,
                                                                        cfg.n_layers)
    mamba = cfg.n_layers if cfg.kind in ("ssm", "hybrid") else 0
    want = {"flash_attn": attn * batches, "decode_attn": attn * steps,
            "ssd_scan": mamba * batches}
    if any(launches[k] != n for k, n in want.items()):
        raise AssertionError(f"{cfg.name} launches {dict(launches)} for {len(texts)} "
                             f"requests and {steps} steps")
    tok = build_tokenizer([wl])
    return {"launches": launches, "engine": engine, "summary": {
        "requests": len(results), "statuses": _statuses(results),
        "nl_gated": tenant.stats.nl_gated,
        "errors": sorted({(r.error or "")[:40] for r in nl._memo.values()}),
        "prompt_len": [_prompt_len(tok, texts[i:i + NL_BATCH])
                       for i in range(0, len(texts), NL_BATCH)],
        "engine_wall_s": wall, "decode_steps": steps, "host_s": host_s, "model_s": model_s,
        "host_ms_per_step": host_s / max(steps, 1) * 1e3,
        "model_ms_per_step": model_s / max(steps, 1) * 1e3,
        "tokens_per_s": steps * NL_BATCH / wall,
        "rows_with_output": sum(len(r.raw_json) > 0 for r in nl._memo.values()),
        "max_memory_allocated": torch.cuda.max_memory_allocated(),
        **oracle.check(results)}}


def llm_phase(wl, oracle, seed: int) -> dict:
    import torch

    from repro_torch.configs.registry import get
    from repro_torch.core.nl_canon import MemoizedNL
    from repro_torch.models import transformer as tt
    from repro_torch.serving.engine import CanonicalizerService, ServingEngine
    from repro_torch.training.tokenizer import build_tokenizer

    torch.backends.cuda.matmul.allow_tf32 = False  # float32 products in float32
    torch.backends.cudnn.allow_tf32 = False
    cfg = get("canonicalizer-100m")
    out: dict = {"config": {k: getattr(cfg, k) for k in (
        "n_layers", "d_model", "n_heads", "kv_heads", "head_dim", "d_ff", "vocab")}}
    gen = torch.Generator().manual_seed(seed)
    b, s = 4, 64
    tokens = torch.randint(0, cfg.vocab, (b, s), generator=gen).cuda()
    nxt = tokens[:, -1]
    ext = torch.cat([tokens, nxt[:, None]], dim=1)

    # (a) teacher forcing on the card: prefill (flash kernel) against
    # forward, one decode step (decode kernel) against forward over S+1
    tf = {}
    for dtype in (torch.float32, torch.bfloat16):
        c = dataclasses.replace(cfg, dtype=dtype)
        params = tt.init_params(c, seed, device="cuda")
        with torch.inference_mode():
            full = tt.forward(c, params, tokens=tokens)
            logits, caches, pos = tt.prefill(c, params, tokens=tokens, cache_len=s + 8)
            step, caches, pos = tt.decode_step(c, params, nxt, caches, pos)
            full2 = tt.forward(c, params, tokens=ext)
        name = str(dtype).removeprefix("torch.")
        for what, t in (("forward", full), ("prefill", logits), ("decode", step),
                        ("forward S+1", full2)):
            finite(t, f"{what} {name}")
        tf[name] = {"prefill": compare(logits, full[:, -1], f"prefill {name}", 2e-2, 2e-2),
                    "decode": compare(step, full2[:, -1], f"decode {name}", 3e-2, 3e-2),
                    "logits_std": float(full.std()),
                    "logits_absmax": float(full.abs().max())}
    out["teacher_forcing_max_abs_err"] = tf

    # (b) the same float32 model on the CPU: plain attention, same logits
    c32 = dataclasses.replace(cfg, dtype=torch.float32)
    p_card = tt.init_params(c32, seed, device="cuda")
    p_cpu = tt.to_device(p_card, "cpu")
    with torch.inference_mode():
        card = tt.prefill(c32, p_card, tokens=tokens, cache_len=s + 8)
        card_step = tt.decode_step(c32, p_card, nxt, card[1], card[2])[0]
        host = tt.prefill(c32, p_cpu, tokens=tokens.cpu(), cache_len=s + 8)
        host_step = tt.decode_step(c32, p_cpu, nxt.cpu(), host[1], host[2])[0]
    out["card_vs_cpu_max_abs_err"] = {
        "prefill": compare(finite(card[0], "card prefill"), host[0],
                           "card vs cpu prefill", 1e-3, 1e-3),
        "decode": compare(finite(card_step, "card decode"), host_step,
                          "card vs cpu decode", 1e-3, 1e-3)}
    tok = build_tokenizer([wl])
    prompts = [f"question: {t}\nsignature: " for t in _nl_texts(wl, 4)]
    gens = [ServingEngine(c32, p, tok, device=d).generate(prompts, max_new_tokens=32)
            for p, d in ((p_card, "cuda"), (p_cpu, "cpu"))]
    pairs = [(x, y) for g0, g1 in zip(*gens) for x, y in zip(g0["tokens"], g1["tokens"])]
    out["greedy_tokens_identical_share"] = sum(x == y for x, y in pairs) / max(len(pairs), 1)
    del p_card, p_cpu

    # (c) NL requests through the pipeline, the bfloat16 engine on the card:
    # one engine batch (mamba2's phase has two)
    engine = ServingEngine(cfg, tt.init_params(cfg, seed, device="cuda"), tok)
    run = _nl_batch(MemoizedNL(CanonicalizerService(engine, wl.schema.name)), wl, oracle,
                    _nl_texts(wl, NL_BATCH))
    out["pipeline"] = run["summary"]
    return {"launches": run["launches"], "summary": out, "engine": engine}


# ---------------------------------------------------------------- mamba2


def _teacher_forcing(mod, cfg, params, tokens, depth: int, **prefill_kw):
    """The first ``depth`` layers of the model: (forward over S, prefill
    logits, one decode step's logits, forward over S+1), the decode step fed
    the last token again (``prefill_kw``: a transformer's ``cache_len``,
    room for that step)."""
    import torch

    from repro_torch.models.model import cut_depth

    cfg, params = cut_depth(cfg, params, depth)
    nxt = tokens[:, -1]
    with torch.inference_mode():
        full = mod.forward(cfg, params, tokens=tokens)
        logits, caches, pos = mod.prefill(cfg, params, tokens=tokens, **prefill_kw)
        step = mod.decode_step(cfg, params, nxt, caches, pos)[0]
        full2 = mod.forward(cfg, params, tokens=torch.cat([tokens, nxt[:, None]], dim=1))
    for what, t in (("forward", full), ("prefill", logits), ("decode", step),
                    ("forward S+1", full2)):
        finite(t, f"{cfg.name} depth {depth} {cfg.dtype} {what}")
    return full, logits, step, full2


def mamba2_phase(wl, oracle, seed: int) -> dict:
    import torch

    from repro_torch.configs.registry import get
    from repro_torch.launch import serve
    from repro_torch.models import mamba2
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.training.tokenizer import build_tokenizer

    torch.backends.cuda.matmul.allow_tf32 = False  # float32 products in float32
    torch.backends.cudnn.allow_tf32 = False
    cfg = get("mamba2-780m")
    out: dict = {"config": {k: getattr(cfg, k) for k in (
        "n_layers", "d_model", "d_inner", "ssm_heads", "ssm_head_dim", "ssm_state",
        "conv_kernel", "vocab")}}
    gen = torch.Generator().manual_seed(seed)
    b, s = 4, 64
    tokens = torch.randint(0, cfg.vocab, (b, s), generator=gen).cuda()
    full_depth, cpu_depth = cfg.n_layers, 12

    # (a) teacher forcing on the card: prefill (SSD-scan kernel in every
    # layer) against forward, one decode step (plain SSD step from the
    # kernel's final state) against forward over S+1.  float32 at full
    # depth; bfloat16 prefill at full depth and decode at depth 1: past it
    # the random-init model's own amplification of bf16 rounding exceeds
    # 3e-2, JAX's model as much as this one
    # (benchmarks/bench_torch_mamba2_drift.py reads it by depth)
    tf = {}
    for dtype, dec_depth in ((torch.float32, full_depth), (torch.bfloat16, 1)):
        c = dataclasses.replace(cfg, dtype=dtype)
        name = str(dtype).removeprefix("torch.")
        params = mamba2.init_params(c, seed, device="cuda")
        res = {}
        for depth in sorted({dec_depth, full_depth}):
            full, logits, step, full2 = _teacher_forcing(mamba2, c, params, tokens, depth)
            if depth == dec_depth:
                res[f"decode_depth_{depth}"] = compare(
                    step, full2[:, -1], f"mamba2 decode {name} depth {depth}", 3e-2, 3e-2)
        res["prefill"] = compare(logits, full[:, -1], f"mamba2 prefill {name}", 2e-2, 2e-2)
        res["logits_std"], res["logits_absmax"] = float(full.std()), float(full.abs().max())
        tf[name] = res
        if dtype == torch.float32:
            p_card = params
        del params, full, full2
    out["teacher_forcing_max_abs_err"] = tf

    # (b) the same float32 model on the CPU: plain SSD scan, same logits
    # within 1e-3 at depth 12.  The model amplifies f32 rounding layer by
    # layer: at full depth the CPU with one thread against its default
    # differs from itself by more than 1e-3 (bench_torch_mamba2_drift.py)
    c32 = dataclasses.replace(cfg, dtype=torch.float32)
    p_cpu = mamba2.to_device(p_card, "cpu")
    c = dataclasses.replace(c32, n_layers=cpu_depth)
    runs = []
    for p, t in ((p_card, tokens), (p_cpu, tokens.cpu())):
        p = {**p, "layers": p["layers"][:cpu_depth]}
        with torch.inference_mode():
            logits, caches, pos = mamba2.prefill(c, p, tokens=t)
            step = mamba2.decode_step(c, p, t[:, -1], caches, pos)[0]
        runs.append((finite(logits, "prefill"), finite(step, "decode")))
    (card, card_step), (host, host_step) = runs
    out[f"card_vs_cpu_max_abs_err_depth_{cpu_depth}"] = {
        "prefill": compare(card, host, f"mamba2 card vs cpu prefill depth {cpu_depth}",
                           1e-3, 1e-3),
        "decode": compare(card_step, host_step,
                          f"mamba2 card vs cpu decode depth {cpu_depth}", 1e-3, 1e-3)}
    tok = build_tokenizer([wl])
    prompts = [f"question: {t}\nsignature: " for t in _nl_texts(wl, 4)]
    gens = [ServingEngine(c32, p, tok, device=d).generate(prompts, max_new_tokens=32)
            for p, d in ((p_card, "cuda"), (p_cpu, "cpu"))]
    pairs = [(x, y) for g0, g1 in zip(*gens) for x, y in zip(g0["tokens"], g1["tokens"])]
    out["greedy_tokens_identical_share"] = sum(x == y for x, y in pairs) / max(len(pairs), 1)
    del p_card, p_cpu, runs, card, card_step
    torch.cuda.empty_cache()

    # (c) NL requests through the pipeline: the launcher's canonicalizer
    # over mamba2-780m, the bfloat16 engine on the card
    run = _nl_batch(serve.llm_canonicalizer(wl, "mamba2-780m", seed=seed, device="cuda"),
                    wl, oracle, _nl_texts(wl, 2 * NL_BATCH))
    out["pipeline"] = run["summary"]
    return {"launches": run["launches"], "summary": out, "engine": run["engine"]}


def reduced_phase(wl, oracle, seed: int) -> dict:
    """``launch.serve --reduced`` on the card: one engine batch of SSB NL
    requests through ``serve.llm_canonicalizer(wl, "canonicalizer-100m",
    reduced=True)`` (2 layers, d_model 64, 4/2 heads of head dim 16, the
    head widened to the tokenizer), bfloat16 weights from ``seed``."""
    from repro_torch.launch import serve

    nl = serve.llm_canonicalizer(wl, "canonicalizer-100m", reduced=True, seed=seed,
                                 device="cuda")
    cfg = nl.inner.engine.cfg
    out = _nl_batch(nl, wl, oracle, _nl_texts(wl, NL_BATCH))
    out["summary"]["config"] = {k: getattr(cfg, k) for k in (
        "name", "n_layers", "d_model", "n_heads", "kv_heads", "head_dim", "vocab")}
    return out


GEMMA_CPU_DEPTH = 4  # gemma-2b's card-vs-CPU check: f32 weights of 4 of 18 layers on the host
GEMMA_STEPS = 8  # decode steps after gemma-2b's prefill of 8 prompts


def gemma_phase(seed: int, plen: int) -> dict:
    """gemma-2b at full width and depth (18 layers, d_model 2048, 8/1 heads
    of head dim 256, geglu, tied vocab 256,000, ~2.5 B parameters), weights
    initialised from ``seed`` on the card: (a) teacher forcing at full
    depth in float32 and bfloat16, prefill logits against ``forward``
    (2e-2) and one ``decode_step`` against ``forward`` over S+1 tokens
    (3e-2); (b) the float32 model's first ``GEMMA_CPU_DEPTH`` layers on the
    CPU (plain attention) against the card, prefill and decode logits
    within 1e-3; (c) bfloat16 prefill of 8 token-id prompts of ``plen``
    tokens and ``GEMMA_STEPS`` greedy decode steps, the launch counts
    zeroed just before and read just after: one ``flash_attn`` per layer,
    one ``decode_attn`` per layer and step."""
    import torch

    from repro_torch.configs.registry import get
    from repro_torch.kernels.binding import launch_counts, reset_launch_counts
    from repro_torch.models import transformer as tt
    from repro_torch.models.model import tree_leaves, tree_map

    torch.backends.cuda.matmul.allow_tf32 = False  # float32 products in float32
    torch.backends.cudnn.allow_tf32 = False
    cfg = get("gemma-2b")
    out: dict = {"config": {k: getattr(cfg, k) for k in (
        "n_layers", "d_model", "n_heads", "kv_heads", "head_dim", "d_ff", "vocab",
        "activation", "tie_embeddings")}}
    c32 = dataclasses.replace(cfg, dtype=torch.float32)
    t0 = time.perf_counter()
    p32 = tt.init_params(c32, seed, device="cuda")
    # init_params draws in f32 and casts: the bf16 weights are these, cast
    p16 = tree_map(lambda t: t.to(cfg.dtype), p32)
    out["parameters"] = sum(t.numel() for t in tree_leaves(p32))
    out["init_s"] = time.perf_counter() - t0
    gen = torch.Generator().manual_seed(seed)
    b, s = 4, 64
    tokens = torch.randint(0, cfg.vocab, (b, s), generator=gen).cuda()

    # (a) teacher forcing at full depth
    tf = {}
    for c, params in ((c32, p32), (cfg, p16)):
        name = str(c.dtype).removeprefix("torch.")
        full, logits, step, full2 = _teacher_forcing(tt, c, params, tokens, c.n_layers,
                                                     cache_len=s + 8)
        tf[name] = {"prefill": compare(logits, full[:, -1], f"gemma prefill {name}",
                                       2e-2, 2e-2),
                    "decode": compare(step, full2[:, -1], f"gemma decode {name}", 3e-2, 3e-2),
                    "logits_std": float(full.std()), "logits_absmax": float(full.abs().max())}
        del full, full2
    out["teacher_forcing_max_abs_err"] = tf

    # (b) the float32 model's first layers on the CPU
    c = dataclasses.replace(c32, n_layers=GEMMA_CPU_DEPTH)
    cut = {**p32, "layers": p32["layers"][:GEMMA_CPU_DEPTH]}
    runs = []
    for p, t in ((cut, tokens[:2, :32]), (tt.to_device(cut, "cpu"), tokens[:2, :32].cpu())):
        with torch.inference_mode():
            logits, caches, pos = tt.prefill(c, p, tokens=t, cache_len=40)
            step = tt.decode_step(c, p, t[:, -1], caches, pos)[0]
        runs.append((finite(logits, "gemma prefill"), finite(step, "gemma decode")))
    (card, card_step), (host, host_step) = runs
    out[f"card_vs_cpu_max_abs_err_depth_{GEMMA_CPU_DEPTH}"] = {
        "prefill": compare(card, host, "gemma card vs cpu prefill", 1e-3, 1e-3),
        "decode": compare(card_step, host_step, "gemma card vs cpu decode", 1e-3, 1e-3)}
    del p32, cut, runs, card, card_step
    torch.cuda.empty_cache()

    # (c) the path: 8 prompts, prefill and greedy decode steps, bfloat16
    prompts = torch.randint(0, cfg.vocab, (NL_BATCH, plen), generator=gen).cuda()
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    with torch.inference_mode():
        logits, caches, pos = tt.prefill(cfg, p16, tokens=prompts, cache_len=plen + GEMMA_STEPS)
        for _ in range(GEMMA_STEPS):
            logits, caches, pos = tt.decode_step(cfg, p16, finite(logits, "gemma logits")
                                                 .argmax(-1), caches, pos)
    torch.cuda.synchronize()
    launches = launch_counts()
    finite(logits, "gemma logits")
    if launches["flash_attn"] != cfg.n_layers \
            or launches["decode_attn"] != cfg.n_layers * GEMMA_STEPS:
        raise AssertionError(f"gemma launches {dict(launches)} for {GEMMA_STEPS} steps")
    out["path"] = {"prompts": NL_BATCH, "prompt_len": plen, "decode_steps": GEMMA_STEPS,
                   "wall_s": time.perf_counter() - t0,
                   "max_memory_allocated": torch.cuda.max_memory_allocated()}
    return {"launches": launches, "summary": out}


# ------------------------------------------------------- zamba2 and moe


ZAMBA2_CPU_DEPTH = 12  # zamba2-7b's card-vs-CPU check: two segments, two applications
MOE_DEPTH = 4  # qwen3-moe-235b-a22b's layers on the card: 4 of 94, ~22.4 GB in bf16
MOE_CPU_DEPTH = 1  # its card-vs-CPU check: the f32 weights of one layer on the host
# decode steps of the two large models' profiled batch: zamba2-7b's step
# traces ~5,700 device ops, and long traces cost the profiler records later
LARGE_PROFILE_STEPS = 8


def _free() -> None:
    """Return the memory of everything no longer referenced to the card."""
    import gc

    import torch

    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


def _card_vs_cpu(mod, cfg, params, tokens, depth: int, what: str, counter=None) -> dict:
    """The first ``depth`` layers of a float32 copy of ``params`` (the
    bf16 values, exact in f32) on the card and on the CPU: prefill and one
    decode step within 1e-3.  ``counter`` (a context manager yielding a list
    of counts, e.g. ``moe.count_dropped``) is opened around each side's
    prefill and decode; their sums must be equal on both sides."""
    import contextlib

    import torch

    from repro_torch.models.model import cut_depth, tree_map

    cfg, cut = cut_depth(dataclasses.replace(cfg, dtype=torch.float32), params, depth)
    cut = tree_map(lambda t: t.float(), cut)
    runs, counts = [], []
    for p, t in ((cut, tokens), (mod.to_device(cut, "cpu"), tokens.cpu())):
        with torch.inference_mode():
            with counter() if counter else contextlib.nullcontext([]) as c1:
                logits, caches, pos = mod.prefill(cfg, p, tokens=t, cache_len=t.shape[1] + 8)
            with counter() if counter else contextlib.nullcontext([]) as c2:
                step = mod.decode_step(cfg, p, t[:, -1], caches, pos)[0]
        runs.append((finite(logits, f"{what} prefill"), finite(step, f"{what} decode")))
        counts.append((int(sum(c1)), int(sum(c2))))
    (card, card_step), (host, host_step) = runs
    out = {"prefill": compare(card, host, f"{what} card vs cpu prefill depth {depth}",
                              1e-3, 1e-3),
           "decode": compare(card_step, host_step, f"{what} card vs cpu decode depth {depth}",
                             1e-3, 1e-3)}
    if counter:
        if counts[0] != counts[1]:
            raise AssertionError(f"{what}: (prefill, decode) counts {counts[0]} on the card, "
                                 f"{counts[1]} on the CPU")
        out["counted_card_cpu"] = counts
    return out


def _served_phase(cfg, params, tok, wl, oracle, texts, ranges: tuple = ()) -> dict:
    """``texts`` through ``MemoizedNL(CanonicalizerService(engine))`` in a
    ``CacheService`` tenant (``_nl_batch``), then one engine batch of at
    most ``LARGE_PROFILE_STEPS`` decode steps under ``torch.profiler``
    (``profile_engine``)."""
    from repro_torch.core.nl_canon import MemoizedNL
    from repro_torch.serving.engine import CanonicalizerService, ServingEngine

    engine = ServingEngine(cfg, params, tok)
    run = _nl_batch(MemoizedNL(CanonicalizerService(engine, wl.schema.name)), wl, oracle,
                    texts)
    run["profile"] = profile_engine(engine, wl, ranges, LARGE_PROFILE_STEPS)
    del run["engine"]
    return run


def zamba2_phase(wl, oracle, seed: int, dev, plen: int, iters: int) -> dict:
    """zamba2-7b at full width and depth (81 Mamba2 layers, d_model 3584,
    d_inner 7168, 112 SSD heads of 64, state 64; the shared attention +
    geglu MLP block after every 6 layers, 13 applications, 32/32 heads of
    head dim 112, d_ff 14,336; vocab 32,000; ~6.75 B parameters), bf16
    weights drawn on the card from ``seed``: (a) the kernels at its launch
    shapes (``zamba2_times``); (b) teacher forcing, prefill against
    ``forward`` (2e-2) and a decode step against ``forward`` over S+1
    (3e-2), in bf16 at the first Mamba layer and the shared block after it
    and in f32 at ``ZAMBA2_CPU_DEPTH``; in bf16 at one segment (6 layers
    and the block) and at full depth the drift is read, not held (at
    random init the bf16 model amplifies rounding layer by layer: 0.076
    at one segment on an H100); f32 card against CPU at
    ``ZAMBA2_CPU_DEPTH`` (1e-3); (c) 16
    SSB NL questions in 2 engine batches through ``CacheService``, the
    launch counts zeroed just before and read just after (81 ``ssd_scan``
    and 13 ``flash_attn`` per prefill, 13 ``decode_attn`` per step), and
    one more batch profiled.  The peak memory is read above what was
    resident before the phase; everything is freed after it."""
    import torch

    from repro_torch.configs.registry import get
    from repro_torch.launch import serve
    from repro_torch.models import zamba2
    from repro_torch.models.model import cut_depth, tree_leaves, tree_map

    torch.backends.cuda.matmul.allow_tf32 = False  # float32 products in float32
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    kernels = zamba2_times(dev, gen, plen, MAX_LEN, iters)
    _free()
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    cfg, _, tok, _ = serve.served_model(get("zamba2-7b"), wl)  # vocab 32,000 kept
    out: dict = {"config": {k: getattr(cfg, k) for k in (
        "n_layers", "d_model", "d_inner", "ssm_heads", "ssm_head_dim", "ssm_state",
        "n_heads", "kv_heads", "head_dim", "d_ff", "attn_every", "vocab")},
        "applications": zamba2.attn_apps(cfg), "kernels": kernels}
    t0 = time.perf_counter()
    params = zamba2.init_params(cfg, gen, device=dev)  # drawn on the card
    torch.cuda.synchronize()
    out["init_s"] = time.perf_counter() - t0
    out["parameters"] = sum(t.numel() for t in tree_leaves(params))
    out["param_count"] = cfg.param_count()
    b, s = 4, 64
    tokens = torch.randint(0, cfg.vocab, (b, s), generator=torch.Generator().manual_seed(seed))
    tokens = tokens.to(dev)

    # (b) teacher forcing, held in bf16 at one Mamba layer and the shared
    # block (attn_every 1) and in f32 at two segments; the bf16 drift of one
    # segment and of the whole model is read, not held: at random init the
    # bf16 model amplifies rounding layer by layer (the port's and JAX's
    # alike, tests/test_torch_zamba2.py), as mamba2-780m's does
    tf = {}
    one = dataclasses.replace(cfg, attn_every=1)
    f32 = dataclasses.replace(cfg, dtype=torch.float32)
    for name, c, depth, held in (("bfloat16_layer_1_and_block", one, 1, True),
                                 (f"bfloat16_depth_{cfg.attn_every}", cfg, cfg.attn_every, False),
                                 (f"bfloat16_depth_{cfg.n_layers}", cfg, cfg.n_layers, False),
                                 (f"float32_depth_{ZAMBA2_CPU_DEPTH}", f32, ZAMBA2_CPU_DEPTH,
                                  True)):
        p = params
        if c.dtype != cfg.dtype:  # the first layers' bf16 values in f32
            p = tree_map(lambda t: t.float(), cut_depth(c, params, depth)[1])
        full, logits, step, full2 = _teacher_forcing(zamba2, c, p, tokens, depth,
                                                     cache_len=s + 8)
        if held:
            tf[name] = {"prefill": compare(logits, full[:, -1], f"zamba2 prefill {name}",
                                           2e-2, 2e-2),
                        "decode": compare(step, full2[:, -1], f"zamba2 decode {name}",
                                          3e-2, 3e-2)}
        else:
            tf[name] = {"prefill_read": float((logits - full[:, -1]).abs().max()),
                        "decode_read": float((step - full2[:, -1]).abs().max())}
        tf[name].update(logits_std=float(full.std()), logits_absmax=float(full.abs().max()))
        del p, full, full2
    out["teacher_forcing_max_abs_err"] = tf
    out[f"card_vs_cpu_max_abs_err_depth_{ZAMBA2_CPU_DEPTH}"] = _card_vs_cpu(
        zamba2, cfg, params, tokens[:2, :32], ZAMBA2_CPU_DEPTH, "zamba2")
    _free()

    # (c) 16 NL questions through the pipeline, bf16
    run = _served_phase(cfg, params, tok, wl, oracle, _nl_texts(wl, 2 * NL_BATCH))
    out["pipeline"], out["profile"] = run["summary"], run["profile"]
    out["peak_bytes_above_resident"] = torch.cuda.max_memory_allocated() - resident
    del params, run["summary"]
    _free()
    return {"launches": run["launches"], "summary": out}


def moe_phase(wl, oracle, seed: int, dev) -> dict:
    """qwen3-moe-235b-a22b at full width (d_model 4096, 64/4 heads of 128
    with qk_norm, 128 experts in 16 x 8 of d_ff 1,536, top-8, vocab
    151,936, bf16) and ``MOE_DEPTH`` of its 94 layers (94 are ~470 GB in
    bf16), weights drawn on the card from ``seed``: (a) teacher forcing in
    bf16 at ``MOE_DEPTH`` with capacity factor 64 (drop-free routing:
    capacity truncation differs between a one-token decode and a full
    forward); (b) f32 card against CPU at ``MOE_CPU_DEPTH`` at the config's
    capacity factor (1.25), the routes dropped for capacity counted on both
    sides and equal; (c) 8 SSB NL questions in one engine batch through
    ``CacheService`` (``MOE_DEPTH`` ``flash_attn`` per prefill and
    ``decode_attn`` per step), and one more batch profiled, its device time
    split between the expert products (``moe.experts``) and the routing
    ops (``moe.routing``: router, top-k, gathers, scatter-adds)."""
    import torch

    from repro_torch.configs.registry import get
    from repro_torch.launch import serve
    from repro_torch.models import moe, transformer
    from repro_torch.models.model import tree_leaves

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _free()
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    full_cfg, _, tok, _ = serve.served_model(get("qwen3-moe-235b-a22b"), wl)
    cfg = dataclasses.replace(full_cfg, n_layers=MOE_DEPTH)
    out: dict = {"config": {k: getattr(cfg, k) for k in (
        "n_layers", "d_model", "n_heads", "kv_heads", "head_dim", "qk_norm", "n_experts",
        "top_k", "d_ff", "capacity_factor", "vocab")},
        "expert_shards": moe.expert_shards(cfg), "full_depth_layers": full_cfg.n_layers,
        "full_depth_param_count": full_cfg.param_count(),
        "full_depth_active_param_count": full_cfg.active_param_count()}
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    t0 = time.perf_counter()
    params = transformer.init_params(cfg, gen, device=dev)
    torch.cuda.synchronize()
    out["init_s"] = time.perf_counter() - t0
    out["parameters"] = sum(t.numel() for t in tree_leaves(params))
    b, s = 4, 64
    tokens = torch.randint(0, cfg.vocab, (b, s), generator=torch.Generator().manual_seed(seed))
    tokens = tokens.to(dev)

    # (a) teacher forcing in bf16 at the cut depth, drop-free
    c = dataclasses.replace(cfg, capacity_factor=64.0)
    full, logits, step, full2 = _teacher_forcing(transformer, c, params, tokens, MOE_DEPTH,
                                                 cache_len=s + 8)
    out["teacher_forcing_max_abs_err"] = {"bfloat16": {
        "prefill": compare(logits, full[:, -1], "moe prefill bf16", 2e-2, 2e-2),
        "decode": compare(step, full2[:, -1], "moe decode bf16", 3e-2, 3e-2),
        "logits_std": float(full.std()), "logits_absmax": float(full.abs().max())}}
    del full, full2
    # (b) card vs CPU in f32 at the config's capacity, dropped routes equal
    out[f"card_vs_cpu_max_abs_err_depth_{MOE_CPU_DEPTH}"] = _card_vs_cpu(
        transformer, cfg, params, tokens[:2, :32], MOE_CPU_DEPTH, "moe", moe.count_dropped)
    _free()

    # (c) 8 NL questions through the pipeline, bf16
    run = _served_phase(cfg, params, tok, wl, oracle, _nl_texts(wl, NL_BATCH),
                        ranges=("moe.experts", "moe.routing"))
    out["pipeline"], out["profile"] = run["summary"], run["profile"]
    out["peak_bytes_above_resident"] = torch.cuda.max_memory_allocated() - resident
    del params, run["summary"]
    _free()
    return {"launches": run["launches"], "summary": out}


# ----------------------------------------------------------------- serve


DASHBOARD = ("SELECT c_region, SUM(lo_revenue) AS rev, AVG(lo_quantity) AS q, "
             "COUNT(*) AS n, MIN(lo_supplycost) AS lo, MAX(lo_supplycost) AS hi "
             "FROM lineorder JOIN customer ON lineorder.lo_custkey = customer.c_key "
             "JOIN dates ON lineorder.lo_orderdate = dates.d_key "
             "WHERE d_year = {y} GROUP BY c_region")
HOST_MASK = ("SELECT c_region, SUM(lo_revenue) AS rev, COUNT(*) AS n FROM lineorder "
             "JOIN customer ON lineorder.lo_custkey = customer.c_key "
             "WHERE lo_extendedprice > 5000.25 GROUP BY c_region")


class FusedShapes:
    """Within its ``with``, the shape (N, M, P, K, S, G, op) of every kernel
    B launch, counted: ``kernel.seg_agg_fused_cuda`` is wrapped for the
    block's duration (one launch per chunk of up to 64 signatures)."""

    def __enter__(self):
        import collections
        import threading

        from repro_torch.kernels.seg_agg import kernel

        self.kernel, self.real = kernel, kernel.seg_agg_fused_cuda
        self.counts: collections.Counter = collections.Counter()
        lock = threading.Lock()  # the scan plane launches from several threads

        def recording(values, ids, pred_cols, bounds, num_groups, op="sum"):
            s, p, k, _ = bounds.shape
            with lock:
                for s0 in range(0, s, kernel.MAX_SIGNATURES):
                    self.counts[(values.shape[0], values.shape[1], p, k,
                                 min(kernel.MAX_SIGNATURES, s - s0), num_groups, op)] += 1
            return self.real(values, ids, pred_cols, bounds, num_groups, op)

        kernel.seg_agg_fused_cuda = recording
        return self

    def __exit__(self, *exc):
        self.kernel.seg_agg_fused_cuda = self.real


def serve_phase(wl, oracle) -> dict:
    import numpy as np
    import torch

    from repro_torch.kernels.binding import launch_counts, reset_launch_counts
    from repro_torch.launch import serve
    from repro_torch.service import CacheService

    svc = CacheService()
    tenant = serve.build_tenant(svc, wl, device="cuda", shards=1)
    torch.cuda.reset_peak_memory_stats()

    secs = {}
    t0 = time.perf_counter()
    reset_launch_counts()
    results = []
    with FusedShapes() as shapes:
        for name, sqls in serve.sql_streams(wl).items():
            results += serve.replay(svc, sqls, batch=8)
        before = launch_counts()
        groups = tenant.backend.batch_groups
        tiles = serve.replay(svc, [DASHBOARD.format(y=y) for y in range(1992, 1998)])
        mid = launch_counts()
        host = serve.replay(svc, [HOST_MASK])
        torch.cuda.synchronize()
    launches = launch_counts()
    secs["serve"] = time.perf_counter() - t0
    uncontained(tenant, results + tiles + host, "[serve]")
    if sum(shapes.counts.values()) != launches["seg_agg_fused"]:
        raise AssertionError(f"{sum(shapes.counts.values())} kernel B shapes recorded for "
                             f"{launches['seg_agg_fused']} launches")
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
    if any(r.table is None for r in results):
        raise AssertionError("a SQL request was served no table")
    checked = oracle.check(results)
    secs["oracle_check"] = time.perf_counter() - t0
    statuses = _statuses(results)
    if not {"hit_exact", "hit_rollup", "miss"} <= set(statuses):
        raise AssertionError(f"statuses {statuses}")
    if not (launches["seg_agg"] and launches["seg_agg_fused"]):
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
        "fused_shapes": shapes.counts,
        "summary": {
            "n_fact": wl.dataset.fact.num_rows, "requests": len(results), "statuses": statuses,
            "hit_rate": s.hit_rate, **checked,
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


def nl_phase(wl, oracle) -> dict:
    """The SSB mixed stream, SQL and NL, with NL canonicalized by the
    calibrated SimulatedLLM behind the balanced safety policy."""
    import torch

    from repro_torch.core.nl_canon import MemoizedNL, SimulatedLLM
    from repro_torch.kernels.binding import launch_counts, reset_launch_counts
    from repro_torch.launch import serve
    from repro_torch.service import CacheService

    svc = CacheService()
    tenant = serve.build_tenant(svc, wl, device="cuda",
                                nl=MemoizedNL(SimulatedLLM(wl.vocab)))
    reqs = serve.mixed_streams(wl)["ssb_mixed"]
    reset_launch_counts()
    t0 = time.perf_counter()
    results = serve.replay(svc, reqs, batch=8)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = launch_counts()
    uncontained(tenant, results, "[nl]")
    checked = oracle.check(results)
    nl = [r for r in results if r.origin == "nl"]
    nl_hits = sum(r.hit for r in nl)
    if not nl_hits:
        raise AssertionError(f"no NL hit: {_statuses(nl)}")
    if not launches["seg_agg_fused"]:
        raise AssertionError(f"no miss reached the kernels: {launches}")
    return {"launches": launches, "summary": {
        "requests": len(results), "nl_requests": len(nl), "statuses": _statuses(results),
        "nl_statuses": _statuses(nl), "nl_hits": nl_hits, "nl_gated": tenant.stats.nl_gated,
        "hit_rate": tenant.cache.stats.hit_rate, "serve_s": wall, **checked}}


# --------------------------------------------------------------- service


SERVICE_SHARDS = 4


class ThreadLaunches:
    """Within its ``with``, which thread called kernel A
    (``kernel.seg_agg_cuda``) or kernel B (``kernel.seg_agg_fused_cuda``),
    by batch: both are wrapped for the block's duration, and the calls
    count under the batch named by ``batch`` when they were made.  Each
    call is also kept in ``detail[batch]`` as (thread, CUDA stream handle,
    kernel, rows)."""

    def __enter__(self):
        import collections
        import threading

        import torch

        from repro_torch.kernels.seg_agg import kernel

        self.kernel = kernel
        self.real = {name: getattr(kernel, name) for name in ("seg_agg_cuda",
                                                              "seg_agg_fused_cuda")}
        self.batch = None
        self.calls: dict = collections.defaultdict(collections.Counter)
        self.detail: dict = collections.defaultdict(list)
        lock = threading.Lock()

        def wrapped(name, fn):
            def recording(values, *args, **kw):
                thread = threading.current_thread().name
                stream = torch.cuda.current_stream(values.device).cuda_stream
                with lock:
                    self.calls[self.batch][(thread, name)] += 1
                    self.detail[self.batch].append((thread, stream, name, values.shape[0]))
                return fn(values, *args, **kw)
            return recording

        for name, fn in self.real.items():
            setattr(kernel, name, wrapped(name, fn))
        return self

    def __exit__(self, *exc):
        for name, fn in self.real.items():
            setattr(self.kernel, name, fn)

    def shard_threads(self, batch) -> set:
        return {th for th, _ in self.calls.get(batch, ()) if th.startswith("shard-miss")}


def _fire_once_spec(point: str, arrivals: int = 8) -> str:
    """A fault spec under which the first arrival at ``point`` fires and
    the next ``arrivals - 1`` do not (the draws are counter-based)."""
    from repro_torch.resilience.faults import FaultPlan, parse

    for seed in range(100_000):
        spec = f"{point}:0.5:{seed}"
        plan = FaultPlan(parse(spec))
        if [plan.should_fire(point) for _ in range(arrivals)] == [True] + [False] * (arrivals - 1):
            return spec
    raise AssertionError(f"no seed fires {point} once")


def service_phase(wl, oracle) -> dict:
    """SSB through ``CacheService.register_tenant(..., shards=4)`` on the
    card: the SSB SQL stream and the SSB mixed stream (NL through
    ``MemoizedNL(SimulatedLLM)``), both interleaved across intents so that
    batches carry several measure families, the drill stream, and a batch
    of a host-mask request and two dashboard tiles (kernels A and B from
    two shards).  Misses of one batch in different shards run on the
    service's ``shard-miss`` threads at once.  Then one batch of four new
    dashboard tiles with ``backend.error`` injected once (the retry must
    reach kernel B and serve the oracle's tables), and one more batch after
    the plan is cleared (nothing may fire)."""
    import os

    import numpy as np
    import torch

    from repro_torch.core.nl_canon import MemoizedNL, SimulatedLLM
    from repro_torch.kernels.binding import launch_counts, reset_launch_counts
    from repro_torch.launch import serve
    from repro_torch.resilience import faults
    from repro_torch.service import CacheService

    svc = CacheService()
    tenant = serve.build_tenant(svc, wl, device="cuda", nl=MemoizedNL(SimulatedLLM(wl.vocab)),
                                shards=SERVICE_SHARDS)
    batches = []
    for name, reqs in (
            ("ssb_sql", serve.sql_streams(wl, order="interleaved")["ssb_sql"]),
            ("drill", serve.sql_streams(wl)["drill"]),
            ("ssb_mixed", serve.mixed_streams(wl, order="interleaved")["ssb_mixed"]),
            ("cross_family", [HOST_MASK] + [DASHBOARD.format(y=y) for y in (1992, 1993)])):
        batches += [(name, reqs[i:i + 8]) for i in range(0, len(reqs), 8)]
    spec = _fire_once_spec("backend.error")
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    results, by_batch = [], []
    with ThreadLaunches() as threads:
        for i, (name, reqs) in enumerate(batches):
            threads.batch = i
            out = serve.replay(svc, reqs)
            results += out
            by_batch.append(out)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = launch_counts()

        # one backend error, then the retry
        retries0 = tenant.stats.retries
        threads.batch = "fault"
        before = launch_counts()
        with faults.scoped(spec) as plan:
            faulted = serve.replay(svc, [DASHBOARD.format(y=y) for y in range(1994, 1998)])
            fired = dict(plan.counts()["fired"])
        after_fault = launch_counts()
        armed = [s.point for s in faults.active_plan().specs] + \
            [v for v in (os.environ.get(faults.ENV_VAR),) if v]
        threads.batch = "cleared"
        cleared = serve.replay(svc, [DASHBOARD.format(y=1998)])
        torch.cuda.synchronize()
        fault_threads = {th for th, _ in threads.calls["fault"]}

    uncontained(tenant, results + faulted + cleared, "[service]")
    checked = oracle.check(results + faulted + cleared)
    if fired != {"backend.error": 1} or tenant.stats.retries - retries0 != 1:
        raise AssertionError(f"backend.error fired {fired}, "
                             f"{tenant.stats.retries - retries0} retries")
    if [r.status for r in faulted] != ["miss"] * 4 \
            or not all("retry:1" in r.provenance for r in faulted):
        raise AssertionError(f"fault batch: {[(r.status, r.provenance) for r in faulted]}")
    if after_fault["seg_agg_fused"] - before["seg_agg_fused"] < 1 or not fault_threads:
        raise AssertionError(f"the retry did not reach kernel B: {before} -> {after_fault}")
    if armed or tenant.stats.retries - retries0 != 1 \
            or any(p.startswith("retry:") for r in cleared for p in r.provenance):
        raise AssertionError(f"faults still armed after the plan was cleared: {armed}, "
                             f"{[r.provenance for r in cleared]}")
    parallel = [i for i in range(len(batches)) if len(threads.shard_threads(i)) >= 2]
    if not parallel:
        raise AssertionError("no batch launched kernel A or B from two shard-miss threads")
    if not (launches["seg_agg"] and launches["seg_agg_fused"]):
        raise AssertionError(f"a kernel was never launched by [service]: {launches}")
    cross = len(batches) - 1
    cross_kernels = {k for _, k in threads.calls[cross]}
    if len(threads.shard_threads(cross)) < 2 or len(cross_kernels) < 2:
        raise AssertionError(f"cross-family batch: {dict(threads.calls[cross])}")

    per_req = np.array([sum(r.timings_ms.values()) for r in results])
    scans = [r.timings_ms["execute"] for r in results if r.status == "miss" and not r.deduped]
    s = tenant.cache.stats
    return {"launches": launches, "summary": {
        "shards": SERVICE_SHARDS, "requests": len(results), "batches": len(batches),
        "statuses": _statuses(results), "hit_rate": s.hit_rate, **checked,
        "failures": tenant.stats.failures, "degraded": tenant.stats.degraded,
        "shard_parallel_batches": len(parallel),
        "shard_parallel_batch_threads": {str(i): sorted(threads.shard_threads(i))
                                         for i in parallel},
        "cross_family_launches": {f"{th} {k}": n for (th, k), n in
                                  sorted(threads.calls[cross].items())},
        "request_ms_p50": float(np.percentile(per_req, 50)),
        "request_ms_p95": float(np.percentile(per_req, 95)),
        "miss_execute_ms_p50": float(np.percentile(scans, 50)),
        "miss_execute_ms_p95": float(np.percentile(scans, 95)),
        "fault": {"spec": spec, "fired": fired, "retries": tenant.stats.retries - retries0,
                  "statuses": _statuses(faulted),
                  "kernel_b_launches": after_fault["seg_agg_fused"] - before["seg_agg_fused"],
                  "threads": sorted(fault_threads), "armed_after_clear": armed,
                  "after_clear": _statuses(cleared)},
        "by_shard": [d["entries"] for d in tenant.cache.stats_by_shard()],
        "wall_s": wall}}


# ------------------------------------------------------------------ scan


SCAN_PARTITIONS = 4
SCAN_CHUNK_ROWS = 1 << 20  # max_device_rows: a 1,500,000-row partition streams in two chunks
DISTINCT = ("SELECT c_region, COUNT(DISTINCT lo_custkey) AS n FROM lineorder "
            "JOIN customer ON lineorder.lo_custkey = customer.c_key GROUP BY c_region")
SCAN_TILE = ("SELECT s_region, SUM(lo_supplycost) AS c, MAX(lo_quantity) AS q FROM lineorder "
             "JOIN supplier ON lineorder.lo_suppkey = supplier.s_key "
             "JOIN dates ON lineorder.lo_orderdate = dates.d_key "
             "WHERE d_year = {y} GROUP BY s_region")


def _tenant(svc, wl, backend, nl=None, name=None):
    """A tenant registered as ``serve.build_tenant`` registers one, over
    ``backend`` (and named ``name``, default ``serve.TENANT``)."""
    from repro_torch.core.cache import SemanticCache
    from repro_torch.core.safety import SafetyPolicy
    from repro_torch.launch import serve

    return svc.register_tenant(
        name or serve.TENANT, schema=wl.schema, backend=backend, nl=nl,
        cache=SemanticCache(wl.schema, level_mapper=wl.dataset.level_mapper()),
        policy=SafetyPolicy.balanced(wl.spatial_ambiguous))


def _peak_bytes(executor, sigs) -> tuple[int, list]:
    """Device bytes allocated at the peak of ``executor.execute_batch(sigs)``
    above what was allocated before it, and the tables.  Python's cyclic
    garbage (executors hold their memos' eviction callbacks) is collected
    before and the collector held off during the call: tensors of earlier
    work freed inside the window would lower the peak below the base."""
    import gc

    import torch

    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    gc.disable()
    try:
        tables = executor.execute_batch(sigs)
        torch.cuda.synchronize()
    finally:
        gc.enable()
    return torch.cuda.max_memory_allocated() - base, tables


def staging_overlap(trace: str) -> dict:
    """From a ``torch.profiler`` chrome trace: the device work on streams
    that launched no seg_agg kernel (the scan plane's staging streams), and
    how much of it ran while a seg_agg kernel ran on another stream."""
    with open(trace) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X" and "stream" in e.get("args", {})
                  and e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    kernels = [e for e in events if e["cat"] == "kernel" and "seg_agg" in e["name"]]
    scan_streams = {e["args"]["stream"] for e in kernels}
    staged = [e for e in events if e["args"]["stream"] not in scan_streams]

    def during_scan(e) -> bool:
        return any(k["ts"] < e["ts"] + e["dur"] and e["ts"] < k["ts"] + k["dur"]
                   for k in kernels)

    overlapped = [e for e in staged if during_scan(e)]
    copies = [e for e in staged if e["cat"] == "gpu_memcpy"]
    return {"scan_streams": len(scan_streams),
            "staging_streams": len({e["args"]["stream"] for e in staged}),
            "seg_agg_kernels": len(kernels), "staging_ops": len(staged),
            "staging_copies": len(copies), "staging_copy_mb": sum(
                e["args"].get("bytes", 0) for e in copies) / 1e6,
            "overlapped_ops": len(overlapped),
            "overlapped_copies": sum(e["cat"] == "gpu_memcpy" for e in overlapped),
            "overlapped_us": sum(e["dur"] for e in overlapped),
            "staging_overlapped_a_scan": bool(overlapped)}


def scan_phase(wl, oracle) -> dict:
    """The scan plane on the card: a fresh tenant over ``OlapExecutor(ds,
    partitions=4, max_device_rows=1 << 20)`` on the SSB dataset serves the
    SSB SQL stream (its first batch under ``torch.profiler``), the drill
    stream, the 6-tile dashboard, the host-mask request (kernel A on every
    chunk) and a ``COUNT(DISTINCT)`` request (the fallback); then one batch
    of four new tiles with ``backend.partial`` injected once.  Peak device
    memory of the dashboard batch, streamed and unpartitioned, each on a
    fresh mirror."""
    import tempfile

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.sql_canon import SQLCanonicalizer
    from repro_torch.kernels.binding import launch_counts, reset_launch_counts
    from repro_torch.launch import serve
    from repro_torch.olap import scan_plane
    from repro_torch.olap.executor import OlapExecutor
    from repro_torch.resilience import faults
    from repro_torch.service import CacheService

    n = wl.dataset.fact.num_rows
    svc = CacheService()
    backend = OlapExecutor(wl.dataset, partitions=SCAN_PARTITIONS,
                           max_device_rows=SCAN_CHUNK_ROWS, device="cuda")
    tenant = _tenant(svc, wl, backend)
    batches = [(name, reqs[i:i + 8]) for name, reqs in serve.sql_streams(wl).items()
               for i in range(0, len(reqs), 8)]
    batches += [("dashboard", [DASHBOARD.format(y=y) for y in range(1992, 1998)]),
                ("host_mask", [HOST_MASK]), ("distinct", [DISTINCT])]
    spec = _fire_once_spec("backend.partial")
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts):  # the tracer's start-up stays out of the window
        torch.ones(1, device="cuda").add_(1)
        torch.cuda.synchronize()
    reset_launch_counts()
    results = []
    t0 = time.perf_counter()
    with FusedShapes() as shapes, ThreadLaunches() as threads, \
            tempfile.TemporaryDirectory() as tmp:
        threads.batch = 0
        with profile(activities=acts) as prof:
            results += serve.replay(svc, batches[0][1])
            torch.cuda.synchronize()
        profiled_ms = (time.perf_counter() - t0) * 1e3
        prof.export_chrome_trace(f"{tmp}/scan.json")
        overlap = staging_overlap(f"{tmp}/scan.json")
        busy_ms = sum(ms for ms, _ in _device_ops(prof).values())
        for i, (_, reqs) in enumerate(batches[1:], 1):
            threads.batch = i
            results += serve.replay(svc, reqs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = launch_counts()
        # before the fault: its first attempt scans three partitions of four
        st = backend.stats()

        # one partition worker dies, then the retry
        threads.batch = "fault"
        retries0 = tenant.stats.retries
        before = launch_counts()
        with faults.scoped(spec) as armed:
            faulted = serve.replay(svc, [SCAN_TILE.format(y=y) for y in range(1993, 1997)])
            fired = dict(armed.counts()["fired"])
        torch.cuda.synchronize()
        after = launch_counts()
    uncontained(tenant, results + faulted, "[scan]")
    if sum(shapes.counts.values()) != after["seg_agg_fused"]:
        raise AssertionError(f"{sum(shapes.counts.values())} kernel B shapes recorded for "
                             f"{after['seg_agg_fused']} launches")
    checked = oracle.check(results + faulted)
    if fired != {"backend.partial": 1} or tenant.stats.retries - retries0 != 1 \
            or [r.status for r in faulted] != ["miss"] * 4 \
            or not all("retry:1" in r.provenance for r in faulted) \
            or after["seg_agg_fused"] - before["seg_agg_fused"] < 1:
        raise AssertionError(f"backend.partial: fired {fired}, "
                             f"{[(r.status, r.provenance) for r in faulted]}, "
                             f"launches {before} -> {after}")
    if not (launches["seg_agg"] and launches["seg_agg_fused"]):
        raise AssertionError(f"a kernel was never launched by [scan]: {launches}")

    plan = scan_plane.plan_scan(n, SCAN_PARTITIONS, SCAN_CHUNK_ROWS)
    per = st["per_partition"]
    scans = {p["rows_scanned"] // (p["end"] - p["start"]) for p in per}
    if not (st["partitioned_scans"] > 0 and st["streaming_chunks"] > 0
            and st["partition_fallbacks"] > 0) or len(per) != SCAN_PARTITIONS \
            or [len(c) for c in plan.chunks] != [2] * SCAN_PARTITIONS \
            or [(p["start"], p["end"]) for p in per] != [(c[0][0], c[-1][1]) for c in plan.chunks] \
            or len(scans) != 1 or sum(p["rows_scanned"] for p in per) != n * min(scans) \
            or any(p["rows_scanned"] != (p["end"] - p["start"]) * min(scans) for p in per):
        raise AssertionError(f"scan plane stats: {json.dumps(st)}")
    parallel = []
    for batch, calls in threads.detail.items():
        part = {(th, stream) for th, stream, _, _ in calls if th.startswith("scan-part")}
        if len({th for th, _ in part}) >= 2 and len({s for _, s in part}) >= 2:
            parallel.append(batch)
    if not parallel:
        raise AssertionError("no shared scan launched on two streams from two scan-part threads")
    rows = sorted({r for calls in threads.detail.values() for *_, r in calls})
    per_req = [sum(r.timings_ms.values()) for r in results]
    misses = [r.timings_ms["execute"] for r in results if r.status == "miss" and not r.deduped]

    sigs = [SQLCanonicalizer(wl.schema).canonicalize(DASHBOARD.format(y=y))
            for y in range(1992, 1998)]
    peak = {}
    for what, kw in (("streamed", {"partitions": SCAN_PARTITIONS,
                                   "max_device_rows": SCAN_CHUNK_ROWS}),
                     ("unpartitioned", {})):
        ex = OlapExecutor(wl.dataset.slice_rows(0, n), device="cuda", **kw)
        peak[what], tables = _peak_bytes(ex, sigs)
        del ex
        for sig, t in zip(sigs, tables):
            if not t.equals(oracle.truth_of(sig)):
                raise AssertionError(f"{what} dashboard table differs from the oracle")
    if not 0 < peak["streamed"] < peak["unpartitioned"]:
        raise AssertionError(f"streamed peak {peak['streamed']} bytes is not above 0 and "
                             f"below the unpartitioned {peak['unpartitioned']}")
    return {"launches": launches, "fused_shapes": shapes.counts, "summary": {
        "partitions": SCAN_PARTITIONS, "max_device_rows": SCAN_CHUNK_ROWS,
        "device_count": torch.cuda.device_count(),
        "pinned_devices": None if backend._scan_devices() is None
        else [str(d) for d in backend._scan_devices()],
        "chunks": [list(map(list, c)) for c in plan.chunks],
        "requests": len(results), "batches": len(batches), "statuses": _statuses(results),
        "hit_rate": tenant.cache.stats.hit_rate, **checked,
        "partitioned_scans": st["partitioned_scans"],
        "partition_fallbacks": st["partition_fallbacks"],
        "streaming_chunks": st["streaming_chunks"], "per_partition": per,
        "kernel_rows": rows, "batches_on_2_streams_from_2_threads": len(parallel),
        "streams_of_first": sorted({s for _, s, _, _ in threads.detail[parallel[0]]}),
        "threads_of_first": sorted({t for t, _, _, _ in threads.detail[parallel[0]]}),
        "peak_bytes": peak, "peak_ratio": peak["streamed"] / peak["unpartitioned"],
        "first_batch": {"wall_ms": profiled_ms, "device_ms": busy_ms,
                        "device_busy_share": busy_ms / profiled_ms, **overlap},
        "fault": {"spec": spec, "fired": fired, "statuses": _statuses(faulted),
                  "kernel_b_launches": after["seg_agg_fused"] - before["seg_agg_fused"]},
        "request_ms_p50": float(np.percentile(per_req, 50)),
        "request_ms_p95": float(np.percentile(per_req, 95)),
        "miss_execute_ms_p50": float(np.percentile(misses, 50)),
        "miss_execute_ms_p95": float(np.percentile(misses, 95)),
        "wall_s": wall}}


# --------------------------------------------------------------- refresh


REFRESH_ROWS = 6_000  # TPC-H's RF1 insert at SF1: 1,500 orders of about 4 lines


def refresh_phase(n_fact: int, seed: int) -> dict:
    """Incremental refresh on the card: a tenant on an SSB dataset of its
    own serves the SSB SQL stream and the host-mask request, then
    ``advance_snapshot(delta=...)`` appends ``REFRESH_ROWS`` rows; the
    delta scan's kernel launches (kernels A and B) must all be on those
    rows, the recompute fallbacks' on the grown table; the stream again,
    every table against the oracle over the appended dataset."""
    import numpy as np
    import torch

    from repro_torch.examples.data import make_delta
    from repro_torch.kernels.binding import launch_counts, reset_launch_counts
    from repro_torch.launch import serve
    from repro_torch.service import CacheService
    from repro_torch.workloads import ssb

    rwl = ssb.build(n_fact=n_fact, seed=seed)
    svc = CacheService()
    tenant = serve.build_tenant(svc, rwl, device="cuda")
    sqls = serve.sql_streams(rwl)["ssb_sql"] + [HOST_MASK]
    t0 = time.perf_counter()
    served = serve.replay(svc, sqls)
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    delta = make_delta(rwl.dataset, REFRESH_ROWS, np.random.default_rng(seed))
    backend = tenant.backend
    real = backend.execute_batch
    with FusedShapes() as shapes, ThreadLaunches() as threads:
        def labelled(sigs, partition=None):
            threads.batch = "recompute" if partition is None else "delta"
            return real(sigs, partition=partition)

        backend.execute_batch = labelled
        try:
            reset_launch_counts()
            t0 = time.perf_counter()
            rep = svc.advance_snapshot(serve.TENANT, snapshot_id="rf1", delta=delta)
            torch.cuda.synchronize()
            refresh_ms = (time.perf_counter() - t0) * 1e3
            launches = launch_counts()
        finally:
            del backend.execute_batch
    n = rwl.dataset.fact.num_rows
    delta_rows = {r for *_, r in threads.detail["delta"]}
    delta_kernels = {k for _, _, k, _ in threads.detail["delta"]}
    full_rows = {r for *_, r in threads.detail["recompute"]}
    if rep.appended_rows != REFRESH_ROWS or rep.refreshed < 1 or delta_rows != {REFRESH_ROWS} \
            or delta_kernels != {"seg_agg_cuda", "seg_agg_fused_cuda"} \
            or full_rows - {n} or bool(full_rows) != (rep.recomputed > 0) \
            or rep.delta_rows_scanned % REFRESH_ROWS:
        raise AssertionError(f"refresh: {rep}, delta scan rows {delta_rows} kernels "
                             f"{delta_kernels}, recompute rows {full_rows}")
    t0 = time.perf_counter()
    replayed = serve.replay(svc, sqls)
    torch.cuda.synchronize()
    replay_s = time.perf_counter() - t0
    uncontained(tenant, served + replayed, "[refresh]")
    checked = Oracle(rwl).check(replayed)
    refreshed = [r for r in replayed if r.hit and "snapshot:rf1" in r.provenance]
    if not refreshed:
        raise AssertionError("no refreshed entry was served after the delta")
    return {"launches": launches, "fused_shapes": shapes.counts, "summary": {
        "n_fact": n_fact, "appended_rows": rep.appended_rows, "report": rep.to_dict(),
        "delta_scan_rows": sorted(delta_rows), "delta_scan_launches": len(threads.detail["delta"]),
        "recompute_launches": len(threads.detail["recompute"]),
        "served_statuses": _statuses(served), "replayed_statuses": _statuses(replayed),
        "refreshed_hits_served": len(refreshed), **checked,
        "serve_s": serve_s, "refresh_ms": refresh_ms, "replay_s": replay_s}}


# ------------------------------------------------------------- workloads


TPCDS_ROWS = 2_880_404  # TPC-DS SF1's store_sales rows
TLC_ROWS = 3_066_766  # NYC TLC yellow-taxi trips, January 2023
BIRDLIKE = 150


def workloads_phase(ssb_wl, ssb_oracle, seed: int) -> dict:
    """The paper's other benchmarks on the card: TPC-DS at SF1's
    store_sales rows and NYC TLC at January 2023's yellow-taxi trips, each
    built by the port's generator, each SQL stream through a tenant at
    ``partitions=1``; then the adversarial set (Table 2) and a BIRD-like set
    of ``BIRDLIKE`` NL queries, each through one tenant per schema with
    ``MemoizedNL(SimulatedLLM)`` behind the balanced safety policy.  Every
    table against the numpy oracle (no false hit); the gate's counts and
    the canonicalizations' scores printed."""
    import collections

    import numpy as np
    import torch

    from repro_torch.core.nl_canon import MemoizedNL, SimulatedLLM
    from repro_torch.kernels.binding import launch_counts, reset_launch_counts
    from repro_torch.launch import serve
    from repro_torch.olap.executor import OlapExecutor
    from repro_torch.service import CacheService, QueryRequest
    from repro_torch.workloads import adversarial, birdlike, nyc_tlc, tpcds

    t0 = time.perf_counter()
    wls = {"ssb": ssb_wl, "tpcds": tpcds.build(n_fact=TPCDS_ROWS, seed=seed),
           "nyc_tlc": nyc_tlc.build(n_fact=TLC_ROWS, seed=seed)}
    oracles = {"ssb": ssb_oracle, "tpcds": Oracle(wls["tpcds"]),
               "nyc_tlc": Oracle(wls["nyc_tlc"])}
    out = {"build_s": time.perf_counter() - t0}
    launches = collections.Counter()
    with FusedShapes() as shapes:
        for name in ("tpcds", "nyc_tlc"):
            w = wls[name]
            svc = CacheService()
            tenant = serve.build_tenant(svc, w, device="cuda")
            sqls = serve.sql_streams(w)[f"{name}_sql"]
            reset_launch_counts()
            t0 = time.perf_counter()
            results = serve.replay(svc, sqls)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            got = launch_counts()
            uncontained(tenant, results, f"[workloads] {name}")
            if not got["seg_agg_fused"]:
                raise AssertionError(f"[workloads] {name}: no kernel B launch: {got}")
            launches.update(got)
            per_req = [sum(r.timings_ms.values()) for r in results]
            out[name] = {"n_fact": w.dataset.fact.num_rows, "requests": len(results),
                         "statuses": _statuses(results), "hit_rate": tenant.cache.stats.hit_rate,
                         **oracles[name].check(results), "launches": got,
                         "backend_executions": tenant.backend.executions,
                         "rows_scanned": tenant.backend.rows_scanned,
                         "request_ms_p50": float(np.percentile(per_req, 50)),
                         "request_ms_p95": float(np.percentile(per_req, 95)), "wall_s": wall}
        for set_name, qs in (("adversarial", adversarial.build()),
                             ("birdlike", birdlike.build(BIRDLIKE))):
            svc = CacheService()
            tenants = {name: _tenant(svc, w, OlapExecutor(w.dataset, device="cuda"),
                                     nl=MemoizedNL(SimulatedLLM(w.vocab)), name=name)
                       for name, w in wls.items()}
            reqs = [QueryRequest(nl=q.text, tenant=q.schema) for q in qs]
            reset_launch_counts()
            results = []
            for i in range(0, len(reqs), 8):
                results += svc.submit_batch(reqs[i:i + 8])
            torch.cuda.synchronize()
            got = launch_counts()
            launches.update(got)
            checked = {"tables_checked": 0, "false_hits": 0}
            for name, tenant in tenants.items():
                mine = [r for q, r in zip(qs, results) if q.schema == name]
                uncontained(tenant, mine, f"[workloads] {set_name} {name}")
                checked["tables_checked"] += oracles[name].check(mine)["tables_checked"]
            llms = {name: SimulatedLLM(w.vocab) for name, w in wls.items()}
            score = adversarial.score(qs, [llms[q.schema].canonicalize(q.text, now=None)
                                           for q in qs])
            totals = collections.Counter()
            for bucket in score["per_type"].values():
                totals.update(bucket)
            if set_name == "adversarial" and \
                    (totals["correct"], totals["wrong"], totals["invalid"]) != (28, 30, 5):
                raise AssertionError(f"adversarial scores {dict(totals)}, Table 2 has 28/30/5")
            out[set_name] = {"queries": len(qs), "statuses": _statuses(results), **checked,
                             "nl_gated": sum(t.stats.nl_gated for t in tenants.values()),
                             "bypasses": sum(t.stats.bypasses for t in tenants.values()),
                             "by_schema": {name: _statuses([r for q, r in zip(qs, results)
                                                            if q.schema == name])
                                           for name in wls},
                             "score": dict(totals), "score_by_type": score["per_type"],
                             "launches": got}
    return {"launches": launches, "fused_shapes": shapes.counts, "summary": out}


# ----------------------------------------------------------------- train

# (rtol, atol) of the backward kernel against ``mha_bwd_ref`` on the inputs'
# exact float32 values.  float32: only the order of f32 sums differs.
# bfloat16: the products take bf16 operands (exact) with P and dS split into
# bf16 hi + lo (~16 bits), D = rowsum(dO * O) comes from the forward's bf16
# output, and dq, dk, dv are rounded once (2**-9 relative); at the training
# shapes the plain rehearsal of that arithmetic (``flash_bwd_tiled_ref``)
# lies up to 0.012 past rtol 1e-2 on gradients up to 20 (P and dS as bf16
# hi alone: 0.025), and a lost tile would be off by whole units
BWD_TOL = {"float32": (1e-3, 1e-3), "bfloat16": (1e-2, 2e-2)}
# examples/train_canonicalizer.py --full, the reference's production path
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS, TRAIN_CKPT_EVERY = 16, 192, 300, 50
TRAIN_PROFILE_STEPS = 3  # train steps traced by torch.profiler after the run


def _bwd_check(dev, gen, b, h, hkv, s, dh, dtype, causal, what: str) -> float:
    """The forward kernel whose output the backward takes against
    ``mha_ref`` (``ATTN_TOL``), then the backward kernel at the same shape
    against ``mha_bwd_ref`` on the inputs' exact float32 values
    (``BWD_TOL``), and a second call bit for bit the first (no atomics)."""
    import torch

    from repro_torch.kernels.flash_attn import kernel as FK
    from repro_torch.kernels.flash_attn import ref as FR

    q, do = (torch.randn(b, h, s, dh, generator=gen, device=dev).to(dtype) for _ in range(2))
    k, v = (torch.randn(b, hkv, s, dh, generator=gen, device=dev).to(dtype) for _ in range(2))
    o = FK.flash_attention_cuda(q, k, v, causal=causal)
    compare(o, FR.mha_ref(*_f32(q, k, v), causal=causal), f"{what} forward",
            *ATTN_TOL[str(dtype).removeprefix("torch.")])
    got = FK.flash_attention_bwd_cuda(q, k, v, o, do, causal=causal)
    want = FR.mha_bwd_ref(*_f32(q, k, v, do), causal=causal)
    tol = BWD_TOL[str(dtype).removeprefix("torch.")]
    err = max(compare(g, w, f"{what} {n}", *tol) for n, g, w in zip(("dq", "dk", "dv"), got, want))
    again = FK.flash_attention_bwd_cuda(q, k, v, o, do, causal=causal)
    if not all(torch.equal(x, y) for x, y in zip(got, again)):
        raise AssertionError(f"{what}: two calls differ")
    return err


def bwd_checks(dev, gen) -> dict:
    """Max abs error of the backward kernel by dtype: at the training shape
    (q (16,12,192,64), k/v (16,4,192,64)), over the forward sweep's GQA
    groups and tile edges at head dims 64 and 128, and at every other head
    dim at the heads of ``HEAD_DIM_HEADS``; causal and not."""
    import torch

    errs = {"float32": 0.0, "bfloat16": 0.0}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).removeprefix("torch.")
        cases = [(TRAIN_BATCH, 12, 4, TRAIN_SEQ, 64, True)]
        cases += [(2, 2 * g, 2, s, dh, c) for dh in (64, 128) for g in (1, 2, 3, 4, 8)
                  for s in (1, 2, 63, 64, 65, 77, 96, 129, 512, 1000) for c in (False, True)]
        cases += [(1 if h > 16 else 2, h, hkv, s, dh, c)
                  for dh, h, hkv in HEAD_DIM_HEADS
                  for s in (1, 63, 64, 65, 129, 512) for c in (False, True)]
        for b, h, hkv, s, dh, causal in cases:
            errs[name] = max(errs[name], _bwd_check(
                dev, gen, b, h, hkv, s, dh, dtype, causal,
                f"flash_bwd {name} q ({b},{h},{s},{dh}) Hkv {hkv} causal={causal}"))
    torch.cuda.synchronize()
    return errs


def _bwd_work(b: int, h: int, hkv: int, s: int, dh: int) -> dict:
    """Bytes and operations one causal bf16 backward call needs: q, k, v, o
    and dO read once, dq, dk and dv written once; the logits recomputed and
    the four gradient products, each 2 Dh per valid (causal) pair."""
    return {"bytes": 2 * (4 * b * h * s * dh + 4 * b * hkv * s * dh),
            "ops": 10 * b * h * (s * (s + 1) // 2) * dh}


# the backward's shapes beside the training shape (q (16,12,192,64), k/v
# (16,4,192,64)): qwen3-moe-235b-a22b's attention (64/4 heads of 128) and
# zamba2-7b's shared block (32/32 heads of 112), at the same batch and S
BWD_MORE = ((64, 4, 128), (32, 32, 112))


def _bwd_at(dev, gen, b, h, hkv, s, dh, iters: int) -> dict:
    """The bf16 backward kernel at one causal shape: checked, then kernel,
    plain version and the backward of SDPA (``torch.autograd.grad`` of its
    output, the forward run before the timing) timed, with the bound."""
    import torch

    from repro_torch.kernels.flash_attn import kernel as FK
    from repro_torch.kernels.flash_attn import ref as FR

    bf = torch.bfloat16
    q, do = (torch.randn(b, h, s, dh, generator=gen, device=dev).to(bf) for _ in range(2))
    k, v = (torch.randn(b, hkv, s, dh, generator=gen, device=dev).to(bf) for _ in range(2))
    o = FK.flash_attention_cuda(q, k, v)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = _sdpa_prefill(*leaves)

    def sdpa_bwd():
        return torch.autograd.grad(out, leaves, do, retain_graph=True)

    err = _bwd_check(dev, gen, b, h, hkv, s, dh, bf, True, f"flash_bwd dh {dh} {h}/{hkv}")
    return with_bound({
        "shape": f"q ({b},{h},{s},{dh}) k/v ({b},{hkv},{s},{dh}) bf16 causal",
        "max_abs_err": err,
        **timed((FK.flash_attention_bwd_cuda, (q, k, v, o, do)),
                (FR.mha_bwd_ref, (q, k, v, do)), (sdpa_bwd, ()), iters),
        **_bwd_work(b, h, hkv, s, dh)}, BF16_OPS_PER_S)


def bwd_times(dev, gen, iters: int) -> dict:
    """The bf16 backward kernel at the training shape (``_bwd_at``), and in
    ``more`` at ``BWD_MORE``'s shapes."""
    import torch

    main = _bwd_at(dev, gen, TRAIN_BATCH, 12, 4, TRAIN_SEQ, 64, iters)
    main["more"] = [_bwd_at(dev, gen, TRAIN_BATCH, h, hkv, TRAIN_SEQ, dh, iters)
                    for h, hkv, dh in BWD_MORE]
    torch.cuda.synchronize()
    return main


MOE_TRAIN_STEPS = 2  # steps of reduced kimi-k2-1t-a32b trained on the card


def moe_train_check(seed: int, batches) -> dict:
    """``reduced("kimi-k2-1t-a32b")`` (a dense layer, then an MoE layer;
    bf16, the head widened to the tokenizer) trained ``MOE_TRAIN_STEPS``
    steps on the card through ``train_lib.train``: every logged loss
    finite, one ``flash_attn`` and one ``flash_attn_bwd`` per attention
    layer per step; then one train step run twice from the same state
    gives the same loss, norm, parameters and moments bit for bit."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs.registry import reduced
    from repro_torch.kernels.binding import launch_counts, reset_launch_counts
    from repro_torch.models import transformer as tt
    from repro_torch.training.checkpoint import flatten_with_paths
    from repro_torch.training.optimizer import init_opt_state
    from repro_torch.training.train_lib import TrainConfig, checkpoint_tree, make_train_step, train

    base = reduced("kimi-k2-1t-a32b")
    cfg = dataclasses.replace(base, vocab=max(base.vocab, batches.tok.vocab_size))
    params = tt.init_params(cfg, seed, device="cuda")
    tcfg = TrainConfig(steps=MOE_TRAIN_STEPS, log_every=1)
    logs: list[str] = []
    reset_launch_counts()
    out = train(cfg, tcfg, batches, params=params, log=logs.append)
    torch.cuda.synchronize()
    launches = launch_counts()
    losses = [h["loss"] for h in out["history"]]
    if len(losses) != MOE_TRAIN_STEPS or not all(np.isfinite(losses)):
        raise AssertionError(f"kimi-k2 (reduced) losses {losses}")
    want = cfg.n_layers * MOE_TRAIN_STEPS
    if (launches["flash_attn"], launches["flash_attn_bwd"]) != (want, want):
        raise AssertionError(f"kimi-k2 (reduced): {MOE_TRAIN_STEPS} steps launched "
                             f"{dict(launches)}, not {want} of each")
    step_fn = make_train_step(cfg, tcfg)
    runs = [step_fn(params, init_opt_state(params), batches.batch_at(0)) for _ in range(2)]
    for i, what in ((0, "loss"), (1, "gnorm")):
        if not torch.equal(runs[0][i], runs[1][i]):
            raise AssertionError(f"kimi-k2 (reduced): a repeated step's {what} differs")
    trees = [flatten_with_paths(checkpoint_tree(cfg, r[2], r[3])) for r in runs]
    for (name, a), (_, b) in zip(*trees):
        if not (torch.equal(a, b) if isinstance(a, torch.Tensor) else np.array_equal(a, b)):
            raise AssertionError(f"kimi-k2 (reduced): a repeated step's {name} differs")
    return {"config": {k: getattr(cfg, k) for k in (
                "n_layers", "dense_layers", "d_model", "n_heads", "kv_heads", "n_experts",
                "top_k", "vocab")},
            "losses": losses, "launches": dict(launches), "leaves": len(trees[0]),
            "repeat_bit_identical": True}


class RecordingBatches:
    """A ``BatchIterator`` that records the steps asked of it and the first
    batch it gave."""

    def __init__(self, inner):
        self.inner, self.steps, self.first = inner, [], None

    def batch_at(self, step: int) -> dict:
        out = self.inner.batch_at(step)
        if self.first is None:
            self.first = out
        self.steps.append(step)
        return out


def _held_out(wl, engine) -> dict:
    """``repro_torch.examples.train_canonicalizer.held_out`` (the example's
    held-out evaluation: the last of 40 paraphrases, seed 777 + i, of each
    of the first 8 intents, one at a time through a ``CanonicalizerService``,
    JSON-constrained): parseable signatures and exact intent matches; and,
    as a diagnostic, the same prompts decoded greedily without the
    constraint and parsed the same way."""
    import contextlib
    import io
    import json as _json

    from repro_torch.core.signature import signature_from_json
    from repro_torch.examples.train_canonicalizer import held_out

    with contextlib.redirect_stdout(io.StringIO()):  # its lines are the example's
        asked = held_out(wl, engine)
    free = [0, 0]
    first = []
    for a in asked["answers"]:
        g = engine.generate([f"question: {a['text']}\nsignature: "],
                            max_new_tokens=MAX_NEW_TOKENS, constrained=False)[0]
        raw = engine.tok.decode(g["tokens"])  # specials dropped
        try:
            obj = _json.loads(raw)
            obj.setdefault("schema", wl.schema.name)
            sig = signature_from_json(obj)
        except Exception:  # noqa: BLE001 - malformed output counts as unparsed
            sig = None
        free[0] += sig is not None
        free[1] += sig is not None and sig.key() == a["gold"]
        first.append(raw[:80])
    return {"questions": asked["questions"],
            "constrained": {"parsed": asked["parsed"], "exact": asked["exact"]},
            "unconstrained": {"parsed": free[0], "exact": free[1]},
            "first_answers": {"constrained": asked["answers"][0]["raw_json"][:80],
                              "unconstrained": first[0]}}


def train_phase(wl, oracle, seed: int, dev, gen, iters: int) -> dict:
    """[train]: the backward kernel's checks and times, then canonicalizer-100m
    trained at full width and depth through ``train_lib.train`` on SSB
    pairs (batch 16, sequence 192), 150 steps and, after a restart, 150
    more that resume from the checkpoint of step 149; then the checkpoint
    served through ``launch.serve.served_model``, the launcher's restore
    path and tokenizer."""
    import tempfile

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs.registry import get
    from repro_torch.core.nl_canon import MemoizedNL
    from repro_torch.core.sql_canon import SQLCanonicalizer
    from repro_torch.kernels.binding import launch_counts, reset_launch_counts
    from repro_torch.launch import serve
    from repro_torch.models import transformer as tt
    from repro_torch.models.convert import params_to_jax
    from repro_torch.serving.engine import CanonicalizerService, ServingEngine
    from repro_torch.training.checkpoint import flatten_with_paths
    from repro_torch.training.data import BatchIterator, build_pairs
    from repro_torch.training.optimizer import init_opt_state
    from repro_torch.training.tokenizer import build_tokenizer
    from repro_torch.training.train_lib import (TrainConfig, loss_and_grads,
                                                make_train_step, restore_train_state,
                                                train)
    from repro_torch.workloads import ssb

    t0 = time.perf_counter()
    sweep = bwd_checks(dev, gen)
    times = bwd_times(dev, gen, iters)
    checks_s = time.perf_counter() - t0

    cfg = get("canonicalizer-100m")
    small = ssb.build(n_fact=2000, seed=seed)  # the pairs and the tokenizer need no rows
    tok = build_tokenizer([small])
    batches = BatchIterator(build_pairs([small], paraphrases_per_intent=24), tok,
                            batch=TRAIN_BATCH, seq_len=TRAIN_SEQ)
    moe = moe_train_check(seed, batches)
    params = tt.init_params(cfg, seed, device="cuda")
    n_params = sum(t.numel() for _, t in flatten_with_paths(params_to_jax(cfg, params)))

    # after a first step's backward every attention projection has a gradient
    reset_launch_counts()
    loss0, grads = loss_and_grads(cfg, params, batches.batch_at(0))
    per_step = launch_counts()
    for i, lg in enumerate(grads["layers"]):
        for name in ("wq", "wk", "wv"):
            g = lg[name]
            if g is None or not bool(torch.isfinite(g).all()):
                raise AssertionError(f"layer {i} {name}: gradient missing or not finite")
    if (per_step["flash_attn"], per_step["flash_attn_bwd"]) != (cfg.n_layers, cfg.n_layers):
        raise AssertionError(f"one step launched {dict(per_step)}")
    del grads

    half = TRAIN_STEPS // 2
    extra = {"arch": cfg.name, "reduced": False, "tokenizer_workloads": ["ssb"]}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ckpt_") as ck:
        def tcfg(steps):
            return TrainConfig(steps=steps, ckpt_dir=ck, ckpt_every=TRAIN_CKPT_EVERY,
                               ckpt_keep=2, log_every=10)

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        resident = torch.cuda.memory_allocated()  # earlier phases' engines and mirrors
        reset_launch_counts()
        logs: list[str] = []
        t1 = time.perf_counter()
        first = train(cfg, tcfg(half), batches, params=params, log=logs.append, extra=extra)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t1
        # the restart: the state the second run resumes from is the saved one
        restored = restore_train_state(cfg, ck, first["params"],
                                       init_opt_state(first["params"]))
        if restored is None or restored[2] != half - 1:
            raise AssertionError(f"no checkpoint of step {half - 1} to resume from")
        for (name, a), (_, b) in zip(flatten_with_paths(params_to_jax(cfg, restored[0])),
                                     flatten_with_paths(params_to_jax(cfg, first["params"]))):
            if a.dtype != b.dtype or not torch.equal(a, b):
                raise AssertionError(f"restored {name} differs from the saved one")
        del restored
        rec = RecordingBatches(batches)
        resumed: list[str] = []
        t1 = time.perf_counter()
        second = train(cfg, tcfg(TRAIN_STEPS), rec, params=tt.init_params(cfg, seed + 1),
                       log=resumed.append, extra=extra)
        torch.cuda.synchronize()
        second_s = time.perf_counter() - t1
        launches = launch_counts()
        peak = torch.cuda.max_memory_allocated()
        if not any(f"resumed from step {half - 1}" in m for m in resumed):
            raise AssertionError(f"the second run did not resume from step {half - 1}: "
                                 f"{resumed[:2]}")
        want = batches.batch_at(half)
        if rec.steps[0] != half or not all(np.array_equal(rec.first[k], want[k])
                                           for k in want):
            raise AssertionError(f"the resumed run's first batch is not batch_at({half})")
        history = first["history"] + second["history"]
        losses = [h["loss"] for h in history]
        if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
            raise AssertionError(f"losses {losses}")
        want_launches = cfg.n_layers * TRAIN_STEPS
        if (launches["flash_attn"], launches["flash_attn_bwd"]) != (want_launches,) * 2:
            raise AssertionError(f"{TRAIN_STEPS} steps launched {dict(launches)}")

        # device time per step under torch.profiler: a few more steps
        step_fn = make_train_step(cfg, tcfg(TRAIN_STEPS))
        p, o = second["params"], second["opt_state"]
        p, o = step_fn(p, o, batches.batch_at(0))[2:4]  # warm
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for i in range(TRAIN_PROFILE_STEPS):
                p, o = step_fn(p, o, batches.batch_at(1 + i))[2:4]
            torch.cuda.synchronize()
        prof_wall = (time.perf_counter() - t1) * 1e3
        ops = _device_ops(prof)
        by_name = {k: v[0] for k, v in ops.items()}
        device_ms = sum(by_name.values())
        del p, o, first, step_fn

        # serving the checkpoint: launch.serve's restore path and tokenizer
        scfg, sp, stok, step = serve.served_model(cfg, wl, ck, device="cuda")
        if sp is None or step != TRAIN_STEPS - 1:
            raise AssertionError(f"serve restored step {step}, not {TRAIN_STEPS - 1}")
        if stok.vocab != tok.vocab or scfg != cfg:
            raise AssertionError("the served tokenizer or config differs from the trained one")
    engine = ServingEngine(scfg, sp, stok, max_len=256)
    held_out = _held_out(small, engine)
    nl = MemoizedNL(CanonicalizerService(engine, wl.schema.name))
    texts = _nl_texts(wl, NL_BATCH)
    run = _nl_batch(nl, wl, oracle, texts)  # the counts are read from the training run
    canon = SQLCanonicalizer(wl.schema)
    intent_of = {q.text: q.intent_id for q in wl.queries() if q.kind == "nl"}
    gold = {it.id: canon.canonicalize(it.sql).key() for it in wl.intents}
    answers = [r for (text, _), r in nl._memo.items() if text in texts]
    s = run["summary"]
    served = {"held_out": held_out, "ssb_nl": {
        "requests": s["requests"], "statuses": s["statuses"], "nl_gated": s["nl_gated"],
        "false_hits": s["false_hits"], "tables_checked": s["tables_checked"],
        "parsed": sum(r.signature is not None for r in answers),
        "exact": sum(r.signature is not None and r.signature.key() == gold[intent_of[t]]
                     for (t, _), r in nl._memo.items() if t in texts),
        "decode_steps": s["decode_steps"]}}
    return {"launches": launches, "bwd": {"sweep": sweep, "times": times},
            "summary": {
                "config": {k: getattr(cfg, k) for k in (
                    "n_layers", "d_model", "n_heads", "kv_heads", "head_dim", "d_ff",
                    "vocab")},
                "params": n_params, "batch": TRAIN_BATCH, "seq_len": TRAIN_SEQ,
                "steps": TRAIN_STEPS, "pairs": len(batches.pairs),
                "bwd_checks_s": checks_s, "moe_train": moe, "first_loss": float(loss0),
                "losses": [(h["step"], round(h["loss"], 4)) for h in history],
                "resumed": resumed[0],
                "launches_per_step": {"flash_attn": per_step["flash_attn"],
                                      "flash_attn_bwd": per_step["flash_attn_bwd"]},
                "step_wall_ms": (first_s + second_s) / TRAIN_STEPS * 1e3,
                "train_wall_s": {"first": first_s, "second": second_s},
                "profiled_steps": TRAIN_PROFILE_STEPS,
                "profiled_wall_ms_per_step": prof_wall / TRAIN_PROFILE_STEPS,
                "device_ms_per_step": device_ms / TRAIN_PROFILE_STEPS if by_name else None,
                "device_ops_per_step": sum(n for _, n in ops.values()) / TRAIN_PROFILE_STEPS,
                # device time per step over the unprofiled step's wall; the
                # profiler's own host cost (CPU activity on) inflates its wall
                "device_busy_share": (device_ms / TRAIN_PROFILE_STEPS * TRAIN_STEPS
                                      / ((first_s + second_s) * 1e3)) if by_name else None,
                "device_busy_share_under_profiler": (device_ms / prof_wall
                                                     if by_name else None),
                "top_device_ms": _top(by_name, 8),
                "peak_memory_allocated": peak, "peak_above_resident": peak - resident,
                "served": served}}


# -------------------------------------------------------------- examples


EXAMPLE_RESTART_STEPS = 20  # train_canonicalizer's steps after its restart
EXAMPLE_BWD = (8, 8, 4, 128, 32)  # its flash backward: q (8,8,128,32), k/v (8,4,128,32)


def _example(module, argv, **kw) -> tuple[dict, dict, float]:
    """``module.main(argv, **kw)``'s summary, the kernel launches counted
    from just before it to just after, and its wall seconds; the lines it
    prints are the example's and are not shown."""
    import collections
    import contextlib
    import io

    import torch

    from repro_torch.kernels.binding import launch_counts, reset_launch_counts

    reset_launch_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        summary = module.main(argv, **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return summary, collections.Counter({k: n for k, n in sorted(launch_counts().items())
                                         if n}), wall


def examples_phase(n_fact: int, dev, gen, iters: int) -> dict:
    """[examples]: the five ``repro_torch.examples`` on the card.  The four
    OLAP ones at their defaults, each summary equal to its ``--device cpu``
    run's (which launches nothing), each launching a seg_agg kernel;
    ``multi_pod_dryrun`` and ``quickstart`` again at ``n_fact`` rows (8
    partitions on one card's streams), their tables against the numpy
    oracle over the examples' own data (seed 0), the partitions' accounting
    scaled from the default run's; the flash backward at the reduced train
    example's shape against ``mha_bwd_ref``, then timed beside its plain
    version and SDPA's backward (``_bwd_at``); ``train_canonicalizer`` at its
    reduced default (120 steps) and, after a restart from its checkpoint in
    a temporary directory, ``EXAMPLE_RESTART_STEPS`` more: every loss
    finite, step 119's below step 0's, ``flash_attn``, ``flash_attn_bwd``
    and ``decode_attn`` launched by each run."""
    import math
    import tempfile

    from repro_torch.examples import (dashboard_session, multi_pod_dryrun, quickstart,
                                      streaming_append, train_canonicalizer)
    from repro_torch.workloads import ssb

    runs, launches = {}, {}
    for name, module in (("quickstart", quickstart), ("dashboard_session", dashboard_session),
                         ("streaming_append", streaming_append),
                         ("multi_pod_dryrun", multi_pod_dryrun)):
        card, launches[name], wall = _example(module, [])
        cpu, cpu_launches, cpu_wall = _example(module, ["--device", "cpu"])
        if card != cpu or cpu_launches:
            raise AssertionError(f"[examples] {name}: card {card}, CPU {cpu} "
                                 f"(CPU launches {cpu_launches})")
        if not launches[name]["seg_agg"] + launches[name]["seg_agg_fused"]:
            raise AssertionError(f"[examples] {name} launched no seg_agg kernel: "
                                 f"{launches[name]}")
        runs[name] = {"wall_s": wall, "cpu_wall_s": cpu_wall, "summary": card}

    oracle = Oracle(ssb.build(n_fact=n_fact, seed=0))  # the examples' own data
    served: list = []
    big, launches["multi_pod_dryrun SF1"], wall = _example(multi_pod_dryrun, [str(n_fact)],
                                                           served=served)
    checked = oracle.check(served)
    base, parts = runs["multi_pod_dryrun"]["summary"], big["per_partition"]
    if big["rows_scanned"] * base["n_fact"] != base["rows_scanned"] * n_fact \
            or [p["executions"] for p in parts] != [p["executions"] for p in base["per_partition"]] \
            or sum(p["end"] - p["start"] for p in parts) != n_fact \
            or sum(p["rows_scanned"] for p in parts) != big["rows_scanned"] \
            or (big["cold_statuses"], big["warm_statuses"]) != (["miss"], ["hit_exact"]):
        raise AssertionError(f"[examples] multi_pod_dryrun at {n_fact} rows: {big}")
    runs["multi_pod_dryrun SF1"] = {"wall_s": wall, "summary": {**big, **checked}}
    served = []
    big, launches["quickstart SF1"], wall = _example(quickstart, ["--n-fact", str(n_fact)],
                                                     served=served)
    checked = oracle.check(served)
    if big["statuses"] != runs["quickstart"]["summary"]["statuses"]:
        raise AssertionError(f"[examples] quickstart at {n_fact} rows: {big}")
    runs["quickstart SF1"] = {"wall_s": wall, "summary": {**big, **checked}}

    bwd = _bwd_at(dev, gen, *EXAMPLE_BWD, iters)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_example_") as ck:
        first, launches["train_canonicalizer"], wall = _example(
            train_canonicalizer, ["--ckpt-dir", ck])
        steps = first["steps"]
        second, launches["train_canonicalizer restart"], wall2 = _example(
            train_canonicalizer, ["--ckpt-dir", ck, "--steps", str(steps + EXAMPLE_RESTART_STEPS)])
    losses = {h["step"]: h["loss"] for h in first["history"] + second["history"]}
    if not all(map(math.isfinite, losses.values())) or not losses[steps - 1] < losses[0] \
            or second["start_step"] != steps:
        raise AssertionError(f"[examples] train_canonicalizer: losses {losses}, the restart "
                             f"started at step {second['start_step']}")
    for name, run in (("train_canonicalizer", first), ("train_canonicalizer restart", second)):
        if not all(launches[name][k] for k in ("flash_attn", "flash_attn_bwd", "decode_attn")):
            raise AssertionError(f"[examples] {name} launched {launches[name]}")
        runs[name] = {"wall_s": wall if run is first else wall2, "summary": {
            "steps": run["steps"], "start_step": run["start_step"], "pairs": run["pairs"],
            "vocab": run["vocab"], "losses": [(h["step"], round(h["loss"], 4))
                                              for h in run["history"]],
            "held_out": {k: run["held_out"][k] for k in ("questions", "parsed", "exact")}}}
    return {"runs": runs, "launches": launches, "bwd": bwd}


# --------------------------------------------------------------- dist

DIST_STEPS = 3  # train steps of canonicalizer-100m on the one-rank mesh
DIST_FAIL_AFTER = 2  # the elastic run loses its "device" after this many steps
DIST_DECODE = 8  # greedy decode steps after the sharded prefill
DIST_SSD_DEPTH = 4  # mamba2-780m's layers in the sharded prefill
DIST_PROFILE_STEPS = 2  # train steps traced per run for device ms per step
DIST_DRYRUN = (("mamba2-780m", "decode_32k", "baseline"), ("gemma-2b", "train_4k", "baseline"),
               ("gemma-2b", "train_4k", "zero3_params"))


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _same(a, b, what: str) -> None:
    """Raise unless two tensors (or trees of them) are equal bit for bit."""
    import torch

    if isinstance(a, dict):
        for k in a:
            _same(a[k], b[k], f"{what}/{k}")
    elif isinstance(a, (list, tuple)):
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{what}[{i}]")
    elif isinstance(a, torch.Tensor):
        if a.dtype != b.dtype or a.shape != b.shape or not torch.equal(a, b):
            raise AssertionError(f"[dist] {what}: the DTensor run differs from the plain one")
    elif a != b:
        raise AssertionError(f"[dist] {what}: {a} != {b}")


def _dryrun_procs(out_dir: str) -> list:
    """The dry-run launcher on the ``DIST_DRYRUN`` cells, each in a process
    of its own (the fake process group cannot share one with this one's),
    started now."""
    env = {**__import__("os").environ,
           "PYTHONPATH": str(Path(__file__).resolve().parent / "src")}
    procs = []
    for arch, shape, variant in DIST_DRYRUN:
        out = str(Path(out_dir) / f"{arch}_{shape}_{variant}.json")
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
               "--shape", shape, "--mesh", "single", "--variant", variant, "--out", out]
        procs.append((arch, shape, variant, out, subprocess.Popen(
            cmd, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    return procs


def dist_phase(seed: int, device_type: str = "cuda", backend: str = "nccl") -> dict:
    """[dist]: the port's distribution on a one-rank NCCL process group, the
    mesh ``build_mesh(plan_remesh(1, 1))`` (data 1, model 1) on the card.

    * train: canonicalizer-100m at full size on [train]'s SSB batches (16 x
      192), ``DIST_STEPS`` ``make_train_step`` steps with DTensor
      parameters and stacked ZeRO-1 moments (``shard_train_state``), and
      the same steps without DTensor: losses, norms, every parameter and
      moment equal bit for bit (one rank runs the same aten ops on the same
      local tensors), ``flash_attn`` and ``flash_attn_bwd`` launched once
      per layer per step in both runs (through ``local_map`` on the mesh);
    * zero3: the same steps with the parameters stacked in their moments'
      layout (``shard_train_state(zero3=True)``, the reference's
      ``zero3_params``), gathered at the start of each step: the same
      checks against the plain run, parameters gathered back per layer;
    * elastic: the same steps under ``ElasticController``, a
      ``DeviceLossError([])`` after step ``DIST_FAIL_AFTER`` and a restore
      from that step's checkpoint: the final parameters equal the
      uninterrupted run's bit for bit;
    * serve: 8 SSB NL prompts, prefill and ``DIST_DECODE`` greedy decode
      steps on the mesh (caches laid out by ``dryrun.cache_spec_fn``), from
      the per-layer DTensor parameters and from the ZeRO-3 ones through
      ``gather_params``: logits and tokens equal the plain run's bit for
      bit;
    * ssd: mamba2-780m at full width, ``DIST_SSD_DEPTH`` layers: prefill on
      the mesh equals the plain one, ``ssd_scan`` launched once per layer;
    * dry-run: ``python -m repro_torch.launch.dryrun`` on ``DIST_DRYRUN``
      (production single-pod mesh, a fake group of 256 in a process of its
      own, on the host's CPU): status ok, ``argument_bytes`` equal to the
      spec arithmetic.
    Wall and device ms per train step, DTensor and ZeRO-3 against plain."""
    import contextlib
    import os
    import tempfile

    import torch
    import torch.distributed as dist
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs.registry import get
    from repro_torch.distributed.elastic import (DeviceLossError, ElasticController,
                                                 build_mesh, plan_remesh)
    from repro_torch.distributed.sharding import (batch_axes, distribute_tree, gather_params,
                                                  on_mesh, shard_batch, tree_param_specs)
    from repro_torch.kernels.binding import launch_counts, reset_launch_counts
    from repro_torch.launch import dryrun
    from repro_torch.models import mamba2
    from repro_torch.models import transformer as tt
    from repro_torch.models.model import STACKS, cut_depth
    from repro_torch.training.checkpoint import save_checkpoint, wait_pending
    from repro_torch.training.data import BatchIterator, build_pairs
    from repro_torch.training.optimizer import init_opt_state
    from repro_torch.training.tokenizer import build_tokenizer
    from repro_torch.training.train_lib import (TrainConfig, checkpoint_tree,
                                                gather_train_state, make_train_step,
                                                restore_train_state, shard_train_state)
    from repro_torch.workloads import ssb

    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_dist_")
    procs = _dryrun_procs(tmp)  # on the host's CPU while the card trains
    small = ssb.build(n_fact=2000, seed=seed)
    tok = build_tokenizer([small])
    batches = BatchIterator(build_pairs([small], paraphrases_per_intent=24), tok,
                            batch=TRAIN_BATCH, seq_len=TRAIN_SEQ)
    cfg = get("canonicalizer-100m")
    tcfg = TrainConfig()
    dev = torch.device(device_type)
    dist.init_process_group(backend, init_method=f"tcp://localhost:{_free_port()}", rank=0,
                            world_size=1)
    try:
        mesh = build_mesh(plan_remesh(1, 1), device_type=device_type)
        if tuple(mesh.shape) != (1, 1) or mesh.mesh_dim_names != ("data", "model"):
            raise AssertionError(f"[dist] mesh {mesh}")

        def shard(params):
            return distribute_tree(params, tree_param_specs(params, 1, STACKS), mesh)

        params0 = tt.init_params(cfg, seed, device=dev)

        walls: list = []

        def run(step_fn, p, o, first: int = 0, steps: int = DIST_STEPS, after=None):
            out = []
            for i in range(first, steps):
                t0 = time.perf_counter()
                loss, gnorm, p, o, _ = step_fn(p, o, batches.batch_at(i))
                torch.cuda.synchronize()
                walls.append((time.perf_counter() - t0) * 1e3)
                out.append((loss, gnorm))
                if after is not None:
                    after(i, p, o)
            return p, o, out

        def whole(x):
            return x.full_tensor() if hasattr(x, "full_tensor") else x

        plain_step = make_train_step(cfg, tcfg)
        dist_step = make_train_step(cfg, tcfg, mesh=mesh)
        times, launches, runs = {}, {}, {}
        for name in ("plain", "dtensor", "zero3"):
            if name == "plain":
                p, o, step_fn = params0, init_opt_state(params0), plain_step
            else:
                (p, o), step_fn = shard_train_state(cfg, params0, mesh,
                                                    zero3=(name == "zero3")), dist_step
            reset_launch_counts()
            walls.clear()
            p, o, stats = run(step_fn, p, o)
            launches[name] = dict(launch_counts())
            result = {"params": p, "opt": o,
                      "losses": [whole(l) for l, _ in stats],
                      "gnorms": [whole(g) for _, g in stats]}
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                q, r = p, o
                for i in range(DIST_PROFILE_STEPS):
                    q, r = step_fn(q, r, batches.batch_at(DIST_STEPS + i))[2:4]
                torch.cuda.synchronize()
            device = sum(ms for ms, _ in _device_ops(prof).values())
            # the first step of a run pays one-time costs (DTensor's sharding
            # propagation): the median of the steps, and each
            times[name] = {"wall_ms_per_step": sorted(walls)[len(walls) // 2],
                           "wall_ms_by_step": list(walls),
                           "device_ms_per_step": device / DIST_PROFILE_STEPS}
            del q, r
            runs[name] = result
        plain = runs["plain"]
        want = cfg.n_layers * DIST_STEPS
        for name, c in launches.items():
            if (c.get("flash_attn", 0), c.get("flash_attn_bwd", 0)) != (want, want):
                raise AssertionError(f"[dist] {name}: {DIST_STEPS} steps launched {c}, not "
                                     f"{want} flash_attn and flash_attn_bwd")
        for name in ("dtensor", "zero3"):
            run_ = runs[name]
            _same(run_["losses"], plain["losses"], f"{name} losses")
            _same(run_["gnorms"], plain["gnorms"], f"{name} gradient norms")
            dp, do = gather_train_state(run_["params"], run_["opt"])
            _same(dp, plain["params"], f"{name} params")
            _same(do["m"], plain["opt"]["m"], f"{name} moments m")
            _same(do["v"], plain["opt"]["v"], f"{name} moments v")

        # elastic: lose the "device" after DIST_FAIL_AFTER steps, restart
        # from that step's checkpoint on a re-planned mesh
        ck = os.path.join(tmp, "ckpt")

        def save(i, p, o):
            save_checkpoint(ck, i, checkpoint_tree(cfg, *gather_train_state(p, o)))

        attempts = []

        def run_fn(mesh_):
            like = params0
            got = restore_train_state(cfg, ck, like, init_opt_state(like)) \
                if os.path.isdir(ck) else None
            first = 0 if got is None else got[2] + 1
            p, o = shard_train_state(cfg, like if got is None else got[0], mesh_,
                                     opt_state=None if got is None else got[1])
            attempts.append(first)
            step_fn = make_train_step(cfg, tcfg, mesh=mesh_)
            if ctl.restarts == 0:
                p, o, _ = run(step_fn, p, o, 0, DIST_FAIL_AFTER, after=save)
                wait_pending()
                raise DeviceLossError([])
            p, o, _ = run(step_fn, p, o, first, DIST_STEPS)
            return {"params": p, "opt": o}

        ctl = ElasticController(run_fn, model_parallel=1, device_type=device_type)
        t0 = time.perf_counter()
        out = ctl.run()
        elastic_s = time.perf_counter() - t0
        if ctl.restarts != 1 or attempts != [0, DIST_FAIL_AFTER]:
            raise AssertionError(f"[dist] elastic: restarts {ctl.restarts}, resumed at "
                                 f"{attempts}")
        ep, _ = gather_train_state(out["params"], out["opt"])
        _same(ep, plain["params"], "params after the elastic restart")

        # serve: prefill + greedy decode of 8 SSB NL prompts on the mesh
        texts = [q.text for q in small.queries() if q.kind == "nl"][:NL_BATCH]
        enc = [tok.encode(f"question: {t}\nsignature: ", add_bos=True) for t in texts]
        plen_ = max(len(e) for e in enc)
        tokens = torch.full((len(enc), plen_), tok.pad, dtype=torch.int32)
        for i, e in enumerate(enc):
            tokens[i, plen_ - len(e):] = torch.tensor(e, dtype=torch.int32)
        tokens = tokens.to(dev)
        sp = plain["params"]
        baxes = batch_axes(mesh.mesh_dim_names)
        hints = {"cache": dryrun.cache_spec_fn(cfg, baxes[0], mesh, False)}

        def serve(params, sharded: bool):
            outs = []
            on = on_mesh(mesh, hints) if sharded else contextlib.nullcontext()
            with torch.no_grad(), on:
                toks = shard_batch({"t": tokens}, mesh)["t"] if sharded else tokens
                logits, caches, pos = tt.prefill(cfg, params, tokens=toks,
                                                 cache_len=plen_ + DIST_DECODE)
                for _ in range(DIST_DECODE):
                    nxt = logits.argmax(-1).to(torch.int32)
                    outs.append((whole(logits), whole(nxt)))
                    logits, caches, pos = tt.decode_step(cfg, params, nxt, caches, pos)
            torch.cuda.synchronize()
            return outs

        reset_launch_counts()
        want_serve = serve(sp, False)
        serve_plain = dict(launch_counts())
        dparams = shard(sp)
        reset_launch_counts()
        got_serve = serve(dparams, True)
        serve_launches = dict(launch_counts())
        _same(got_serve, want_serve, "prefill and decode")
        reset_launch_counts()
        got_serve = serve(gather_params(runs["zero3"]["params"]), True)
        zero3_serve = dict(launch_counts())
        _same(got_serve, want_serve, "prefill and decode from the ZeRO-3 parameters")
        for what, c in (("serve", serve_launches), ("zero3 serve", zero3_serve)):
            if (c.get("flash_attn"), c.get("decode_attn")) != \
                    (cfg.n_layers, cfg.n_layers * DIST_DECODE):
                raise AssertionError(f"[dist] {what} launched {c}")
        del dparams, runs

        # ssd: mamba2-780m prefill at full width, cut depth
        mcfg, mparams = cut_depth(get("mamba2-780m"),
                                  mamba2.init_params(get("mamba2-780m"), seed, device=dev),
                                  DIST_SSD_DEPTH)
        mtokens = (tokens % mcfg.vocab).to(torch.int32)
        with torch.no_grad():
            reset_launch_counts()
            want_m = mamba2.prefill(mcfg, mparams, tokens=mtokens)
            torch.cuda.synchronize()
            ssd_plain = dict(launch_counts())
            dm = shard(mparams)
            reset_launch_counts()
            with on_mesh(mesh, {"cache": dryrun.cache_spec_fn(mcfg, baxes[0], mesh, False)}):
                got_m = mamba2.prefill(mcfg, dm, tokens=shard_batch({"t": mtokens}, mesh)["t"])
            torch.cuda.synchronize()
            ssd_launches = dict(launch_counts())
        got_m = (whole(got_m[0]), {k: whole(v) for k, v in got_m[1].items()}, whole(got_m[2]))
        _same(got_m, want_m, "mamba2 prefill")
        if ssd_launches.get("ssd_scan") != DIST_SSD_DEPTH:
            raise AssertionError(f"[dist] mamba2 prefill launched {ssd_launches}")
        del mparams, dm
    finally:
        dist.destroy_process_group()

    t0 = time.perf_counter()
    dry = {}
    for arch, shape, variant, out, proc in procs:
        log = proc.communicate(timeout=600)[0]
        if proc.returncode != 0:
            raise AssertionError(f"[dist] dry-run {arch} {shape} {variant} exited "
                                 f"{proc.returncode}: {log[-2000:]}")
        key = f"{arch}|{shape}|single" + ("" if variant == "baseline" else f"|{variant}")
        rec = json.load(open(out))[key]
        want_b = dryrun.argument_bytes(get(arch), shape, dryrun.MESH_SHAPES["single"], variant)
        if rec["status"] != "ok" or rec["memory"]["argument_bytes"] != want_b:
            raise AssertionError(f"[dist] dry-run {key}: {rec.get('status')}, "
                                 f"argument bytes {rec.get('memory')} vs {want_b}")
        dry[key] = {"argument_bytes": want_b, "peak_bytes": rec["memory"]["peak_bytes"],
                    "collectives": rec["collectives"]["count_by_kind"],
                    "trace_s": rec["trace_s"], "setup_s": rec["setup_s"]}
    return {"launches": {"train_plain": launches["plain"], "train": launches["dtensor"],
                         "train_zero3": launches["zero3"],
                         "serve_plain": serve_plain, "serve": serve_launches,
                         "serve_zero3": zero3_serve,
                         "ssd_plain": ssd_plain, "ssd": ssd_launches},
            "summary": {
                "mesh": dict(zip(mesh.mesh_dim_names, mesh.shape)),
                "train_steps": DIST_STEPS,
                "losses": [float(x) for x in plain["losses"]],
                "train_bit_identical": True, "zero3_bit_identical": True, "times": times,
                "elastic": {"restarts": ctl.restarts, "resumed_at": attempts,
                            "wall_s": elastic_s, "bit_identical": True},
                "serve": {"prompts": len(texts), "prompt_len": plen_,
                          "decode_steps": DIST_DECODE, "bit_identical": True},
                "ssd": {"depth": DIST_SSD_DEPTH, "bit_identical": True},
                "dryrun": dry, "dryrun_wait_s": time.perf_counter() - t0,
                "phase_s": time.perf_counter() - t_phase}}


# --------------------------------------------------------------- profile


def _cold_tenant(n_fact: int, seed: int, requests: int):
    """A fresh dataset, a ``CacheService`` with one tenant over it, that
    tenant, and the first ``requests`` SSB SQL requests."""
    from repro_torch.launch import serve
    from repro_torch.service import CacheService
    from repro_torch.workloads import ssb

    wl = ssb.build(n_fact=n_fact, seed=seed)
    svc = CacheService()
    tenant = serve.build_tenant(svc, wl, device="cuda")
    return svc, tenant, serve.sql_streams(wl, requests)["ssb_sql"]


def _device_ops(prof) -> dict[str, tuple[float, int]]:
    """(device ms, count) of every kernel and copy the profiler traced, by
    name.  A ``record_function`` range also shows on the device's timeline
    (from its first kernel's start to its last one's end): left out."""
    import torch

    ops: dict[str, tuple[float, int]] = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA \
                and not getattr(e, "is_user_annotation", False) \
                and not e.name.startswith("moe."):
            ms, n = ops.get(e.name, (0.0, 0))
            ops[e.name] = (ms + e.time_range.elapsed_us() / 1e3, n + 1)
    return ops


def _top(by_name: dict, n: int = 6) -> dict:
    return {k[:60]: v for k, v in sorted(by_name.items(), key=lambda kv: -kv[1])[:n]}


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
    svc, tenant, sqls = _cold_tenant(n_fact, seed, requests)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=acts) as prof:
        results = serve.replay(svc, sqls, batch=8)
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    uncontained(tenant, results, "[profile] torch.profiler replay")
    svc, tenant, sqls = _cold_tenant(n_fact, seed, requests)
    host = cProfile.Profile()
    results = host.runcall(serve.replay, svc, sqls, 8)
    torch.cuda.synchronize()
    uncontained(tenant, results, "[profile] cProfile replay")
    st = pstats.Stats(host).stats
    hot = sorted(st.items(), key=lambda kv: -kv[1][2])[:8]
    host_top = {f"{Path(f).name}:{ln}:{fn}": round(v[2] * 1e3, 1)
                for (f, ln, fn), v in hot}
    by_name = {k: v[0] for k, v in _device_ops(prof).items()}
    device_ms = sum(by_name.values())
    return {"requests": len(sqls), "wall_ms": wall_ms,
            "device_ms": device_ms if by_name else None,
            "device_busy_share": device_ms / wall_ms if by_name else None,
            "top_device_ms": _top(by_name),
            "host_own_ms_top": host_top}


PROFILE_STEPS = 32  # decode steps of a profiled engine batch (a trace of 128 took minutes)


def profile_engine(engine, wl, ranges: tuple = (), steps: int = PROFILE_STEPS) -> dict:
    """One more engine batch of 8 NL questions (not seen before), the
    CanonicalizerService's prompts, at most ``steps`` constrained
    decode steps, under ``torch.profiler``: device busy share of prefill +
    decode loop, device ms per decode step next to the engine's host ms per
    step, and the device ms per step of the kernels launched inside each
    ``record_function`` range named in ``ranges`` (prefill included)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    texts = _nl_texts(wl, NL_BATCH, skip=2 * NL_BATCH)
    prompts = [f"question: {t}\nsignature: " for t in texts]
    steps0, host0, model0 = engine.steps, engine.host_s, engine.model_s
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        engine.generate(prompts, max_new_tokens=steps, constrained=True)
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    steps = engine.steps - steps0
    ops = _device_ops(prof)
    by_name = {k: v[0] for k, v in ops.items()}
    device_ms = sum(by_name.values())
    return {"prompts": len(texts), "decode_steps": steps, "wall_ms": wall_ms,
            "device_ops_per_step": sum(n for _, n in ops.values()) / max(steps, 1),
            "device_ms": device_ms if by_name else None,
            "device_busy_share": device_ms / wall_ms if by_name else None,
            "device_ms_per_step": device_ms / max(steps, 1) if by_name else None,
            "host_ms_per_step": (engine.host_s - host0) / max(steps, 1) * 1e3,
            "model_ms_per_step": (engine.model_s - model0) / max(steps, 1) * 1e3,
            **({"device_ms_per_step_in": _range_ms(prof, ranges, steps)} if ranges else {}),
            "top_device_ms": _top(by_name, 8)}


def _range_ms(prof, ranges: tuple, steps: int) -> dict:
    """Device ms per step of the kernels launched inside each named
    ``record_function`` range (a range's ``device_time_total`` counts the
    kernels of the ops within it)."""
    import torch

    us = dict.fromkeys(ranges, 0.0)
    for e in prof.events():
        if e.name in us and e.device_type == torch.autograd.DeviceType.CPU:
            us[e.name] += e.device_time_total
    return {k: v / 1e3 / max(steps, 1) for k, v in us.items()}


SOURCES = {
    "seg_agg": ("src/repro_torch/kernels/seg_agg/csrc/seg_agg.cu",
                "src/repro/kernels/seg_agg/kernel.py:29 _seg_agg_kernel"),
    "seg_agg_fused": ("src/repro_torch/kernels/seg_agg/csrc/seg_agg.cu",
                      "src/repro/kernels/seg_agg/kernel.py:108 _seg_agg_fused_kernel"),
    "flash_attn": ("src/repro_torch/kernels/flash_attn/csrc/flash_attn.cu",
                   "src/repro/kernels/flash_attn/kernel.py:26 _flash_kernel"),
    "decode_attn": ("src/repro_torch/kernels/decode_attn/csrc/decode_attn.cu",
                    "src/repro/kernels/decode_attn/kernel.py:24 _decode_kernel"),
    "ssd_scan": ("src/repro_torch/kernels/ssd_scan/csrc/ssd_scan.cu",
                 "src/repro/kernels/ssd_scan/kernel.py:28 _ssd_kernel"),
    "flash_attn_bwd": ("src/repro_torch/kernels/flash_attn/csrc/flash_attn_bwd.cu",
                       "none: no Pallas kernel has a backward (jax.grad cannot pass "
                       "_flash_kernel); JAX differentiates mha_ref, "
                       "src/repro/kernels/flash_attn/ref.py:7"),
}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="PyTorch/CUDA port smoke run on one GPU")
    ap.add_argument("--n-fact", type=int, default=6_000_000)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--baseline", type=Path, default=None,
                    help="a checkout of an earlier commit (kernel A's entry without "
                         "scratch): its seg_agg and attention kernels are timed beside "
                         "this checkout's")
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
    from repro_torch.training.tokenizer import build_tokenizer
    from repro_torch.workloads import ssb

    t_all = time.perf_counter()
    card = nvidia_smi()
    t0 = time.perf_counter()
    built = build_all()
    print(f"[build] {json.dumps(built)} in {time.perf_counter() - t0:.1f} s; card: {card}")
    print(f"[build] tensor-core and kernel B instances (ptxas -v, SASS): "
          f"{json.dumps(build_info())}")
    baseline = None if args.baseline is None else Baseline(args.baseline.resolve())
    if baseline is not None:
        print(f"[build] baseline instances (ptxas -v): {json.dumps(baseline.registers)}")

    t0 = time.perf_counter()
    wl = ssb.build(n_fact=args.n_fact, seed=args.seed)
    oracle = Oracle(wl)
    print(f"[data] SSB {args.n_fact} rows from seed {args.seed} in "
          f"{time.perf_counter() - t0:.1f} s")
    plen = _prompt_len(build_tokenizer([wl]), _nl_texts(wl, NL_BATCH))

    dev = torch.device("cuda", torch.cuda.current_device())
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)
    t0 = time.perf_counter()
    errs = kernel_checks(args.n_fact, dev, gen)
    sweeps = {**attention_checks(dev, gen), "ssd_scan": ssd_checks(dev, gen)}
    times = {**kernel_times(args.n_fact, dev, gen, args.iters, baseline),
             **attention_times(dev, gen, plen, MAX_NEW_TOKENS, MAX_LEN, 10 * args.iters,
                               baseline),
             **ssd_times(dev, gen, plen, MAX_LEN, 10 * args.iters)}
    dims = head_dim_times(dev, gen, plen, MAX_LEN, 10 * args.iters)
    for name, by_dtype in sweeps.items():
        errs[name] = max(*by_dtype.values(), times[name]["max_abs_err"],
                         *(r["max_abs_err"] for r in dims if r["kernel"] == name))
    print(f"[kernels] {time.perf_counter() - t0:.1f} s; max abs err {json.dumps(errs)}; "
          f"attention and ssd sweeps by dtype {json.dumps(sweeps)}, at the main path's "
          f"shapes (bf16) {json.dumps({k: times[k]['max_abs_err'] for k in sweeps})}")

    def extra(t) -> str:
        out = "".join(f", {k} {t[k]:.5f}" for k in ("baseline_ms", "bound_f32_ms") if k in t)
        return out + (f", {t['tier']} slots" if "tier" in t else "")

    for name, t in times.items():
        if "reach" in t:  # the engine's ceiling, before its main-path line
            r = t["reach"]
            plain = f"plain {r['plain_ms']:.4f}" if "plain_ms" in r \
                else f"library {r['library_ms']:.4f}"
            print(f"[kernels] {name} reach {r['shape']}: device ms per call: kernel "
                  f"{r['ms']:.4f}, {plain}; bound {r['bound_ms']:.5f} ({r['bound_by']})"
                  f"{extra(r)}")
        for r in t.get("more", []):  # further shapes, before the main-path line
            print(f"[kernels] {name} {r['shape']}: device ms per call: kernel "
                  f"{r['ms']:.4f}, plain {r['plain_ms']:.4f}, library {r['library_ms']}; "
                  f"bound {r['bound_ms']:.5f} ({r['bound_by']}){extra(r)}")
        print(f"[kernels] {name} {t['shape']}: device ms per call: kernel "
              f"{t['ms']:.4f}, plain {t['plain_ms']:.4f}, library {t['library_ms']}; "
              f"bound {t['bound_ms']:.5f} ({t['bound_by']}){extra(t)}")
        if "host_us" in t:
            print(f"[kernels] {name} host us per call: {json.dumps(t['host_us'])}")
    for r in dims:
        print(f"[kernels] {r['kernel']} head dim {r['head_dim']} {r['shape']}: device ms per "
              f"call: kernel {r['ms']:.4f}, library {r['library_ms']:.4f}; bound "
              f"{r['bound_ms']:.5f} ({r['bound_by']}); max abs err {r['max_abs_err']:.3g}")

    t0 = time.perf_counter()
    llm = llm_phase(wl, oracle, args.seed)
    print(f"[llm] {json.dumps(llm['summary'])} launches {json.dumps(llm['launches'])} "
          f"in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    small = reduced_phase(wl, oracle, args.seed)
    print(f"[reduced] {json.dumps(small['summary'])} launches "
          f"{json.dumps(small['launches'])} in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    gemma = gemma_phase(args.seed, plen)
    print(f"[gemma] {json.dumps(gemma['summary'])} launches {json.dumps(gemma['launches'])} "
          f"in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    ssm = mamba2_phase(wl, oracle, args.seed)
    print(f"[mamba2] {json.dumps(ssm['summary'])} launches {json.dumps(ssm['launches'])} "
          f"in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    zam = zamba2_phase(wl, oracle, args.seed, dev, plen, 10 * args.iters)
    for r in zam["summary"].pop("kernels"):
        errs[r["kernel"]] = max(errs[r["kernel"]], r["max_abs_err"])
        print(f"[zamba2] {r['kernel']} {r['shape']}: device ms per call: kernel {r['ms']:.4f}, "
              f"plain {r['plain_ms']:.4f}, library {r['library_ms']}; bound "
              f"{r['bound_ms']:.5f} ({r['bound_by']}); max abs err {r['max_abs_err']:.3g}; "
              f"card: {card}")
    print(f"[zamba2] {json.dumps(zam['summary'])} launches {json.dumps(zam['launches'])} "
          f"in {time.perf_counter() - t0:.1f} s; card: {card}")
    t0 = time.perf_counter()
    mixture = moe_phase(wl, oracle, args.seed, dev)
    print(f"[moe] {json.dumps(mixture['summary'])} launches "
          f"{json.dumps(mixture['launches'])} in {time.perf_counter() - t0:.1f} s; card: {card}")
    served = serve_phase(wl, oracle)
    print(f"[serve] {json.dumps(served['summary'])} launches {json.dumps(served['launches'])}")
    t0 = time.perf_counter()
    nl = nl_phase(wl, oracle)
    print(f"[nl] {json.dumps(nl['summary'])} launches {json.dumps(nl['launches'])} "
          f"in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    sharded = service_phase(wl, oracle)
    print(f"[service] {json.dumps(sharded['summary'])} launches "
          f"{json.dumps(sharded['launches'])} in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    scanned = scan_phase(wl, oracle)
    print(f"[scan] {json.dumps(scanned['summary'])} launches "
          f"{json.dumps(scanned['launches'])} in {time.perf_counter() - t0:.1f} s; "
          f"card: {card}")
    t0 = time.perf_counter()
    refreshed = refresh_phase(args.n_fact, args.seed)
    print(f"[refresh] {json.dumps(refreshed['summary'])} launches "
          f"{json.dumps(refreshed['launches'])} in {time.perf_counter() - t0:.1f} s; "
          f"card: {card}")
    t0 = time.perf_counter()
    others = workloads_phase(wl, oracle, args.seed)
    print(f"[workloads] {json.dumps(others['summary'])} launches "
          f"{json.dumps(others['launches'])} in {time.perf_counter() - t0:.1f} s; "
          f"card: {card}")
    t0 = time.perf_counter()
    phases = {"serve": served["fused_shapes"], "scan": scanned["fused_shapes"],
              "refresh": refreshed["fused_shapes"], "workloads": others["fused_shapes"]}
    table = fused_shape_table(phases, dev, gen, args.iters, baseline)
    for row in table:
        print(f"[shapes] seg_agg_fused shape {json.dumps(row)}")
    gap = {ph: {k: sum(r["by_phase"].get(ph, 0) * (r[k] - r["bound_ms"]) for r in table)
                for k in ("ms", "baseline_ms") if all(k in r for r in table)}
           for ph in phases}
    print(f"[shapes] seg_agg_fused: {len(table)} shapes, "
          f"{sum(r['launches'] for r in table)} launches "
          f"({json.dumps({ph: sum(c.values()) for ph, c in phases.items()})}), launches x "
          f"(ms - bound) by phase {json.dumps(gap)}, bit-identical repeats at "
          f"{sum(r['bit_identical'] for r in table)} shapes, in "
          f"{time.perf_counter() - t0:.1f} s; card: {card}")
    t0 = time.perf_counter()
    trained = train_phase(wl, oracle, args.seed, dev, gen, 10 * args.iters)
    bwd = trained["bwd"]
    errs["flash_attn_bwd"] = max(*bwd["sweep"].values(), bwd["times"]["max_abs_err"])
    times["flash_attn_bwd"] = bwd["times"]
    t = bwd["times"]
    for r in t["more"]:
        errs["flash_attn_bwd"] = max(errs["flash_attn_bwd"], r["max_abs_err"])
        print(f"[train] flash_attn_bwd {r['shape']}: device ms per call: kernel "
              f"{r['ms']:.4f}, plain {r['plain_ms']:.4f}, library {r['library_ms']:.4f}; "
              f"bound {r['bound_ms']:.5f} ({r['bound_by']}); max abs err "
              f"{r['max_abs_err']:.3g}; card: {card}")
    print(f"[train] flash_attn_bwd {t['shape']}: device ms per call: kernel {t['ms']:.4f}, "
          f"plain {t['plain_ms']:.4f}, library {t['library_ms']:.4f}; bound "
          f"{t['bound_ms']:.5f} ({t['bound_by']}); max abs err by dtype over the sweep "
          f"{json.dumps(bwd['sweep'])}, at the main path's shape {t['max_abs_err']:.3g}; "
          f"card: {card}")
    print(f"[train] {json.dumps(trained['summary'])} launches "
          f"{json.dumps(trained['launches'])} in {time.perf_counter() - t0:.1f} s; "
          f"card: {card}")
    t0 = time.perf_counter()
    shown = examples_phase(args.n_fact, dev, gen, 10 * args.iters)
    r = shown["bwd"]
    errs["flash_attn_bwd"] = max(errs["flash_attn_bwd"], r["max_abs_err"])
    print(f"[examples] flash_attn_bwd {r['shape']}: device ms per call: kernel {r['ms']:.4f}, "
          f"plain {r['plain_ms']:.4f}, library {r['library_ms']:.4f}; bound "
          f"{r['bound_ms']:.5f} ({r['bound_by']}); max abs err {r['max_abs_err']:.3g}; "
          f"card: {card}")
    for name, run in shown["runs"].items():
        cpu = f" (--device cpu {run['cpu_wall_s']:.3f} s)" if "cpu_wall_s" in run else ""
        print(f"[examples] {name}: {json.dumps(run['summary'])} in {run['wall_s']:.3f} s"
              f"{cpu}, launches {json.dumps(shown['launches'][name])}; card: {card}")
    print(f"[examples] in {time.perf_counter() - t0:.1f} s; card: {card}")
    t0 = time.perf_counter()
    distd = dist_phase(args.seed)
    print(f"[dist] {json.dumps(distd['summary'])} launches {json.dumps(distd['launches'])} "
          f"in {time.perf_counter() - t0:.1f} s; card: {card}")
    for what, run in (("", lambda: profile_sample(args.n_fact, args.seed)),
                      ("engine ", lambda: profile_engine(llm["engine"], wl)),
                      ("mamba2 engine ", lambda: profile_engine(ssm["engine"], wl))):
        t0 = time.perf_counter()
        print(f"[profile] {what}{json.dumps(run())} in {time.perf_counter() - t0:.1f} s")
    print(f"[total] {time.perf_counter() - t_all:.1f} s")

    # each path's counts were zeroed just before it and read just after
    for path, counts, names in (("train", trained["launches"], ("flash_attn", "flash_attn_bwd")),
                                *((f"examples {name}", shown["launches"][name],
                                   ("flash_attn", "flash_attn_bwd", "decode_attn"))
                                  for name in ("train_canonicalizer",
                                               "train_canonicalizer restart")),
                                ("dist train", distd["launches"]["train"],
                                 ("flash_attn", "flash_attn_bwd")),
                                ("dist serve", distd["launches"]["serve"],
                                 ("flash_attn", "decode_attn")),
                                ("dist zero3 train", distd["launches"]["train_zero3"],
                                 ("flash_attn", "flash_attn_bwd")),
                                ("dist zero3 serve", distd["launches"]["serve_zero3"],
                                 ("flash_attn", "decode_attn")),
                                ("dist ssd", distd["launches"]["ssd"], ("ssd_scan",)),
                                ("reduced", small["launches"], ("flash_attn", "decode_attn")),
                                ("gemma-2b", gemma["launches"], ("flash_attn", "decode_attn")),
                                ("zamba2-7b", zam["launches"],
                                 ("ssd_scan", "flash_attn", "decode_attn")),
                                ("qwen3-moe", mixture["launches"], ("flash_attn", "decode_attn")),
                                ("scan", scanned["launches"], ("seg_agg", "seg_agg_fused")),
                                ("refresh", refreshed["launches"], ("seg_agg", "seg_agg_fused")),
                                ("workloads", others["launches"], ("seg_agg_fused",))):
        if not all(counts[n] for n in names):
            raise AssertionError(f"{path}: a kernel was never launched: {dict(counts)}")
    path_launches = {"seg_agg": served["launches"]["seg_agg"],
                     "seg_agg_fused": served["launches"]["seg_agg_fused"],
                     "flash_attn": llm["launches"]["flash_attn"],
                     "decode_attn": llm["launches"]["decode_attn"],
                     "ssd_scan": ssm["launches"]["ssd_scan"],
                     "flash_attn_bwd": trained["launches"]["flash_attn_bwd"]}
    if not all(path_launches.values()):
        raise AssertionError(f"a kernel was never launched on its path: {path_launches}")
    kernels = [{
        "name": name, "route": "cuda", "source": SOURCES[name][0],
        "replaces": SOURCES[name][1], "launches": path_launches[name],
        "max_abs_err": errs[name], "ms": times[name]["ms"],
        "plain_ms": times[name]["plain_ms"], "bound_ms": times[name]["bound_ms"],
        "bound_by": times[name]["bound_by"], "library_ms": times[name]["library_ms"],
    } for name in SOURCES]
    print(json.dumps({"kernels": kernels}))
    print(nvidia_smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
