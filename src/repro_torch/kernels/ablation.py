"""What the kernels' ablations share: rebuild one kernel library with parts
of its source taken out, and time calls on the card with the L2 cache
flushed before each (``device_ms``, which ``chip_smoke.py`` times with
too).

A part is a list of (text in the source, its replacement); a part whose
text is no longer in the source fails loudly, so the parts are kept with
the kernel.  The sources include the shared headers of ``kernels/csrc/``
by a relative path, which the variant copies name by their absolute path.
The ablated builds compute wrong outputs by design: only their device
times are read.  A diagnostic for work on the kernels; nothing on the
serving path imports it.
"""
from __future__ import annotations

import ctypes
import statistics
import subprocess
import warnings
from pathlib import Path

import torch

from . import build

HEADERS = Path(__file__).resolve().parent / "csrc"


def variant_source(src: Path, edits: list[tuple[str, str]]) -> str:
    """``src``'s text with every edit applied and the shared headers
    included by their absolute path."""
    text = src.read_text().replace('#include "../../csrc/', f'#include "{HEADERS}/')
    for old, new in edits:
        if old not in text:
            raise RuntimeError(f"ablation of {src.name}: the source no longer has {old!r}")
        text = text.replace(old, new)
    return text


def build_variants(src: Path, parts: dict[str, list[tuple[str, str]]], names,
                   units=((),), common: list[tuple[str, str]] = ()) -> dict[str, ctypes.CDLL]:
    """One library per name (None: the full kernel), built in parallel into
    ``build/kernels/ablation/<source>/<name>/``: the source with ``common``'s
    edits and the part's, compiled once per tuple of -D flags in ``units``
    and linked."""
    jobs = {}
    for part in names:
        name = part or "full"
        out = build.BUILD_DIR / "ablation" / src.stem / name
        out.mkdir(parents=True, exist_ok=True)
        (out / src.name).write_text(variant_source(src, [*common, *parts.get(part, [])]))
        so = out / f"lib{src.stem}.so"
        jobs[name] = (build.Job([(out / src.name, flags) for flags in units], so,
                                f"ablation {name}"), so)
    libs = {}
    for name, (job, so) in jobs.items():
        job.finish()
        libs[name] = ctypes.CDLL(str(so))
    return libs


L2_BYTES = 50 * 2 ** 20  # the H100's L2 cache
FLUSH_BYTES = 8 * L2_BYTES  # read before each timed call: what was in L2 is evicted
EDGE_CYCLES = 50_000_000  # ~25 ms of spinning at the H100's ~2 GHz
EDGE_FLUSHES = 200  # ~25 ms of flushes at ~0.13 ms each


def _is_flush(name: str) -> bool:
    """Whether a traced kernel is ``device_ms``'s L2 flush: the only
    reduction over int8 that the timed calls come near."""
    return "reduce" in name and "signed char" in name


def device_ms(fn, iters: int, args=(), warmup: int = 2) -> float:
    """Device milliseconds per call of ``fn(*args)`` under
    ``torch.profiler``: the median over ``iters`` calls of the summed
    duration of the kernels and copies each call ran, so neither the
    host's gaps between launches nor a stray slow call is counted.  Before
    each call a row-wise max reads an int8 buffer of 8x the L2 cache, so no
    call finds its inputs in L2, as a caller that reads them once does not;
    in the trace, ordered by start, that flush's kernel opens each call's
    kernels and is left out of its sum.  The profiler can lose the records
    at a session's edges (more of them the longer the process has run), so
    ~25 ms of device work before the first call and after the last take
    their place; a call with no traced time is dropped.  A session that
    traced fewer than half the calls is run again, up to ``SESSIONS`` in
    all; after that the calls are timed by CUDA events (``_event_calls``),
    with a warning."""
    buf = torch.ones((FLUSH_BYTES // 4096, 4096), dtype=torch.int8,
                     device=torch.cuda.current_device())
    for _ in range(warmup):
        buf.amax(dim=1)
        fn(*args)
    torch.cuda.synchronize()
    for _ in range(SESSIONS):
        traced = _traced_calls(fn, iters, args, buf)
        if len(traced) >= iters / 2:
            return statistics.median(traced)
    warnings.warn(f"device_ms: the profiler traced device time for {len(traced)} of {iters} "
                  f"calls in each of {SESSIONS} sessions; timed by CUDA events instead")
    return statistics.median(_event_calls(fn, iters, args, buf))


SESSIONS = 3  # profiler sessions device_ms runs before it gives up


def _traced_calls(fn, iters: int, args, buf) -> list[float]:
    """One profiler session of ``iters`` flushed calls: the device ms of
    each call the trace holds."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(EDGE_CYCLES)  # before the first flush: in no call's sum
        for _ in range(iters):
            buf.amax(dim=1)
            fn(*args)
        for _ in range(EDGE_FLUSHES):  # calls with nothing to time: dropped
            buf.amax(dim=1)
        torch.cuda.synchronize()
    events = sorted((e for e in prof.events()
                     if e.device_type == torch.autograd.DeviceType.CUDA),
                    key=lambda e: e.time_range.start)
    calls: list[float] = []
    for e in events:
        if _is_flush(e.name):
            calls.append(0.0)
        elif calls:
            calls[-1] += e.time_range.elapsed_us() / 1e3
    return [ms for ms in calls if ms > 0.0]


def _event_calls(fn, iters: int, args, buf) -> list[float]:
    """The device ms of each of ``iters`` flushed calls, between two CUDA
    events recorded around the call after its flush: the flush (~0.13 ms)
    keeps the card busy while the host enqueues the call, so the span holds
    the call's kernels and not the host's launch gaps, as long as the call
    enqueues faster than the flush runs."""
    spans = []
    for _ in range(iters):
        buf.amax(dim=1)
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        fn(*args)
        end.record()
        spans.append((start, end))
    torch.cuda.synchronize()
    return [start.elapsed_time(end) for start, end in spans]


def card() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
