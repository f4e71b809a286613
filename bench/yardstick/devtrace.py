"""The traced run's readings: ``torch.profiler`` (CPU and CUDA activity,
every thread) over the measured window, reduced to what the per-layer
readers and the result line's ``breakdown`` need; and the shapes of the
``seg_agg`` kernels' launches, recorded by wrapping the port's launchers
for the window (as the port's ``chip_smoke.py`` does with
``FusedShapes``).

Device activity is every event the profiler puts on the card: kernels,
copies and memsets.  ``busy_s`` is the length of their union inside the
window; an idle gap is a stretch of the window with none of them, named
by the harness's host range that covered its middle (``bench.submit_batch``
before ``bench.generate`` before ``bench.wait``; ``none`` where no caller
was in one).
"""
from __future__ import annotations

import bisect
import collections
import dataclasses
import threading
import time

HOST_RANGES = ("bench.submit_batch", "bench.generate", "bench.wait")


class LaunchShapes:
    """Within its ``with``, the shape of every launch of kernel B
    (``seg_agg_fused_cuda``: N, M, P, K, S, G) and of kernel A
    (``seg_agg_cuda``: N, M, G), counted."""

    def __enter__(self):
        from repro_torch.kernels.seg_agg import kernel

        self.kernel = kernel
        self.real_b, self.real_a = kernel.seg_agg_fused_cuda, kernel.seg_agg_cuda
        self.counts: collections.Counter = collections.Counter()
        lock = threading.Lock()

        def fused(values, ids, pred_cols, bounds, num_groups, op="sum"):
            s, p, k, _ = bounds.shape
            with lock:
                for s0 in range(0, s, kernel.MAX_SIGNATURES):
                    self.counts[("B", values.shape[0], values.shape[1], p, k,
                                 min(kernel.MAX_SIGNATURES, s - s0), num_groups)] += 1
            return self.real_b(values, ids, pred_cols, bounds, num_groups, op)

        def masked(values, ids, mask, num_groups, op="sum", select=True):
            with lock:
                self.counts[("A", values.shape[0], values.shape[1], num_groups)] += 1
            return self.real_a(values, ids, mask, num_groups, op, select=select)

        kernel.seg_agg_fused_cuda, kernel.seg_agg_cuda = fused, masked
        return self

    def __exit__(self, *exc):
        self.kernel.seg_agg_fused_cuda, self.kernel.seg_agg_cuda = self.real_b, self.real_a


@dataclasses.dataclass
class Reduction:
    window_s: float
    busy_s: float
    op_seconds: dict  # device op name -> seconds
    gaps: list  # (label, seconds), longest first

    def seconds_of(self, needle: str) -> float:
        return sum(s for name, s in self.op_seconds.items() if needle in name)

    def breakdown(self) -> dict:
        ops = sorted(self.op_seconds.items(), key=lambda kv: -kv[1])[:10]
        return {"device_ops": [[n, s] for n, s in ops],
                "idle_gaps": [[n, s] for n, s in self.gaps[:10]]}


def start(cuda: bool):
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    try:
        cfg = torch._C._profiler._ExperimentalConfig(profile_all_threads=True)
    except TypeError:  # a torch without the option traces the main thread's ranges only
        cfg = None
    prof = profile(activities=acts, experimental_config=cfg)
    prof.start()
    prof.bench_t0 = time.perf_counter()
    return prof


def _union(iv: list[tuple[int, int]]) -> list[tuple[int, int]]:
    out: list[list[int]] = []
    for a, b in sorted(iv):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def stop(prof, cuda: bool) -> Reduction:
    from torch.autograd import DeviceType

    prof.stop()
    window_s = time.perf_counter() - prof.bench_t0
    events = prof.profiler.kineto_results.events()
    dev, host = [], collections.defaultdict(list)
    ops: collections.Counter = collections.Counter()
    for e in events:
        if e.name() in HOST_RANGES and e.device_type() == DeviceType.CUDA:
            continue  # the profiler mirrors a host range onto the card's timeline
        if e.device_type() == DeviceType.CUDA:
            a, b = e.start_ns(), e.end_ns()
            dev.append((a, b))
            ops[e.name()] += (b - a) / 1e9
        elif e.name() in HOST_RANGES:
            host[e.name()].append((e.start_ns(), e.end_ns()))
    try:
        t0 = prof.profiler.kineto_results.trace_start_ns()
    except AttributeError:  # older torch: the first event's start
        t0 = min([a for iv in host.values() for a, _ in iv] + [a for a, _ in dev], default=0)
    t1 = t0 + int(window_s * 1e9)
    busy = _union([(max(a, t0), min(b, t1)) for a, b in dev if b > t0 and a < t1])
    busy_s = sum(b - a for a, b in busy) / 1e9
    merged = {name: _union(iv) for name, iv in host.items()}
    firsts = {name: [a for a, _ in iv] for name, iv in merged.items()}

    def label(mid: int) -> str:
        for name in HOST_RANGES:
            i = bisect.bisect_right(firsts.get(name, []), mid) - 1
            if i >= 0 and merged[name][i][1] >= mid:
                return name
        return "none"

    gaps, cur = [], t0
    for a, b in busy + [(t1, t1)]:
        if a > cur:
            gaps.append((label((a + cur) // 2), (a - cur) / 1e9))
        cur = max(cur, b)
    gaps.sort(key=lambda g: -g[1])
    return Reduction(window_s, busy_s, dict(ops), gaps)


def seg_agg_bytes(shape: tuple) -> int:
    """Bytes one launch must move: each input read once, the output written
    once.  A frozen copy of the count in the port's ``chip_smoke.py``
    (kernel B: ``(n * (m + 1 + p) + s * g * m + bounds) * 4``; kernel A
    likewise with the mask as its one predicate column and no bounds)."""
    if shape[0] == "B":
        _, n, m, p, k, s, g = shape
        return (n * (m + 1 + p) + s * g * m + s * p * k * 2) * 4
    _, n, m, g = shape
    return (n * (m + 2) + g * m) * 4

