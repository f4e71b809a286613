"""Typed metric instruments and the exposition registry.

Three instrument kinds — :class:`Counter` (monotone), :class:`Gauge`
(set-to-value), :class:`Histogram` (log2-bucketed distribution) — each with
a declared label set (``tenant``, ``stage``, ...), registered by name in a
:class:`MetricsRegistry` that renders the whole collection as
Prometheus-text or JSON (``CacheService.metrics()``).

The histogram is the piece the hot path touches: :class:`LogHistogram`
replaces the old ``STAGE_SAMPLE_WINDOW`` deques behind
``TenantStats.stage_percentiles`` — an ``observe`` is one ``frexp`` plus a
list-slot increment (cheaper than a bounded-deque append, and it never
forgets old samples), and quantiles come from bucket interpolation with a
*proper rank* (``q * (n - 1)``), which also fixes the old ``int(len*0.95)``
index bias on small windows.  Buckets are powers of two from 1µs to ~5min
(in ms), so p50/p95 are exact to within one octave across the whole range
the pipeline produces.

Locking: instruments share their registry's single leaf lock (one lock
acquisition per update, none held while rendering a sample's text).
``LogHistogram`` itself is lock-free and caller-locked — ``TenantStats``
updates it under its own ``_lock``, exactly as it did the deques.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

from ..analysis.sanitizer import make_lock

__all__ = ["LogHistogram", "Counter", "Gauge", "Histogram",
           "MetricsRegistry"]

# log2 bucket edges in milliseconds: 2^-10 (~1us) .. 2^18 (~4.4min); values
# above the last edge land in the +Inf overflow bucket
_MIN_EXP, _MAX_EXP = -10, 18
BUCKET_BOUNDS: tuple[float, ...] = tuple(
    2.0 ** e for e in range(_MIN_EXP, _MAX_EXP + 1))
_N_BUCKETS = len(BUCKET_BOUNDS) + 1  # + overflow


def _bucket_index(v: float) -> int:
    """Index of the first bucket whose upper edge is >= v (frexp, not a
    bisect: constant time, no per-observe allocation)."""
    if v <= BUCKET_BOUNDS[0]:
        return 0
    # frexp(v) = (m, e) with v = m * 2**e, 0.5 <= m < 1  =>  2**(e-1) < v <= 2**e
    # (for m == 0.5 exactly, v == 2**(e-1): one octave lower)
    m, e = math.frexp(v)
    if m == 0.5:
        e -= 1
    i = e - _MIN_EXP
    return i if i < _N_BUCKETS else _N_BUCKETS - 1


class LogHistogram:
    """Fixed log2-bucketed histogram: O(1) observe, rank-based quantiles.

    Not self-locking — the owner serializes access (``TenantStats._lock``,
    ``MetricsRegistry._lock``)."""

    __slots__ = ("counts", "count", "total")

    def __init__(self):
        self.counts = [0] * _N_BUCKETS
        self.count = 0
        self.total = 0.0

    def observe(self, v: float) -> None:
        self.counts[_bucket_index(v)] += 1
        self.count += 1
        self.total += v

    def quantile(self, q: float) -> float:
        """Value at quantile ``q`` via the proper rank ``q * (n - 1)``
        (zero-indexed), linearly interpolated inside the owning bucket.
        Unlike the old ``int(len * 0.95)`` index this can never overshoot
        past the maximum rank on small sample counts."""
        n = self.count
        if n == 0:
            return 0.0
        rank = q * (n - 1)  # zero-indexed fractional rank
        cum = 0
        for i, c in enumerate(self.counts):
            if c == 0:
                continue
            # bucket i covers zero-indexed ranks [cum, cum + c)
            if rank < cum + c:
                lo = 0.0 if i == 0 else BUCKET_BOUNDS[i - 1]
                hi = (BUCKET_BOUNDS[i] if i < len(BUCKET_BOUNDS)
                      else BUCKET_BOUNDS[-1] * 2.0)
                frac = (rank - cum + 1.0) / c  # position within the bucket
                return lo + (hi - lo) * min(frac, 1.0)
            cum += c
        lo = BUCKET_BOUNDS[-1]
        return lo * 2.0

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0

    def snapshot(self) -> "LogHistogram":
        h = LogHistogram()
        h.counts = list(self.counts)
        h.count = self.count
        h.total = self.total
        return h

    def to_dict(self) -> dict:
        return {
            "count": self.count,
            "sum": self.total,
            "p50": self.quantile(0.5),
            "p95": self.quantile(0.95),
            "p99": self.quantile(0.99),
        }


# ------------------------------------------------------------- instruments


def _check_labels(labelnames: tuple, labels: dict) -> tuple:
    if tuple(sorted(labels)) != tuple(sorted(labelnames)):
        raise ValueError(
            f"expected labels {labelnames}, got {tuple(sorted(labels))}")
    return tuple(labels[n] for n in labelnames)


class _Instrument:
    """Shared shape: name/help/labelnames + a per-labelset value table
    guarded by the owning registry's lock."""

    kind = "untyped"

    def __init__(self, name: str, help: str, labelnames: Sequence[str],
                 lock):
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        self._lock = lock  # the owning registry's lock, shared
        self._values: dict = {}  # labelvalues tuple -> value  # guarded-by: self._lock

    def samples(self) -> list[tuple[dict, object]]:
        with self._lock:
            items = list(self._values.items())
        return [(dict(zip(self.labelnames, lv)), v) for lv, v in items]


class Counter(_Instrument):
    kind = "counter"

    def set_total(self, value: float, **labels) -> None:
        """Overwrite the running total — the mirroring path, where the
        source of truth (``TenantStats`` and friends) already accumulated."""
        lv = _check_labels(self.labelnames, labels)
        with self._lock:
            self._values[lv] = float(value)


class Gauge(_Instrument):
    kind = "gauge"

    def set(self, value: float, **labels) -> None:
        lv = _check_labels(self.labelnames, labels)
        with self._lock:
            self._values[lv] = float(value)


class Histogram(_Instrument):
    kind = "histogram"

    def merge_snapshot(self, hist: LogHistogram, **labels) -> None:
        """Adopt an externally-maintained histogram wholesale (mirroring
        ``TenantStats``' per-stage histograms at exposition time)."""
        lv = _check_labels(self.labelnames, labels)
        with self._lock:
            self._values[lv] = hist.snapshot()


# ---------------------------------------------------------------- registry


def _fmt_labels(labels: dict, extra: Optional[dict] = None) -> str:
    merged = dict(labels)
    if extra:
        merged.update(extra)
    if not merged:
        return ""
    inner = ",".join(f'{k}="{_escape(str(v))}"'
                     for k, v in sorted(merged.items()))
    return "{" + inner + "}"


def _escape(v: str) -> str:
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


class MetricsRegistry:
    """Name-keyed instrument collection with Prometheus-text and JSON
    exposition.  ``counter``/``gauge``/``histogram`` are get-or-create
    (re-registration with a different type or label set is an error)."""

    def __init__(self, namespace: str = "repro"):
        self.namespace = namespace
        self._lock = make_lock("MetricsRegistry._lock")
        self._metrics: dict = {}  # name -> _Instrument  # guarded-by: self._lock

    def _get_or_create(self, cls, name: str, help: str,
                       labelnames: Sequence[str]):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = cls(name, help, labelnames,
                                              self._lock)
                return m
        if not isinstance(m, cls) or m.labelnames != tuple(labelnames):
            raise ValueError(
                f"metric {name!r} already registered as {m.kind} "
                f"with labels {m.labelnames}")
        return m

    def counter(self, name: str, help: str = "",
                labelnames: Sequence[str] = ()) -> Counter:
        return self._get_or_create(Counter, name, help, labelnames)

    def gauge(self, name: str, help: str = "",
              labelnames: Sequence[str] = ()) -> Gauge:
        return self._get_or_create(Gauge, name, help, labelnames)

    def histogram(self, name: str, help: str = "",
                  labelnames: Sequence[str] = ()) -> Histogram:
        return self._get_or_create(Histogram, name, help, labelnames)

    def instruments(self) -> list:
        with self._lock:
            return [self._metrics[k] for k in sorted(self._metrics)]

    # ------------------------------------------------------- exposition
    def render_prometheus(self) -> str:
        """Prometheus text exposition format (v0.0.4)."""
        lines: list[str] = []
        for m in self.instruments():
            full = f"{self.namespace}_{m.name}"
            if m.help:
                lines.append(f"# HELP {full} {m.help}")
            lines.append(f"# TYPE {full} {m.kind}")
            for labels, v in m.samples():
                if m.kind == "histogram":
                    cum = 0
                    for i, c in enumerate(v.counts):
                        cum += c
                        if c == 0 and i < len(BUCKET_BOUNDS):
                            continue  # sparse: skip empty interior buckets
                        le = (f"{BUCKET_BOUNDS[i]:g}"
                              if i < len(BUCKET_BOUNDS) else "+Inf")
                        lines.append(
                            f"{full}_bucket"
                            f"{_fmt_labels(labels, {'le': le})} {cum}")
                    lines.append(
                        f"{full}_sum{_fmt_labels(labels)} {v.total:g}")
                    lines.append(
                        f"{full}_count{_fmt_labels(labels)} {v.count}")
                else:
                    lines.append(f"{full}{_fmt_labels(labels)} {v:g}")
        return "\n".join(lines) + ("\n" if lines else "")

    def render_json(self) -> dict:
        out = []
        for m in self.instruments():
            samples = []
            for labels, v in m.samples():
                if m.kind == "histogram":
                    samples.append({"labels": labels, **v.to_dict()})
                else:
                    samples.append({"labels": labels, "value": v})
            out.append({"name": f"{self.namespace}_{m.name}",
                        "type": m.kind, "help": m.help, "samples": samples})
        return {"metrics": out}
