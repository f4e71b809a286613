"""Governed metric layer (§3.3 'Metric identity', §6.1).

In governed deployments (dbt Metrics, Cube) a metric identifier pins the
exact measure expressions and base filters, eliminating NL metric-name
ambiguity at the source: 'revenue' is whatever the governance layer says it
is, and the signature carries the metric_id so governed and ad-hoc requests
occupy disjoint key spaces.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from .signature import Filter, Measure, OrderKey, Signature, TimeWindow


@dataclasses.dataclass(frozen=True)
class GovernedMetric:
    metric_id: str  # e.g. 'finance.net_revenue'
    schema: str
    measures: tuple[Measure, ...]
    base_filters: tuple[Filter, ...] = ()  # governance-mandated slice
    description: str = ""
    # NL aliases that resolve to this metric with certainty
    aliases: tuple[str, ...] = ()


class MetricLayer:
    def __init__(self, metrics: tuple[GovernedMetric, ...] = ()):
        self._by_id: dict[str, GovernedMetric] = {}
        self._by_alias: dict[tuple[str, str], GovernedMetric] = {}
        for m in metrics:
            self.register(m)

    def register(self, m: GovernedMetric) -> None:
        if m.metric_id in self._by_id:
            raise ValueError(f"duplicate metric id {m.metric_id!r}")
        self._by_id[m.metric_id] = m
        for a in m.aliases:
            key = (m.schema, a.lower())
            if key in self._by_alias:
                raise ValueError(f"alias {a!r} already bound in schema {m.schema!r}")
            self._by_alias[key] = m

    def get(self, metric_id: str) -> Optional[GovernedMetric]:
        return self._by_id.get(metric_id)

    def resolve_alias(self, schema: str, text_term: str) -> Optional[GovernedMetric]:
        return self._by_alias.get((schema, text_term.lower()))

    def expand(
        self,
        metric_id: str,
        levels: tuple[str, ...] = (),
        filters: tuple[Filter, ...] = (),
        time_window: Optional[TimeWindow] = None,
        order_by: tuple[OrderKey, ...] = (),
        limit: Optional[int] = None,
        scope: Optional[str] = None,
    ) -> Signature:
        """Build the full intent signature for a governed request.  The
        metric's base filters merge with the request's; the metric_id is
        carried in the signature so governed keys never collide with ad-hoc
        ones even when expressions coincide."""
        m = self._by_id.get(metric_id)
        if m is None:
            raise KeyError(f"unknown governed metric {metric_id!r}")
        merged = tuple(sorted(set(m.base_filters) | set(filters),
                              key=Filter.sort_key))
        return Signature(
            schema=m.schema, measures=m.measures, levels=levels,
            filters=merged, time_window=time_window, order_by=order_by,
            limit=limit, metric_id=metric_id, scope=scope,
        )
