"""Workload infrastructure: intents, datasets, and query streams.

A workload = a star schema + synthetic columnar data + a set of canonical
intents.  Each intent expands into 21 SQL variants (variants.py) and 10 NL
paraphrases (paraphrase.py), reproducing the paper's 1,395-query evaluation
corpus (945 SQL + 450 NL over 45 intents: TPC-DS 14, SSB 13, NYC TLC 18).
"""
from __future__ import annotations

import dataclasses
import random
from typing import Optional

import numpy as np

from ..core.nl_canon import NLVocab
from ..core.schema import StarSchema
from ..olap.columnar import Dataset
from .variants import make_variants


@dataclasses.dataclass
class Intent:
    id: str
    sql: str  # canonical SQL text
    # NL building blocks (consumed by paraphrase.py): measure phrases like
    # 'total revenue', grouping nouns, filter phrases, time phrase, extras.
    nl_measures: tuple[str, ...] = ()
    nl_levels: tuple[str, ...] = ()
    nl_filters: tuple[str, ...] = ()
    nl_time: Optional[str] = None
    nl_extra: Optional[str] = None  # e.g. 'top 10'
    tags: frozenset = frozenset()


@dataclasses.dataclass
class Query:
    """One element of the evaluation stream."""

    workload: str
    intent_id: str
    kind: str  # 'sql' | 'nl'
    text: str
    variant_idx: int


@dataclasses.dataclass
class Workload:
    name: str
    schema: StarSchema
    dataset: Dataset
    intents: list[Intent]
    vocab: NLVocab
    spatial_ambiguous: tuple = ()

    def queries(
        self,
        sql_variants: int = 21,
        nl_paraphrases: int = 10,
        order: str = "sequential",
        seed: int = 0,
        zipf_a: float = 1.4,
        repeat_factor: int = 1,
    ) -> list[Query]:
        """Expand intents into the evaluation stream.

        order: 'sequential' (all forms of an intent consecutively — dashboard
        refresh pattern), 'interleaved' (round-robin across intents), 'random',
        or 'zipf' (popularity-skewed sampling with replacement).
        """
        from .paraphrase import gen_paraphrases

        per_intent: list[list[Query]] = []
        for i, intent in enumerate(self.intents):
            qs: list[Query] = []
            for vi, sql in enumerate(
                make_variants(intent.sql, self.schema, n=sql_variants, seed=seed + i)
            ):
                qs.append(Query(self.name, intent.id, "sql", sql, vi))
            for pi, text in enumerate(
                gen_paraphrases(intent, n=nl_paraphrases, seed=seed + 1000 + i)
            ):
                qs.append(Query(self.name, intent.id, "nl", text, pi))
            per_intent.append(qs)

        rnd = random.Random(seed + 7)
        if order == "sequential":
            return [q for qs in per_intent for q in qs]
        if order == "interleaved":
            out: list[Query] = []
            for round_idx in range(max(len(qs) for qs in per_intent)):
                for qs in per_intent:
                    if round_idx < len(qs):
                        out.append(qs[round_idx])
            return out
        if order == "random":
            flat = [q for qs in per_intent for q in qs]
            rnd.shuffle(flat)
            return flat
        if order == "zipf":
            flat_by_intent = per_intent
            total = sum(len(qs) for qs in per_intent) * repeat_factor
            ranks = np.arange(1, len(per_intent) + 1, dtype=np.float64)
            probs = ranks ** (-zipf_a)
            probs /= probs.sum()
            rs = np.random.default_rng(seed + 11)
            out = []
            for intent_idx in rs.choice(len(per_intent), size=total, p=probs):
                qs = flat_by_intent[intent_idx]
                out.append(qs[rs.integers(0, len(qs))])
            return out
        raise ValueError(f"unknown order {order!r}")


def dict_columns(n: int, rng: np.random.Generator, values: list[str]) -> np.ndarray:
    return np.asarray(values)[rng.integers(0, len(values), size=n)]
