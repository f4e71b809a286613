"""Training data for the canonicalizer model: the JAX package's
``repro/training/data.py``.

Supervised pairs (NL question -> intent-signature JSON) generated from the
workload paraphrase machinery.  The pipeline is deterministic, shardable
by host, and step-addressable (``batch_at(step)`` is a pure function of
the step and the seed), which is what checkpoint restart needs.  Batches
are numpy arrays, so the same batch feeds the port and the JAX package.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np

from ..core.sql_canon import SQLCanonicalizer
from ..workloads.paraphrase import gen_paraphrases


@dataclasses.dataclass
class NLPair:
    text: str
    target_json: str


def build_pairs(workloads, paraphrases_per_intent: int = 30, seed: int = 0) -> list[NLPair]:
    pairs: list[NLPair] = []
    for wl in workloads:
        canon = SQLCanonicalizer(wl.schema)
        for i, intent in enumerate(wl.intents):
            tgt = canon.canonicalize(intent.sql).canonical_json()
            for text in gen_paraphrases(intent, n=paraphrases_per_intent,
                                        seed=seed + 31 * i):
                pairs.append(NLPair(text, tgt))
    return pairs


class BatchIterator:
    """Deterministic, host-sharded, step-addressable batch stream."""

    def __init__(self, pairs: list[NLPair], tokenizer, batch: int, seq_len: int,
                 seed: int = 0, host_id: int = 0, num_hosts: int = 1):
        self.pairs = pairs
        self.tok = tokenizer
        self.batch = batch
        self.seq_len = seq_len
        self.seed = seed
        self.host_id = host_id
        self.num_hosts = num_hosts

    def batch_at(self, step: int) -> dict:
        """{"tokens", "labels"}: (batch, seq_len) int32 arrays, a pure
        function of (step, seed); labels are the next token over the
        target span and -1 elsewhere."""
        rng = np.random.default_rng(self.seed * 1_000_003 + step)
        idx = rng.integers(0, len(self.pairs), size=self.batch * self.num_hosts)
        idx = idx[self.host_id * self.batch:(self.host_id + 1) * self.batch]
        tokens = np.full((self.batch, self.seq_len), self.tok.pad, np.int32)
        labels = np.full((self.batch, self.seq_len), -1, np.int32)
        for r, j in enumerate(idx):
            p = self.pairs[int(j)]
            prompt = self.tok.encode(f"question: {p.text}\nsignature: ", add_bos=True)
            target = self.tok.encode(p.target_json) + [self.tok.eos]
            seq = (prompt + target)[: self.seq_len]
            tokens[r, :len(seq)] = seq
            start = min(len(prompt), self.seq_len) - 1
            for t in range(start, min(len(seq) - 1, self.seq_len - 1)):
                labels[r, t] = seq[t + 1]
        return {"tokens": tokens, "labels": labels}

    def __iter__(self) -> Iterator[dict]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1
