"""NL paraphrase generation (§5.1: 10 manually-authored paraphrases per intent).

Paraphrases are controlled rewrites of known-correct intents with unambiguous
references (the paper's wording) — they rotate synonym templates over the
intent's NL building blocks.  Ambiguity is introduced *only* by the
adversarial / BIRD-like sets, matching the paper's evaluation split.
"""
from __future__ import annotations

import random

from .base import Intent

_TEMPLATES = [
    "Show {measures} {by} {filters} {time} {extra}",
    "What is {measures} {by} {filters} {time}? {extra}",
    "{measures} {by} {time} {filters} {extra}",
    "Give me {measures} {filters} {by} {time} {extra}",
    "I need {measures} {by} {filters} {time} {extra}",
    "Report {measures} {time} {by} {filters} {extra}",
    "Can you display {measures} {by} {filters} {time}? {extra}",
    "Compute {measures} {filters} {time} {by} {extra}",
    "{measures} please, {by} {filters} {time} {extra}",
    "Looking for {measures} {by} {time} {filters} {extra}",
    "Break out {measures} {by} {filters} {time} {extra}",
    "Dashboard needs {measures} {by} {filters} {time} {extra}",
]

_BY_WORDS = ["by", "per", "broken down by", "grouped by", "for each"]
_JOINERS = [" and ", " and ", ", "]


def gen_paraphrases(intent: Intent, n: int = 10, seed: int = 0) -> list[str]:
    rnd = random.Random(seed)
    out: list[str] = []
    for i in range(n):
        tpl = _TEMPLATES[(i + seed) % len(_TEMPLATES)]
        joiner = _JOINERS[i % len(_JOINERS)]
        measures = joiner.join(intent.nl_measures)
        by = ""
        if intent.nl_levels:
            by = _BY_WORDS[(i + seed) % len(_BY_WORDS)] + " " + " and ".join(intent.nl_levels)
        filters = " ".join(intent.nl_filters)
        time = intent.nl_time or ""
        extra = intent.nl_extra or ""
        s = tpl.format(measures=measures, by=by, filters=filters, time=time, extra=extra)
        s = " ".join(s.split())  # collapse whitespace
        s = s.replace(" ?", "?").replace(" ,", ",").rstrip()
        if s.endswith(","):
            s = s[:-1]
        out.append(s)
    return out
