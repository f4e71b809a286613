"""Layered safety policy for NL-driven reuse (§3.7, §6.1).

NL canonicalization can be schema-valid yet semantically incorrect.  Reuse is
controlled by layered policies that prefer misses over false hits:

1. schema validation (always on; see validator.py),
2. confidence-gated reuse,
3. heuristic ambiguity checks (deployment-specific templates):
   unresolved relative time, underspecified spatial terms, and
   aggregation-word mismatches,
4. optional lightweight verification of NL-originated hits (time windows),
5. SQL-seeded-reuse mode: NL gets read-only cache access (no stores).
"""
from __future__ import annotations

import dataclasses
import datetime as _dt
import re
from typing import Optional

from .nl_canon import AGG_WORDS, RELATIVE_TIME_RE, NLResult
from .signature import Signature


@dataclasses.dataclass(frozen=True)
class SafetyPolicy:
    confidence_threshold: Optional[float] = 0.5
    heuristic_time: bool = True
    heuristic_spatial: bool = True
    heuristic_aggword: bool = True
    verify_time_window: bool = False  # optional lightweight hit verification
    sql_seeded_only: bool = False  # NL may read the cache but never populate it
    # deployment-specific: spatial terms that are underspecified for this
    # schema, e.g. {'area': ('zones.zone', 'zones.borough')}
    spatial_ambiguous_terms: tuple[tuple[str, tuple[str, ...]], ...] = ()
    # longer phrases that *specify* an otherwise-ambiguous term ('customer
    # region' specifies 'region'); stripped before the spatial check
    spatial_qualified_phrases: tuple[str, ...] = ()

    @staticmethod
    def conservative(spatial=(), qualified=()) -> "SafetyPolicy":
        return SafetyPolicy(0.7, True, True, True, True, False,
                            tuple(spatial), tuple(qualified))

    @staticmethod
    def balanced(spatial=(), qualified=()) -> "SafetyPolicy":
        return SafetyPolicy(0.5, True, True, False, False, False,
                            tuple(spatial), tuple(qualified))

    @staticmethod
    def aggressive() -> "SafetyPolicy":
        return SafetyPolicy(None, False, False, False, False, False, (), ())


@dataclasses.dataclass
class SafetyDecision:
    allow: bool
    reasons: tuple[str, ...] = ()

    def __bool__(self) -> bool:
        return self.allow


def gate_nl(
    policy: SafetyPolicy,
    text: str,
    result: NLResult,
    now: Optional[_dt.date] = None,
) -> SafetyDecision:
    """Decide whether an NL-derived signature may interact with the cache."""
    reasons: list[str] = []
    if result.signature is None:
        return SafetyDecision(False, (result.error or "no signature",))
    if policy.confidence_threshold is not None and result.confidence < policy.confidence_threshold:
        reasons.append(
            f"confidence {result.confidence:.2f} below threshold {policy.confidence_threshold}"
        )
    t = " " + re.sub(r"\s+", " ", text.lower()) + " "
    if policy.heuristic_time:
        reasons.extend(_check_time(t, result.signature, now))
    if policy.heuristic_spatial:
        reasons.extend(_check_spatial(t, result.signature, policy))
    if policy.heuristic_aggword:
        reasons.extend(_check_aggword(t, result.signature))
    return SafetyDecision(not reasons, tuple(reasons))


def _check_time(t: str, sig: Signature, now: Optional[_dt.date]) -> list[str]:
    """Reject unresolved relative time: a relative phrase with no date context
    cannot be anchored, and an open-ended window without context is a guess."""
    if RELATIVE_TIME_RE.search(t) and now is None:
        return ["unresolved relative time reference without current-date context"]
    if sig.time_window is not None and sig.time_window.open_ended and now is None:
        return ["open-ended time window without current-date context"]
    return []


def _check_spatial(t: str, sig: Signature, policy: SafetyPolicy) -> list[str]:
    """Reject underspecified spatial terms ('area' -> zone vs borough) when
    the signature actually uses one of the candidate columns.  Occurrences
    inside a qualifying phrase ('customer region') are specified, not
    ambiguous, and are stripped first."""
    out = []
    for phrase in sorted(policy.spatial_qualified_phrases, key=len, reverse=True):
        t = t.replace(" " + phrase + " ", " ").replace(" " + phrase + "s ", " ")
    used = set(sig.levels) | {f.col for f in sig.filters}
    for term, candidates in policy.spatial_ambiguous_terms:
        if (" " + term + " ") in t or (" " + term + "s ") in t:
            if used & set(candidates):
                out.append(f"underspecified spatial term {term!r}")
    return out


def _check_aggword(t: str, sig: Signature) -> list[str]:
    """Reject aggregation-word mismatches: the NL names an aggregation that
    the signature does not contain at all."""
    sig_aggs = {m.agg for m in sig.measures}
    matched: list[str] = []
    consumed = t
    for phrase, agg in AGG_WORDS:  # longest-phrase-first order in AGG_WORDS
        if phrase in consumed:
            matched.append(agg)
            consumed = consumed.replace(phrase, " ")
    for agg in matched:
        if agg not in sig_aggs:
            return [f"aggregation word implies {agg} but signature has {sorted(sig_aggs)}"]
    return []


def verify_hit_time_window(sig: Signature, cached_sig: Signature) -> bool:
    """Optional lightweight verification on NL-originated hits (§3.7): the
    served entry's window must equal the request's window.  Exact-intent
    matching already guarantees this; the check catches derivation bugs and
    future fuzzy-matching modes.  Returns True when safe."""
    return sig.time_window == cached_sig.time_window
