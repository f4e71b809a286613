"""NL -> OLAP Intent Signature canonicalization (§3.4, NL path).

The paper maps NL to signatures with an LLM constrained to schema-valid JSON
plus an uncalibrated confidence score.  GPT-4o-mini is unavailable offline, so
this module provides:

* :class:`SimulatedLLM` — a vocabulary-grounded semantic parser that consumes
  the *text* (never the gold intent).  Genuine ambiguity in the text (a noun
  matching several columns, relative time without a date context, a missing
  aggregation word) surfaces as an explicit ambiguity event; resolution is a
  seeded stochastic choice whose per-ambiguity-type error rates are calibrated
  to the paper's Table 2 measurements (profiles for GPT-4o-mini and
  Claude-3.5-haiku).  Errors are therefore *schema-valid but semantically
  wrong* signatures — exactly the paper's failure mode.
* :class:`MemoizedNL` — the paper's NL-string -> signature memo (repeat NL
  requests skip the LLM; Table 4a "Repeat (memo) < 0.01 ms").

A real-model path exists too: ``repro_torch.serving.engine.CanonicalizerService``
drives the dense transformer with grammar-constrained JSON decoding and
plugs in behind the same :class:`NLCanonicalizer` protocol.
"""
from __future__ import annotations

import dataclasses
import datetime as _dt
import hashlib
import json
import re
from typing import Optional, Protocol

from ..analysis.sanitizer import make_lock

from .signature import Filter, Measure, Signature, TimeWindow

# ---------------------------------------------------------------- vocabulary


@dataclasses.dataclass(frozen=True)
class MeasureSense:
    """One meaning of a measure noun: e.g. 'revenue' -> SUM(sales.net_amount)."""

    expr: str
    default_agg: str = "SUM"


@dataclasses.dataclass
class NLVocab:
    """Schema-specific controlled vocabulary (the paper ships it in the LLM
    prompt; we ship it to the parser).  Ambiguity is explicit: a noun mapping
    to multiple senses / a term mapping to multiple levels."""

    schema: str
    # measure noun -> candidate senses (len>1 == metric-name ambiguity)
    measures: dict[str, tuple[MeasureSense, ...]]
    # grouping noun -> candidate levels 'dim.col' (len>1 == dimension ambiguity)
    levels: dict[str, tuple[str, ...]]
    # literal value -> candidate (column, value) pairs
    values: dict[str, tuple[tuple[str, str], ...]]
    # numeric filter phrases: noun -> fact column
    numeric_cols: dict[str, str] = dataclasses.field(default_factory=dict)
    # nouns whose *absence of an aggregation word* is ambiguous
    # (e.g. 'trips' could be COUNT or AVG per group)
    agg_ambiguous_nouns: tuple[str, ...] = ()


AGG_WORDS = [
    ("count of distinct", "COUNT_DISTINCT"),
    ("distinct count", "COUNT_DISTINCT"),
    ("number of distinct", "COUNT_DISTINCT"),
    ("average", "AVG"),
    ("mean", "AVG"),
    ("total", "SUM"),
    ("sum of", "SUM"),
    ("overall", "SUM"),
    ("count", "COUNT"),
    ("number of", "COUNT"),
    ("how many", "COUNT"),
    ("minimum", "MIN"),
    ("lowest", "MIN"),
    ("smallest", "MIN"),
    ("maximum", "MAX"),
    ("highest", "MAX"),
    ("largest", "MAX"),
]

RELATIVE_TIME_RE = re.compile(
    r"\b(last|past|previous|this|recent)\s+(month|quarter|year|week|\d+\s+days?)\b|\byesterday\b|\brecently\b"
)

_MONTHS = {
    m: i + 1
    for i, m in enumerate(
        ["january", "february", "march", "april", "may", "june", "july",
         "august", "september", "october", "november", "december"]
    )
}
for _m, _i in list(_MONTHS.items()):
    _MONTHS[_m[:3]] = _i


@dataclasses.dataclass
class NLResult:
    signature: Optional[Signature]
    confidence: float
    raw_json: str
    error: Optional[str] = None
    ambiguities: tuple[str, ...] = ()  # ambiguity types encountered


class NLCanonicalizer(Protocol):
    def canonicalize(self, text: str, now: Optional[_dt.date] = None) -> NLResult: ...

    # Canonicalizers may additionally expose
    #   canonicalize_batch(texts, now) -> list[NLResult]
    # to resolve a whole batch of NL requests in one model call; the service
    # pipeline uses it when present (duck-typed, optional).


# ------------------------------------------------------------ error profiles

# P(resolving a detected ambiguity *incorrectly*), per ambiguity type.
# Calibrated to Table 2 (GPT-4o-mini: 28/63 correct) and Table 5b
# (Claude-3.5-haiku: 38/63).  'compositional_invalid' is the probability a
# multi-measure request yields malformed JSON (5/15 for 4o-mini, 0 for haiku).
MODEL_PROFILES: dict[str, dict[str, float]] = {
    "gpt-4o-mini": {
        "metric": 0.45,
        "time": 0.95,
        "dimension": 0.96,
        "aggregation": 0.65,
        "compositional": 0.18,
        "compositional_invalid": 0.50,
    },
    "claude-3.5-haiku": {
        "metric": 0.20,
        "time": 0.60,
        "dimension": 0.52,
        "aggregation": 0.60,
        "compositional": 0.37,
        "compositional_invalid": 0.0,
    },
    "oracle": {  # for controlled main-workload runs: resolves nothing wrongly
        "metric": 0.0, "time": 0.0, "dimension": 0.0,
        "aggregation": 0.0, "compositional": 0.0, "compositional_invalid": 0.0,
    },
}


def _hash01(text: str, salt: str) -> float:
    h = hashlib.sha256((salt + "|" + text).encode()).digest()
    return int.from_bytes(h[:8], "big") / 2**64


# --------------------------------------------------------------- the parser


class SimulatedLLM:
    """Vocabulary-grounded NL parser with calibrated ambiguity resolution."""

    def __init__(self, vocab: NLVocab, model: str = "gpt-4o-mini"):
        self.vocab = vocab
        self.profile = MODEL_PROFILES[model]
        self.model = model

    # -- confidence bookkeeping: starts high, decays per ambiguity/guess
    def canonicalize(self, text: str, now: Optional[_dt.date] = None) -> NLResult:
        t = text.lower()
        t = re.sub(r"[?!,;:]", " ", t)
        t = re.sub(r"\.(?!\d)", " ", t)  # keep decimal points, drop periods
        t = " " + re.sub(r"\s+", " ", t.strip()) + " "
        conf = 0.92 + 0.08 * _hash01(text, "jitter")
        ambiguities: list[str] = []

        try:
            measures, conf = self._parse_measures(t, text, conf, ambiguities)
            if measures is None:  # malformed-output simulation
                return NLResult(None, 0.0, "", "malformed JSON from model",
                                tuple(ambiguities))
            levels, conf = self._parse_levels(t, text, conf, ambiguities)
            filters, conf = self._parse_filters(t, conf)
            tw, conf = self._parse_time(t, text, now, conf, ambiguities)
            limit, order, conf = self._parse_topk(t, levels, conf)
            having, conf = self._parse_having(t, conf)
            if not measures:
                return NLResult(None, 0.2 * conf, "", "no measure recognized",
                                tuple(ambiguities))
            sig = Signature(
                schema=self.vocab.schema,
                measures=tuple(measures),
                levels=tuple(levels),
                filters=tuple(filters),
                time_window=tw,
                having=tuple(having),
                order_by=tuple(order),
                limit=limit,
            )
        except Exception as e:  # any construction failure = invalid output
            return NLResult(None, 0.0, "", f"invalid signature: {e}", tuple(ambiguities))
        raw = json.dumps({**sig.to_json(), "confidence": round(conf, 3)}, sort_keys=True)
        return NLResult(sig, round(conf, 3), raw, None, tuple(ambiguities))

    # ------------------------------------------------------------- measures
    def _resolve(self, text: str, options, amb_type: str, ambiguities: list[str]):
        """Pick among ambiguous options with the calibrated error rate: index 0
        is the conventional/correct reading; a 'wrong' draw takes another."""
        if len(options) == 1:
            return options[0], 1.0
        ambiguities.append(amb_type)
        p_wrong = self.profile.get(amb_type, 0.5)
        r = _hash01(text, amb_type)
        # confidence correlates (noisily) with difficulty: the draws that
        # resolve wrongly skew lower — miscalibrated but informative, which is
        # what makes threshold gating useful at all (Table 3a)
        if r < p_wrong:
            alt = 1 + int(_hash01(text, amb_type + "#alt") * (len(options) - 1))
            return options[min(alt, len(options) - 1)], 0.30 + 0.26 * _hash01(text, amb_type + "#c")
        return options[0], 0.48 + 0.26 * _hash01(text, amb_type + "#c2")

    _FILTER_USE_RE = re.compile(
        r"^\s*(?:under|below|over|above|between|less than|more than|at least|at most)\s+\d"
    )

    def _parse_measures(self, t: str, raw_text: str, conf: float, ambiguities: list[str]):
        found: list[tuple[int, str, tuple[MeasureSense, ...]]] = []
        for noun, senses in self.vocab.measures.items():
            pos = t.find(" " + noun + " ")
            if pos < 0:
                pos = t.find(" " + noun + "s ")
            if pos >= 0:
                # a noun immediately followed by a comparator is a filter
                # usage ('quantity under 25'), not a requested measure
                after = t[pos + len(noun) + 2:]
                if noun in self.vocab.numeric_cols and self._FILTER_USE_RE.match(after):
                    continue
                found.append((pos, noun, senses))
        found.sort()
        # drop nouns contained in longer matched nouns at same position
        kept = []
        for pos, noun, senses in found:
            if any(noun != n2 and noun in n2 and abs(pos - p2) <= len(n2) for p2, n2, _ in found):
                continue
            kept.append((pos, noun, senses))
        if len(kept) > 1:  # compositional request (multiple measures)
            # only *ambiguous* compositions trigger the calibrated error model:
            # a measure without an explicit aggregation word, or 3+ measures.
            # 'total sales and total profit' is a clean controlled rewrite.
            explicit = [
                any(p in t[max(0, pos - 28): pos + len(noun) + 2] for p, _ in AGG_WORDS)
                for pos, noun, _ in kept
            ]
            if not all(explicit) or len(kept) > 2:
                ambiguities.append("compositional")
                if _hash01(raw_text, "compositional_invalid") < self.profile["compositional_invalid"]:
                    return None, conf
                p_wrong = self.profile["compositional"]
                if _hash01(raw_text, "compositional") < p_wrong:
                    kept = kept[:1]  # wrong: drops all but one measure
                conf *= 0.7
            else:
                conf *= 0.93
        measures: list[Measure] = []
        for pos, noun, senses in kept:
            sense, c = self._resolve(raw_text, list(senses), "metric", ambiguities)
            conf *= c
            agg, c2 = self._agg_for(t, pos, noun, sense, raw_text, ambiguities)
            conf *= c2
            if agg == "COUNT_DISTINCT":
                measures.append(Measure("COUNT", sense.expr, distinct=True))
            else:
                measures.append(Measure(agg, sense.expr))
        return measures, conf

    def _agg_for(self, t: str, pos: int, noun: str, sense: MeasureSense,
                 raw_text: str, ambiguities: list[str]) -> tuple[str, float]:
        window = t[max(0, pos - 28): pos + len(noun) + 2]
        for phrase, agg in AGG_WORDS:
            if phrase in window:
                return agg, 1.0
        # no aggregation word: ambiguous for flagged nouns ('average trips'
        # vs 'trip count'), default otherwise
        if noun in self.vocab.agg_ambiguous_nouns:
            options = [sense.default_agg, "AVG" if sense.default_agg != "AVG" else "COUNT"]
            agg, c = self._resolve(raw_text, options, "aggregation", ambiguities)
            return agg, c
        return sense.default_agg, 0.97

    # --------------------------------------------------------------- levels
    def _parse_levels(self, t: str, raw_text: str, conf: float, ambiguities: list[str]):
        levels: list[str] = []
        m = re.search(r" (?:by|per|for each|broken down by|grouped by) ", t)
        if not m:
            return levels, conf
        tail = t[m.end() - 1:]
        # strip relative-time phrases — 'last month' / 'this year' must not
        # contribute month/year grouping levels
        tail = RELATIVE_TIME_RE.sub(" ", tail)
        # strip filter value phrases — 'for category mfgr#12' must not
        # contribute a 'category' grouping level
        for val in sorted(self.vocab.values, key=len, reverse=True):
            tail = tail.replace(" " + val.lower() + " ", " ")
        # longest-noun-first matching over the grouping vocabulary
        for noun in sorted(self.vocab.levels, key=len, reverse=True):
            pat = " " + noun + " "
            if pat in tail or (" " + noun + "s ") in tail:
                options = list(self.vocab.levels[noun])
                lv, c = self._resolve(raw_text, options, "dimension", ambiguities)
                conf *= c
                if lv not in levels:
                    levels.append(lv)
                tail = tail.replace(pat, " ")
        return levels, conf

    # -------------------------------------------------------------- filters
    def _parse_filters(self, t: str, conf: float):
        filters: list[Filter] = []
        for val in sorted(self.vocab.values, key=len, reverse=True):
            if (" " + val.lower() + " ") in t:
                options = self.vocab.values[val]
                col, v = options[0]
                if len(options) > 1:
                    conf *= 0.8
                filters.append(Filter(col, "=", v))
                t = t.replace(" " + val.lower() + " ", " ")
        for noun, col in self.vocab.numeric_cols.items():
            m = re.search(
                rf"\b{re.escape(noun)}\b\s+between\s+(\d+(?:\.\d+)?)\s+and\s+(\d+(?:\.\d+)?)",
                t,
            )
            if m:
                filters.append(Filter(col, ">=", float(m.group(1))))
                filters.append(Filter(col, "<=", float(m.group(2))))
                conf *= 0.95
                continue
            # no digits may sit between the noun and its comparator — keeps
            # 'discount between 1 and 3 and quantity under 25' from binding
            # 'discount' to 'under 25'
            m = re.search(
                rf"\b{re.escape(noun)}\b[^\d.;]*?\b(under|below|less than|at most|over|above|more than|at least)\s+(\d+(?:\.\d+)?)",
                t,
            )
            if not m:
                m = re.search(
                    rf"\b(under|below|less than|at most|over|above|more than|at least)\s+(\d+(?:\.\d+)?)\s+{re.escape(noun)}\b",
                    t,
                )
            if m:
                word, num = m.group(1), float(m.group(2))
                op = {"under": "<", "below": "<", "less than": "<", "at most": "<=",
                      "over": ">", "above": ">", "more than": ">", "at least": ">="}[word]
                filters.append(Filter(col, op, num))
                conf *= 0.95
        return filters, conf

    # ----------------------------------------------------------------- time
    def _parse_time(self, t: str, raw_text: str, now: Optional[_dt.date],
                    conf: float, ambiguities: list[str]):
        # explicit quarter: 'q1 2024' / 'first quarter of 2024'
        m = re.search(r"\bq([1-4])\s*(?:of\s*)?(\d{4})\b", t)
        if m:
            q, y = int(m.group(1)), int(m.group(2))
            sm = 3 * (q - 1) + 1
            start = _dt.date(y, sm, 1)
            end = _dt.date(y + (q == 4), (sm + 3 - 1) % 12 + 1, 1)
            return TimeWindow(start.isoformat(), end.isoformat()), conf
        m = re.search(
            r"\b(january|february|march|april|may|june|july|august|september|october|november|december|jan|feb|mar|apr|jun|jul|aug|sep|oct|nov|dec)\s+(\d{4})\b",
            t,
        )
        if m:
            mo, y = _MONTHS[m.group(1)], int(m.group(2))
            start = _dt.date(y, mo, 1)
            end = _dt.date(y + (mo == 12), mo % 12 + 1, 1)
            return TimeWindow(start.isoformat(), end.isoformat()), conf
        m = re.search(r"\b(?:from|between)\s+(\d{4})\s+(?:to|and|through)\s+(\d{4})\b", t)
        if m:
            y1, y2 = int(m.group(1)), int(m.group(2))
            return TimeWindow(f"{y1:04d}-01-01", f"{y2 + 1:04d}-01-01"), conf
        m = re.search(r"\b(?:in|during|for)\s+(\d{4})\b", t)
        if m:
            y = int(m.group(1))
            return TimeWindow(f"{y:04d}-01-01", f"{y + 1:04d}-01-01"), conf
        m = re.search(r"\bfrom\s+(\d{4}-\d{2}-\d{2})\s+to\s+(\d{4}-\d{2}-\d{2})\b", t)
        if m:
            return TimeWindow(m.group(1), m.group(2)), conf
        rel = RELATIVE_TIME_RE.search(t)
        if rel:
            ambiguities.append("time")
            if now is None:
                # paper's headline time failure: 'last month' without a current
                # date context — the model guesses an anchor
                p_wrong = self.profile["time"]
                wrong = _hash01(raw_text, "time") < p_wrong
                anchor = _dt.date(2023, 6, 15) if wrong else _dt.date(2024, 3, 15)
                conf *= ((0.34 + 0.2 * _hash01(raw_text, "time#c")) if wrong
                         else (0.52 + 0.2 * _hash01(raw_text, "time#c2")))
            else:
                anchor = now
                conf *= 0.9
            win = self._relative_window(rel.group(0).strip(), anchor)
            if win is not None:
                return win, conf
            return None, conf * 0.6
        return None, conf

    @staticmethod
    def _relative_window(phrase: str, anchor: _dt.date) -> Optional[TimeWindow]:
        first_of_month = anchor.replace(day=1)
        if "month" in phrase:
            prev_end = first_of_month
            prev_start = (first_of_month - _dt.timedelta(days=1)).replace(day=1)
            if phrase.startswith("this"):
                return TimeWindow(first_of_month.isoformat(),
                                  anchor.isoformat(), open_ended=True)
            return TimeWindow(prev_start.isoformat(), prev_end.isoformat(), open_ended=True)
        if "quarter" in phrase:
            q = (anchor.month - 1) // 3
            qstart = _dt.date(anchor.year, 3 * q + 1, 1)
            if phrase.startswith("this"):
                return TimeWindow(qstart.isoformat(), anchor.isoformat(), open_ended=True)
            pq_end = qstart
            pq_start = _dt.date(anchor.year - (q == 0), (3 * ((q - 1) % 4)) + 1, 1)
            return TimeWindow(pq_start.isoformat(), pq_end.isoformat(), open_ended=True)
        if "year" in phrase:
            if phrase.startswith("this"):
                return TimeWindow(f"{anchor.year}-01-01", anchor.isoformat(), open_ended=True)
            return TimeWindow(f"{anchor.year - 1}-01-01", f"{anchor.year}-01-01", open_ended=True)
        m = re.search(r"(\d+)\s+days?", phrase)
        if m:
            d = int(m.group(1))
            return TimeWindow((anchor - _dt.timedelta(days=d)).isoformat(),
                              anchor.isoformat(), open_ended=True)
        if "yesterday" in phrase:
            y = anchor - _dt.timedelta(days=1)
            return TimeWindow(y.isoformat(), anchor.isoformat(), open_ended=True)
        return None

    # ---------------------------------------------------------------- having
    def _parse_having(self, t: str, conf: float):
        """'… having <anything> over 100' -> HAVING on the first measure."""
        from .signature import HavingClause

        m = re.search(
            r"\bhaving\b[^0-9]*?\b(over|above|more than|at least|under|below|less than|at most)\s+(\d+(?:\.\d+)?)",
            t,
        )
        if not m:
            return [], conf
        op = {"over": ">", "above": ">", "more than": ">", "at least": ">=",
              "under": "<", "below": "<", "less than": "<", "at most": "<="}[m.group(1)]
        return [HavingClause(0, op, float(m.group(2)))], conf * 0.92

    # ----------------------------------------------------------------- top-k
    def _parse_topk(self, t: str, levels: list[str], conf: float):
        m = re.search(r"\btop\s+(\d+)\b", t)
        if not m or not levels:
            return None, [], conf
        from .signature import OrderKey

        return int(m.group(1)), [OrderKey("measure:0", desc=True)], conf * 0.95


class MemoizedNL:
    """NL-string -> signature memo (§4): repeat NL requests skip the model."""

    def __init__(self, inner: NLCanonicalizer):
        self.inner = inner
        # one memo serves every request thread of a tenant; the inner model
        # call runs outside the lock (a lost race costs one duplicate model
        # call for the same text — setdefault keeps one canonical result)
        self._lock = make_lock("MemoizedNL._lock")
        self._memo: dict[tuple[str, Optional[str]], NLResult] = {}  # guarded-by: self._lock
        self.calls = 0  # guarded-by: self._lock
        self.memo_hits = 0  # guarded-by: self._lock

    def canonicalize(self, text: str, now: Optional[_dt.date] = None) -> NLResult:
        key = (text, now.isoformat() if now else None)
        with self._lock:
            res = self._memo.get(key)
            if res is not None:
                self.memo_hits += 1
                return res
            self.calls += 1
        res = self.inner.canonicalize(text, now)
        with self._lock:
            return self._memo.setdefault(key, res)

    def canonicalize_batch(self, texts: list[str],
                           now: Optional[_dt.date] = None) -> list[NLResult]:
        """Batch front door: memoized texts are served directly; the rest go
        to the inner canonicalizer's batch entry point in one call (falling
        back to a loop when it has none)."""
        nowk = now.isoformat() if now else None
        with self._lock:
            fresh = [t for t in texts if (t, nowk) not in self._memo]
            # preserve first-occurrence order, drop duplicates within batch
            fresh = list(dict.fromkeys(fresh))
            if fresh:
                self.calls += len(fresh)
        if fresh:
            batch_fn = getattr(self.inner, "canonicalize_batch", None)
            if batch_fn is not None:
                results = batch_fn(fresh, now)
            else:
                results = [self.inner.canonicalize(t, now) for t in fresh]
        fresh_set = set(fresh)
        with self._lock:
            if fresh:
                for t, r in zip(fresh, results):
                    self._memo.setdefault((t, nowk), r)
            out = []
            for t in texts:
                if t not in fresh_set:
                    self.memo_hits += 1
                out.append(self._memo[(t, nowk)])
        return out

    def clear(self) -> None:
        with self._lock:
            self._memo.clear()
            self.calls = 0
            self.memo_hits = 0
