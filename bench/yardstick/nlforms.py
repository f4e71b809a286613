"""The questions of a natural-language mix: an :class:`flights.Intent` said
in one of the paper's controlled paraphrases (section 5.1: manually
authored rewrites of known intents over the workload's NL building
blocks, with unambiguous references).

A frozen copy, with additions, of the port's paraphrase generator
(``src/repro_torch/workloads/paraphrase.py``: its 12 templates and its
words for "by") and of SSB's NL building blocks
(``src/repro_torch/workloads/ssb.py``: ``build_vocab``'s measure and level
words and context-qualified values, and the ``nl_*`` phrases of its
intents).  The benchmark reads nothing of ``workloads/`` when it runs;
``test_bench_copies.py`` holds the copy to its source.

Phrasing ``f`` is the port's paraphrase ``f`` of seed 0: template ``f``
and "by" word ``f % 5``.  An intent's building blocks:

* measure: "total " and the vocabulary's measure word;
* levels: the vocabulary's level words, joined by " and ";
* filters: a region as the vocabulary qualifies it ("customers in asia",
  "suppliers in europe"), any other dimension value after its level word
  ("category mfgr#12", "customer city united ki1"), a number after its
  column word with the port's comparatives ("discount between 1 and 3",
  "quantity under 25"); each led by "with" (the fact's numbers), "from"
  (the supplier) or "for", or by "and" after a filter of the same family,
  as the port's intents lead them;
* time: "in 1993", "in january 1994", "in q1 1994", "from 1992 to 1997".

Values are lower-cased, as the vocabulary writes them, and keep their own
spaces (SSB pads a city's nation to nine letters).  Added where the
source has no words, in its pattern: lists ("customer city united ki1 or
united ki5"), runs ("brand between mfgr#2221 and mfgr#2228"), a week of a
year ("in week 6 of 1994") and the price floor ("extended price at least
5000").  The same intent and form give the same text.
"""
from __future__ import annotations

from .flights import Intent, Pred

# paraphrase.py's _TEMPLATES and _BY_WORDS
TEMPLATES = (
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
)
BY_WORDS = ("by", "per", "broken down by", "grouped by", "for each")
N_FORMS = len(TEMPLATES)

# build_vocab's measure words, as its intents say them ("total ...")
MEASURE_WORDS = {
    "disc_revenue": "total discounted revenue",
    "revenue": "total revenue",
    "profit": "total profit",
}
# build_vocab's unambiguous level words
LEVEL_WORDS = {
    "dates.d_year": "year",
    "dates.d_quarter": "quarter",
    "dates.d_yearmonth": "month",
    "customer.c_region": "customer region",
    "customer.c_nation": "customer nation",
    "customer.c_city": "customer city",
    "supplier.s_region": "supplier region",
    "supplier.s_nation": "supplier nation",
    "supplier.s_city": "supplier city",
    "part.p_brand": "brand",
    "part.p_category": "category",
    "part.p_mfgr": "manufacturer",
}
# build_vocab's context-qualified region values
REGION_WORDS = {"customer.c_region": "customers in", "supplier.s_region": "suppliers in"}
# build_vocab's numeric columns, and the price floor's
NUMBER_WORDS = {
    "lineorder.lo_discount": "discount",
    "lineorder.lo_quantity": "quantity",
    "lineorder.lo_extendedprice": "extended price",
}
MONTH_WORDS = ("january", "february", "march", "april", "may", "june", "july", "august",
               "september", "october", "november", "december")
TIME_COLUMNS = ("dates.d_year", "dates.d_quarter", "dates.d_yearmonthnum",
                "dates.d_yearmonth", "dates.d_weeknuminyear")
_SPACE = "\x00"  # a value's own space, kept through the collapse of the template's


def _value(v) -> str:
    return str(v).lower().replace(" ", _SPACE)


def _family(col: str) -> str:
    table = col.split(".")[0]
    return {"customer": "geo", "supplier": "geo"}.get(table, table)


def _lead(col: str) -> str:
    table = col.split(".")[0]
    return {"lineorder": "with", "supplier": "from"}.get(table, "for")


def _said(p: Pred) -> str:
    """A filter's words, without its lead."""
    v = [_value(x) for x in p.val]
    if p.col in REGION_WORDS and p.op == "=":
        return f"{REGION_WORDS[p.col]} {v[0]}"
    word = NUMBER_WORDS.get(p.col) or LEVEL_WORDS[p.col]
    if p.op == "=":
        return f"{word} {v[0]}"
    if p.op == "in":
        return f"{word} {' or '.join(v)}"
    if p.op == "between":
        return f"{word} between {v[0]} and {v[1]}"
    if p.op == "<":
        return f"{word} under {v[0]}"
    if p.op == ">=":
        return f"{word} at least {v[0]}"
    raise ValueError(f"no words for {p}")


def filters(it: Intent) -> list[str]:
    """The intent's filters on other columns than time, each with its
    lead."""
    out, last = [], None
    for p in it.preds:
        if p.col in TIME_COLUMNS:
            continue
        lead = "and" if _family(p.col) == last else _lead(p.col)
        out.append(f"{lead} {_said(p)}")
        last = _family(p.col)
    return out


def _month(p: Pred) -> str:
    v = p.val[0]
    if p.col == "dates.d_yearmonthnum":
        return f"{MONTH_WORDS[v % 100 - 1]} {v // 100}"
    month = next(m for m in MONTH_WORDS if m[:3] == v[:3].lower())
    return f"{month} {v[3:]}"


def time(it: Intent) -> str:
    """The intent's time window in words ("" where it has none)."""
    preds = {p.col: p for p in it.preds if p.col in TIME_COLUMNS}
    out = []
    week, year = preds.pop("dates.d_weeknuminyear", None), preds.get("dates.d_year")
    if week is not None and week.op == "=":
        if year is not None and year.op == "=":
            del preds["dates.d_year"]
            out.append(f"in week {week.val[0]} of {year.val[0]}")
        else:
            out.append(f"in week {week.val[0]}")
    elif week is not None:
        raise ValueError(f"no words for {week}")
    for p in preds.values():
        if p.col == "dates.d_year" and p.op == "=":
            out.append(f"in {p.val[0]}")
        elif p.col == "dates.d_year" and p.op == "between":
            out.append(f"from {p.val[0]} to {p.val[1]}")
        elif p.col == "dates.d_quarter" and p.op == "=":
            out.append(f"in q{p.val[0][-1]} {p.val[0][:4]}")
        elif p.op == "=" and p.col in ("dates.d_yearmonthnum", "dates.d_yearmonth"):
            out.append(f"in {_month(p)}")
        else:
            raise ValueError(f"no words for {p}")
    return " ".join(out)


def render(it: Intent, f: int) -> str:
    """The question of intent ``it`` in phrasing ``f`` (0 to N_FORMS - 1),
    assembled as the port's ``gen_paraphrases`` assembles it."""
    if not 0 <= f < N_FORMS:
        raise ValueError(f"form {f} outside 0..{N_FORMS - 1}")
    by = ""
    if it.levels:
        by = BY_WORDS[f % len(BY_WORDS)] + " " + " and ".join(LEVEL_WORDS[lv] for lv in it.levels)
    s = TEMPLATES[f].format(measures=MEASURE_WORDS[it.measure], by=by,
                            filters=" ".join(filters(it)), time=time(it), extra="")
    s = " ".join(s.split())
    s = s.replace(" ?", "?").replace(" ,", ",").rstrip()
    if s.endswith(","):
        s = s[:-1]
    return s.replace(_SPACE, " ")
