"""Each frozen copy in ``bench/`` held to its source in the port, on the
cases where the two should agree."""
import random

import pytest

from yardstick import devtrace, flights, nlforms, signatures, sqlforms, ssbgen


@pytest.fixture(scope="module")
def canon():
    from repro_torch.core.sql_canon import SQLCanonicalizer

    return SQLCanonicalizer(ssbgen.port_schema())


@pytest.mark.parametrize("flight", sorted(flights.FLIGHTS))
def test_every_form_is_one_intent_as_the_ports_variants(canon, flight):
    """The forms canonicalize to one signature, the signature of the port's
    own 21 variants of the canonical form.  Forms of the ``eq_as_in``
    rewrite are left out: the port's canonicalizer keeps ``x IN ('v')``
    apart from ``x = 'v'`` (the same answer under another key), and the
    port's generator drops such a form where the signatures differ; the
    benchmark keeps it, and the reference checks its answers."""
    from repro_torch.workloads.variants import make_variants

    rng = random.Random(flight)
    for it in (flights.draw(rng, flight), flights.with_price_floor(flights.draw(rng, flight), rng)):
        forms = [sqlforms.render(it, f) for f in range(sqlforms.N_FORMS)]
        keys = {canon.canonicalize(t).key() for f, t in enumerate(forms)
                if sqlforms.form_of(f)[0] != "eq_as_in"}
        ported = {canon.canonicalize(t).key()
                  for t in make_variants(forms[0], ssbgen.port_schema(), n=21, seed=1)}
        assert len(keys) == 1 and keys == ported
        assert len(set(forms)) >= 12


def test_hierarchies_are_the_drill_sessions_paths():
    from repro_torch.workloads import hierarchical

    ported = {tuple(path) for _, _, path, _ in hierarchical._HIERARCHIES}
    ours = {tuple(lv.split(".")[1] for lv in path) for path in flights.HIERARCHIES.values()}
    assert ported <= ours
    assert ours - ported == {("c_city", "c_nation", "c_region")} or ours == ported | {
        ("d_yearmonth", "d_quarter", "d_year")}


@pytest.mark.parametrize("shape", [("B", 6_000_000, 2, 3, 2, 6, 35), ("B", 100, 1, 0, 1, 1, 1)])
def test_kernel_b_bytes_as_chip_smoke_counts_them(shape):
    _, n, m, p, k, s, g = shape
    bounds = s * p * k * 2  # the (S, P, K, 2) bounds tensor's elements
    assert devtrace.seg_agg_bytes(shape) == (n * (m + 1 + p) + s * g * m + bounds) * 4


def test_kernel_a_bytes():
    assert devtrace.seg_agg_bytes(("A", 10, 2, 3)) == (10 * 4 + 3 * 2) * 4


def _p(col, op, *val):
    return flights.Pred(col, op, tuple(val))


# the port's SSB intents that say what the benchmark's intents say, each
# as the benchmark's intent of its SQL (ssb_q2_3's words name another
# brand than its SQL, ssb_q3_2's nation is the ambiguous "nation", and
# COUNT and AVG are no measure of the benchmark's)
PORT_INTENTS = {
    "ssb_q1_1": flights.Intent("q1.1", "disc_revenue", (), (
        _p("dates.d_year", "=", 1993), _p("lineorder.lo_discount", "between", 1, 3),
        _p("lineorder.lo_quantity", "<", 25))),
    "ssb_q1_2": flights.Intent("q1.2", "disc_revenue", (), (
        _p("dates.d_yearmonthnum", "=", 199401), _p("lineorder.lo_discount", "between", 4, 6),
        _p("lineorder.lo_quantity", "between", 26, 35))),
    "ssb_q1_3": flights.Intent("q1.3", "disc_revenue", (), (
        _p("dates.d_quarter", "=", "1994Q1"), _p("lineorder.lo_discount", "between", 5, 7))),
    "ssb_q2_1": flights.Intent("q2.1", "revenue", ("dates.d_year", "part.p_brand"), (
        _p("part.p_category", "=", "MFGR#12"), _p("supplier.s_region", "=", "AMERICA"))),
    "ssb_q2_2": flights.Intent("q2.2", "revenue", ("dates.d_year", "part.p_brand"), (
        _p("part.p_category", "=", "MFGR#22"), _p("supplier.s_region", "=", "ASIA"))),
    "ssb_q3_1": flights.Intent(
        "q3.1", "revenue", ("customer.c_nation", "supplier.s_nation", "dates.d_year"), (
            _p("customer.c_region", "=", "ASIA"), _p("supplier.s_region", "=", "ASIA"),
            _p("dates.d_year", "between", 1992, 1997))),
    "ssb_q4_1": flights.Intent("q4.1", "profit", ("dates.d_year", "customer.c_nation"), (
        _p("customer.c_region", "=", "AMERICA"), _p("supplier.s_region", "=", "AMERICA"))),
    "ssb_q4_2": flights.Intent("q4.2", "profit", ("dates.d_year", "supplier.s_nation"), (
        _p("supplier.s_region", "=", "EUROPE"), _p("dates.d_year", "between", 1997, 1998))),
    "ssb_q7_monthly": flights.Intent("q7", "revenue", ("dates.d_yearmonth",), (
        _p("dates.d_year", "=", 1996),)),
}


@pytest.mark.parametrize("name", sorted(PORT_INTENTS))
def test_every_phrasing_is_the_ports_paraphrase(name):
    """Each of the 12 phrasings of an intent is the port's paraphrase of the
    same index (seed 0) of the port's SSB intent that asks it: the paper's
    section 5.1 templates over SSB's NL building blocks."""
    from repro_torch.workloads import paraphrase, ssb

    port = {it.id: it for it in ssb._INTENTS}[name]
    want = paraphrase.gen_paraphrases(port, n=nlforms.N_FORMS, seed=0)
    assert [nlforms.render(PORT_INTENTS[name], f) for f in range(nlforms.N_FORMS)] == want


def test_the_phrasings_words_are_the_ports():
    """The templates and "by" words are the port's, and every measure,
    level, region and number word is one of the SSB vocabulary's with the
    meaning it has there."""
    from repro_torch.workloads import paraphrase, ssb

    assert nlforms.TEMPLATES == tuple(paraphrase._TEMPLATES)
    assert nlforms.BY_WORDS == tuple(paraphrase._BY_WORDS)
    vocab = ssb.build_vocab()
    for measure, words in nlforms.MEASURE_WORDS.items():
        senses = vocab.measures[words.removeprefix("total ")]
        assert [signatures.MEASURE_OF[(s.default_agg, s.expr)] for s in senses] == [measure]
    for col, word in nlforms.LEVEL_WORDS.items():
        assert vocab.levels[word] == (col,)
    for col, word in nlforms.REGION_WORDS.items():
        for region in ssbgen.REGIONS:
            assert vocab.values[f"{word} {region.lower()}"] == ((col, region),)
    for col, word in nlforms.NUMBER_WORDS.items():
        assert vocab.numeric_cols.get(word, col) == col

