"""Natural-language traffic: the phrasings, the NL form of a mix, the
executed signature mapped back to an intent, and NL answers judged on the
signature the service executed (through a canonicalizer that a new file
brings: one that reads each question right, or a year late)."""
import dataclasses
import json
import random
import re
import shutil
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

from yardstick import flights, nlforms, signatures, ssbgen, sqlforms, traffic
from yardstick.reference import Reference, gap

BENCH = Path(__file__).resolve().parent
SMALL = {"lineorder": 20_000, "customer": 1_500, "supplier": 200, "part": 4_000}
NL_LIMITS = {"nl_gated_share": 0.1, "nl_unmapped": 0}


def _intents(flight: str) -> list[flights.Intent]:
    """The flight's intent, with a price floor, drilled and regrouped."""
    rng = random.Random(flight)
    it = flights.draw(rng, flight)
    return [it, flights.with_price_floor(it, rng), flights.drill(it, rng, 0.5),
            flights.regroup(flights.drill(it, rng, 0.0), rng), flights.roll(it, rng)]


@pytest.mark.parametrize("flight", sorted(flights.FLIGHTS))
def test_every_phrasing_says_the_literals(flight):
    for it in _intents(flight):
        texts = [nlforms.render(it, f) for f in range(nlforms.N_FORMS)]
        assert len(set(texts)) == nlforms.N_FORMS
        assert texts == [nlforms.render(it, f) for f in range(nlforms.N_FORMS)]
        for p in it.preds:
            for v in p.val:
                if p.col not in ("dates.d_yearmonthnum", "dates.d_yearmonth"):
                    assert all(str(v).lower() in t for t in texts), (v, texts[0])
        for lv in it.levels:
            assert all(nlforms.LEVEL_WORDS[lv] in t for t in texts)


def test_an_nl_mix_draws_what_its_sql_form_draws():
    """The same mix as SQL and as NL: the same events, intents and due
    times; the phrasing is drawn from a stream of its own."""
    mix = {**traffic.load("dashboard"), "warmup_events": 40}
    sql = traffic.Generator(mix, 2**33 + 1, "window").schedule(3.0)
    nl = traffic.Generator({**mix, "form": "nl"}, 2**33 + 1, "window").schedule(3.0)
    assert [(e.due_s, e.kind, [r.intent for r in e.requests]) for e in sql] == \
        [(e.due_s, e.kind, [r.intent for r in e.requests]) for e in nl]
    reqs = [r for e in nl for r in e.requests]
    assert all(r.nl == nlforms.render(r.intent, r.form) and r.sql == "" for r in reqs)
    assert len({r.form for r in reqs}) == nlforms.N_FORMS
    assert all(r.nl is None for e in sql for r in e.requests)
    with pytest.raises(ValueError):
        traffic.Generator({**mix, "form": "speech"}, 1, "window")


@pytest.fixture(scope="module")
def data():
    return ssbgen.generate(1, 23, sizes=SMALL)


@pytest.mark.parametrize("flight", sorted(flights.FLIGHTS))
def test_an_executed_signature_maps_back_to_its_intent(data, flight):
    """Every intent's SQL forms, canonicalized by the port, map back to an
    intent that the reference answers as it answers the original."""
    from repro_torch.core.sql_canon import SQLCanonicalizer

    canon = SQLCanonicalizer(ssbgen.port_schema())
    ref = Reference(data)
    for it in _intents(flight):
        want = ref.answer(dataclasses.replace(it, levels=tuple(sorted(it.levels))))
        for f in (0, 6, 13, 20):
            got = signatures.intent_of(canon.canonicalize(sqlforms.render(it, f)), data)
            assert got is not None
            differ, widest = gap(ref.answer(got), want)
            assert not differ and widest == 0.0, (it, got)


def test_what_the_reference_cannot_say_maps_to_none(data):
    from repro_torch.core.signature import Filter, Measure, Signature

    rev = Measure("SUM", "lineorder.lo_revenue")
    ok = Signature("ssb", (rev,), ("dates.d_year",))
    assert signatures.intent_of(ok, data) is not None
    for sig in (ok.replace(measures=(Measure("MAX", "lineorder.lo_revenue"),)),
                ok.replace(measures=(Measure("SUM", "lineorder.lo_tax"),)),
                ok.replace(filters=(Filter("customer.c_region", "!=", "ASIA"),)),
                ok.replace(filters=(Filter("lineorder.lo_revenue", ">", 10.5),)),
                ok.replace(levels=("lineorder.lo_quantity",)),
                ok.replace(limit=5)):
        assert signatures.intent_of(sig, data) is None, sig


ORACLE = '''
"""A canonicalizer for the tests: each question's intent, as the traffic
rendered it, through the SQL of its canonical form and the port's SQL
canonicalizer; with "misread" the intent a year later."""
from repro_torch.core.nl_canon import NLResult
from repro_torch.core.sql_canon import SQLCanonicalizer
from yardstick import flights, nlforms, sqlforms, ssbgen

ASKED = {}
_render = nlforms.render


def _recorded(it, f):
    ASKED[_render(it, f)] = it
    return _render(it, f)


nlforms.render = _recorded


class Oracle:
    def __init__(self, misread):
        self.canon = SQLCanonicalizer(ssbgen.port_schema())
        self.misread = misread

    def canonicalize(self, text, now=None):
        return self.canonicalize_batch([text], now)[0]

    def canonicalize_batch(self, texts, now=None):
        out = []
        for t in texts:
            it = flights.shift_time(ASKED[t], 1) if self.misread else ASKED[t]
            sig = self.canon.canonicalize(sqlforms.render(it, 0))
            out.append(NLResult(sig, 1.0, sig.canonical_json(), None))
        return out


def build(config, data, seed, device):
    return Oracle(config["canonicalizer"].get("misread", False))


def replay(nl, run, seed, log):
    return []


def judge(records, config, seed, device):
    return {}
'''


@pytest.fixture(scope="module")
def oracle_runs(tmp_path_factory):
    """Runs of an NL mix over two configurations that bring the oracle as
    a new file: read right, read right over a broken executor, misread."""
    tmp = tmp_path_factory.mktemp("oracle")
    shutil.copytree(BENCH, tmp / "bench", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(BENCH.parent / "BENCHMARK.json", tmp / "BENCHMARK.json")
    (tmp / "bench/yardstick/oracle_nl.py").write_text(ORACLE)
    for name, misread in (("oracle", False), ("misread", True)):
        cfg = json.loads((BENCH / "configs/ssb-sf1.json").read_text())
        cfg.update(name=name, canonicalizer={"module": "yardstick/oracle_nl.py",
                                             "misread": misread},
                   limits={**cfg["limits"], **NL_LIMITS})
        (tmp / f"bench/configs/{name}.json").write_text(json.dumps(cfg))
    mix = {**traffic.load("adhoc"), "form": "nl", "clients": 1, "warmup_events": 5,
           "max_events": 3000, "check": {"per_class": 12}}
    (tmp / "bench/traffic/nl-adhoc.json").write_text(json.dumps(mix))
    code = textwrap.dedent(f"""
        import json, sys, time
        sys.path[:0] = [{str(tmp / "bench")!r}, {str(BENCH.parent / "src")!r}]
        from yardstick import harness, reference
        mapped = []
        intent_of = reference.Reference.intent_of
        reference.Reference.intent_of = lambda ref, sig: mapped.append(1) or intent_of(ref, sig)
        for cell, fault in (("oracle.nl-adhoc", None), ("oracle.nl-adhoc", "alter_answer"),
                            ("misread.nl-adhoc", None)):
            logs = []
            mapped.clear()
            out = harness.run_cell(cell, 2**32 + 77, 1.0, False, "cpu", time.perf_counter(),
                                   sizes={SMALL!r}, fault=fault, log=logs.append)
            nl = [m for m in logs if m.startswith("[compare] NL")]
            print(json.dumps({{"out": out, "nl": nl, "mapped": len(mapped)}}))
    """)
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600, cwd=tmp)
    assert res.returncode == 0, res.stderr[-3000:]
    return [json.loads(line) for line in res.stdout.strip().splitlines()[-3:]]


def test_nl_answers_are_compared_with_the_reference(oracle_runs):
    run = oracle_runs[0]
    assert run["out"]["correct"] and run["out"]["failed"] == 0
    assert run["out"]["compared"]["answers"]["value"] > 12
    assert " 0 of them not the question's intent, 0 not expressible" in run["nl"][0]


def test_a_wrong_nl_answer_is_not_correct(oracle_runs):
    out = oracle_runs[1]["out"]
    assert out["correct"] is False and out["compared"]["widest_gap"]["value"] > 1e-4


def test_a_misread_question_is_judged_on_what_was_executed(oracle_runs):
    """The answers of misread questions are right for what the service
    executed: correct, and counted as not the question's intent."""
    run = oracle_runs[2]
    assert run["out"]["correct"]
    found = re.search(r"(\d+) compared on the executed signature, (\d+) of them", run["nl"][0])
    assert int(found[1]) > 0 and int(found[2]) > 0


def test_nl_answers_are_held_to_their_limits():
    """A window whose questions were all gated compares no answer and is not
    correct; a gated share or unmapped answers over their limits fail; a
    configuration asked NL questions has to state both limits."""
    from yardstick import compare

    limits = {"wrong_groups": 0, "widest_gap": 1e-4, **NL_LIMITS}
    sound = [("nl.miss", False, 0.0)]
    assert compare.judge(sound, limits, nl={"gated_share": 0.05, "unmapped": 0})["correct"]
    for rows, nl in (([], {"gated_share": 1.0, "unmapped": 0}),
                     ([], {"gated_share": 0.0, "unmapped": 0}),
                     (sound, {"gated_share": 0.2, "unmapped": 0}),
                     (sound, {"gated_share": 0.0, "unmapped": 1})):
        out = compare.judge(rows, limits, nl=nl)
        assert not out["correct"] and out["numbers"]["nl_gated_share"]["limit"] == 0.1, nl
    with pytest.raises(SystemExit, match="nl_gated_share"):
        compare.judge(sound, {"wrong_groups": 0, "widest_gap": 1e-4},
                      nl={"gated_share": 0.0, "unmapped": 0})


def test_the_executed_signature_is_mapped_by_the_configurations_reference(oracle_runs):
    """The harness maps an NL answer's executed signature through the
    reference module that the configuration names (``intent_of``), so that
    another schema's reference brings its own mapping."""
    for run in oracle_runs:
        compared = int(re.search(r"(\d+) compared on the executed signature", run["nl"][0])[1])
        assert compared > 0 and run["mapped"] == compared
