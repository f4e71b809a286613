"""The model check of a configuration that brings its own NL canonicalizer
(``yardstick/llm.py`` over the reduced ``canonicalizer-100m`` in float32,
against ``yardstick/dense_ref.py``), on the CPU: it passes a sound batch,
judges a mixed one, fails the faults it must fail, and its FP8 control
fails; and a model configuration, its NL mix and its cell come to the
harness as new files only, whatever the canonicalizer writes."""
import collections
import json
import shutil
import subprocess
import sys
import textwrap
import types
from pathlib import Path

import pytest
import torch

from yardstick import llm, nlforms
from yardstick.flights import Intent, Pred

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
SMALL = {"lineorder": 20_000, "customer": 1_500, "supplier": 200, "part": 4_000}
# float32 program against the float32 reference: sound batches of one read
# 7.0e-7 to 7.4e-7 (seeds 1, 2**32 + 5, 99), the two faults 2.0e-3 to 6.4e-3
LOGIT_GAP = 1e-5
ENTRY = {"module": "yardstick/llm.py", "arch": "canonicalizer-100m", "reduced": True,
         "dtype": "float32", "model_reference": "yardstick/dense_ref.py"}
# limits of the NL requests for these tests' configuration (a model cell
# sets its own from its readings)
NL_LIMITS = {"nl_gated_share": 0.1, "nl_unmapped": 0}
SHORT = nlforms.render(Intent("q2.1", "revenue", ("dates.d_year", "part.p_brand"), (
    Pred("part.p_category", "=", ("MFGR#23",)),)), 0)
CITIES = ("FRANCE   6", "FRANCE   0")
LONG = nlforms.render(Intent("q3.3", "revenue", (
    "customer.c_city", "supplier.s_city", "dates.d_year"), (
    Pred("customer.c_city", "in", CITIES), Pred("supplier.s_city", "in", CITIES),
    Pred("dates.d_year", "between", (1993, 1996)))), 1)


def canon_config() -> dict:
    cfg = json.loads((BENCH / "configs" / "ssb-sf1.json").read_text())
    cfg.update(name="canon-ssb-sf1", canonicalizer=dict(ENTRY),
               limits={**cfg["limits"], **NL_LIMITS, "logit_gap": LOGIT_GAP})
    return cfg


def logit_gap(batches, seed=2**32 + 5, fault=None) -> float:
    cfg = canon_config()
    nl = llm.build(cfg, None, seed, "cpu")
    if fault:
        llm.plant(fault, nl)
    records = llm.capture(nl, batches)
    assert records and all(len(r["logits"]) == len(r["fed"]) + 1 for r in records)
    return llm.judge(records, cfg, seed, "cpu")["logit_gap"]["value"]


def test_a_batch_of_one_agrees_with_the_reference():
    assert logit_gap([[LONG]]) <= LOGIT_GAP


def test_a_mixed_batch_is_judged(capsys):
    """Each question alone agrees with the reference; a batch of questions
    of different lengths, as the window forms them, gives well-formed
    records (each row's prompt without the pads before it, a logit row for
    the prefill and each fed token) and a finite ``logit_gap``, whatever
    the engine does with the pads.  Today's engine attends over its left
    pads (ROADMAP Queue A item 3), so the reading printed is far above the
    limit: the program's fix brings its own test that holds a mixed batch
    to the limit."""
    assert logit_gap([[SHORT]]) <= LOGIT_GAP and logit_gap([[LONG]]) <= LOGIT_GAP
    cfg = canon_config()
    nl = llm.build(cfg, None, 2**32 + 5, "cpu")
    records = llm.capture(nl, [[SHORT, LONG]])
    tok = nl.bench_front.service.engine.tok
    assert [r["prompt"] for r in records] == [
        tok.encode(f"question: {q}\nsignature: ", add_bos=True) for q in (SHORT, LONG)]
    assert all(len(r["logits"]) == len(r["fed"]) + 1 for r in records)
    mixed = llm.judge(records, cfg, 2**32 + 5, "cpu")["logit_gap"]["value"]
    assert 0 < mixed < float("inf")
    with capsys.disabled():
        print(f"\n[logit_gap] a mixed batch of two questions: {mixed!r}")


@pytest.mark.parametrize("fault", llm.FAULTS)
def test_a_broken_model_fails_the_logit_gap(fault):
    """The program's logits rounded to bfloat16, one weight of its output
    head moved by 1e-2, or its weights rounded through FP8, fail the limit
    by two orders of magnitude."""
    assert logit_gap([[SHORT]], fault=fault) > 100 * LOGIT_GAP


@pytest.mark.parametrize("seed", [3, 2**32 + 5, 2**40 + 11])
def test_the_fp8_control_fails_against_the_sound_bfloat16_reading(seed):
    """``llm.control`` in bfloat16: the program's weights rounded through
    FP8 read at least 4 times what the sound program reads on the same
    batches (e4m3 keeps 3 bits of mantissa, bfloat16 7: a rounding 16
    times coarser)."""
    cfg = canon_config()
    cfg["canonicalizer"]["dtype"] = "bfloat16"
    sound, fp8 = llm.control(cfg, None, seed, "cpu", [[SHORT], [LONG]])
    assert 0 < sound["logit_gap"]["value"] and fp8["logit_gap"]["limit"] == LOGIT_GAP
    assert fp8["logit_gap"]["value"] >= 4 * sound["logit_gap"]["value"]


def test_the_fp8_fault_is_undone():
    """``weights_fp8`` rounds every matrix but the family's float32 leaves,
    leaves the vectors, and its undo gives the weights back bit for bit."""
    family = types.SimpleNamespace(build=lambda: types.SimpleNamespace(
        FLOAT32_LEAVES=frozenset({"a_log"})))
    tree = {"a_log": torch.randn(4, 4), "w": [torch.randn(4, 4)], "v": torch.randn(4)}
    kept = {k: v.clone() for k, v in (("a_log", tree["a_log"]), ("v", tree["v"]))}
    w = tree["w"][0].clone()
    llm.round_fp8(family, tree)
    assert all(torch.equal(tree[k], v) for k, v in kept.items())
    assert not torch.equal(tree["w"][0], w) and len(tree["w"][0].unique()) <= 256
    cfg = canon_config()
    nl = llm.build(cfg, None, 7, "cpu")
    params = nl.bench_front.service.engine.params
    before = {k: v.clone() for k, v in params["layers"][0].items()}
    head = params["lm_head"].clone()
    undo = llm.plant("weights_fp8", nl)
    moved = {k for k, v in params["layers"][0].items() if not torch.equal(v, before[k])}
    assert moved == {k for k, v in before.items() if v.dim() >= 2}
    assert not torch.equal(params["lm_head"], head)
    undo()
    assert all(torch.equal(v, before[k]) for k, v in params["layers"][0].items())
    assert torch.equal(params["lm_head"], head)


def test_nothing_replayed_is_not_correct():
    assert llm.judge([], canon_config(), 1, "cpu")["logit_gap"]["value"] == float("inf")


def test_the_weights_are_the_seeds():
    cfg, _ = llm.model_config(canon_config())
    a, b, c = (llm.draw_params(cfg, s, "cpu") for s in (2**40 + 3, 2**40 + 3, 7))
    assert (a["lm_head"] == b["lm_head"]).all() and not (a["lm_head"] == c["lm_head"]).all()
    assert a["layers"][1]["ln2"].abs().max() > 0  # vectors drawn too, not zeros


# makes the engine's constrained decode write, for each question, the
# signature of the intent that the traffic rendered it from (the port's SQL
# canonicalizer over that intent's SQL), as a program whose automaton can
# write SSB's signatures would: the tokens are the writer's, the logits the
# model's
WRITER = '''
from repro_torch.core.sql_canon import SQLCanonicalizer
from repro_torch.serving import engine as engine_mod
from yardstick import nlforms, sqlforms, ssbgen

ASKED, STATE = {}, {}
CANON = SQLCanonicalizer(ssbgen.port_schema())
_render, _generate = nlforms.render, engine_mod.ServingEngine.generate


def _recorded(it, f):
    ASKED[_render(it, f)] = it
    return _render(it, f)


def _generate_signatures(self, prompts, max_new_tokens=128, constrained=False):
    rows = []
    for p in prompts:
        question = p.split("question: ", 1)[1].rsplit("\\nsignature: ", 1)[0]
        text = CANON.canonicalize(sqlforms.render(ASKED[question], 0)).canonical_json()
        rows.append(self.tok.encode(text))
        assert self.tok.decode(rows[-1]) == text
    STATE.update(rows=rows, pos=[0] * len(rows), live=list(range(len(rows))), at=-1)
    return _generate(self, prompts, max(max_new_tokens, max(map(len, rows)) + 1), constrained)


def _write(logits, prefix, vocab, automaton):
    # the engine asks for its unfinished rows in order, once a step
    live, at = STATE["live"], STATE["at"]
    i = next((j for j in live if j > at), live[0])
    STATE["at"], ids, pos = i, STATE["rows"][i], STATE["pos"]
    assert prefix == "".join(vocab[t] for t in ids[:pos[i]])
    if pos[i] == len(ids):
        live.remove(i)
        return -1
    pos[i] += 1
    if pos[i] == len(ids) and automaton.is_complete(prefix + vocab[ids[-1]]):
        live.remove(i)
    return ids[pos[i] - 1]


nlforms.render = _recorded
engine_mod.ServingEngine.generate = _generate_signatures
engine_mod.constrained_sample = _write
'''


def _new_cell_files(tmp: Path) -> None:
    """A model configuration, an NL mix and a cell, as new files beside a
    copy of ``bench/`` (and an entry in the copy of ``BENCHMARK.json``)."""
    cfg = canon_config()
    (tmp / "bench/configs/canon-ssb-sf1.json").write_text(json.dumps(cfg, indent=1))
    mix = {"form": "nl", "loop": "closed", "clients": 1, "dashboards": 0,
           "events": {"single": 1.0}, "regroup": False, "price_floor_share": 0.0,
           "balanced": True, "warmup_events": 0, "max_events": 50, "check": {"per_class": 8}}
    (tmp / "bench/traffic/nl-single.json").write_text(json.dumps(mix))
    spec = json.loads((tmp / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "canon-ssb-sf1", "source": "test",
                            "file": "bench/configs/canon-ssb-sf1.json",
                            "reduced": ["num_hidden_layers"], "why": "test"})
    spec["workloads"].append({"name": "canon-ssb-sf1.nl-single", "config": "canon-ssb-sf1",
                              "traffic": "nl-single", "chips": 1, "why": "test"})
    (tmp / "BENCHMARK.json").write_text(json.dumps(spec))


@pytest.fixture(scope="module")
def model_copy(tmp_path_factory) -> Path:
    """A copy of ``bench/`` and ``BENCHMARK.json`` with a model
    configuration, an NL mix and a cell added as new files."""
    tmp = tmp_path_factory.mktemp("model")
    shutil.copytree(BENCH, tmp / "bench", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp / "BENCHMARK.json")
    _new_cell_files(tmp)
    return tmp


@pytest.mark.parametrize("writer", ["engine", "valid_signatures"])
def test_a_model_configuration_is_new_files_only(model_copy, writer):
    """A copy of ``bench/`` with a model configuration, an NL mix and a cell
    added, and nothing else changed: ``run_cell`` runs it end to end on the
    CPU; NL requests reach the engine, their outcomes are classed, and
    ``compared`` holds ``logit_gap`` and the NL requests' numbers with
    their limits, ``answers`` the answers compared, ``nl_gated_share`` the
    share of questions gated with no table, and ``correct`` follows from
    them by ``compare.judge``'s rule; ``Run.counters`` holds the engine's
    steps in the window; the same run with the model's logits rounded to
    bfloat16 underneath fails ``logit_gap``; no file of the copy differs
    from ``bench/``'s afterwards.  It holds whatever the canonicalizer
    writes: with today's engine (random weights: the automaton cannot
    write SSB's values, so every question is gated), and with a writer
    that makes the constrained decode write each question's signature, so
    that NL answers are compared.  The mix asks one question a call, so
    that every engine batch is of one (``test_a_mixed_batch_is_judged``)."""
    tmp = model_copy
    code = textwrap.dedent(f"""
        import collections, json, sys, time
        sys.path[:0] = [{str(tmp / "bench")!r}, {str(ROOT / "src")!r}]
        from yardstick import compare, harness, llm
        if {writer!r} == "valid_signatures":
            exec({WRITER!r})
        built, runs, window_steps = [], [], []
        llm.REPLAY_BATCHES = 1  # the run's longest batch and one drawn: shorter on the CPU
        build, check, loop = llm.build, harness.check, harness._closed_loop
        llm.build = lambda *a: built.append(build(*a)) or built[-1]

        def checked(run, *a):
            rows, compared = check(run, *a)
            runs.append((run, len(rows)))
            return rows, compared

        def steps_of_the_window(*a, **k):
            engine = built[-1].bench_front.service.engine
            s0 = engine.steps
            out = loop(*a, **k)
            window_steps.append(engine.steps - s0)
            return out

        harness.check, harness._closed_loop = checked, steps_of_the_window
        out, broken = (harness.run_cell("canon-ssb-sf1.nl-single", 2**32 + 5, 1.5, False, "cpu",
                                        time.perf_counter(), sizes={SMALL!r}, fault=fault,
                                        log=lambda _: None) for fault in (None, "logits_bf16"))
        run, rows = runs[0]
        classes = collections.Counter(compare.answer_class(s) for s in run.served)
        print(json.dumps({{"out": out, "broken": broken, "classes": classes, "rows": rows,
                          "counters": run.counters, "window_steps": window_steps[0],
                          "steps": built[0].bench_front.service.engine.steps,
                          "nl": sum(s.req.nl is not None for s in run.served),
                          "module": harness.__file__}}))
    """)
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600, cwd=tmp)
    assert res.returncode == 0, res.stderr[-3000:]
    got = json.loads(res.stdout.strip().splitlines()[-1])
    assert got["module"].startswith(str(tmp))
    assert got["steps"] > 0
    assert got["nl"] > 0 and sum(got["classes"].values()) == got["nl"]
    assert all(k.startswith("nl.") for k in got["classes"])
    numbers = got["out"]["compared"]
    gap = numbers["logit_gap"]
    assert gap["limit"] == LOGIT_GAP and 0 < gap["value"] <= LOGIT_GAP
    # the numbers that the canonicalizer's writing moves, each as the
    # comparison defines it
    assert numbers["answers"] == {"value": got["rows"], "limit": 1}
    gated = got["classes"].get("nl.gated", 0) / got["nl"]
    assert numbers["nl_gated_share"] == {"value": gated, "limit": NL_LIMITS["nl_gated_share"]}
    assert numbers["nl_unmapped"]["limit"] == NL_LIMITS["nl_unmapped"]
    assert got["out"]["correct"] == (numbers["answers"]["value"] >= 1 and all(
        v["value"] <= v["limit"] for k, v in numbers.items() if k != "answers"))
    assert got["out"]["attempted"] == got["nl"] and got["out"]["failed"] == 0
    # the engine's counters over the window, and only the program's
    assert got["counters"]["nl.steps"] == got["window_steps"] > 0
    assert {"nl.steps", "nl.host_s", "nl.model_s"} <= set(got["counters"])
    assert all(k.startswith(("nl.", "launch.")) for k in got["counters"])
    if writer == "valid_signatures":
        assert got["rows"] >= 1 and set(got["classes"]) != {"nl.gated"}
    assert not got["broken"]["correct"]
    assert got["broken"]["compared"]["logit_gap"]["value"] > 100 * LOGIT_GAP
    for f in BENCH.rglob("*"):
        if f.is_file() and "__pycache__" not in f.parts:
            assert (tmp / "bench" / f.relative_to(BENCH)).read_bytes() == f.read_bytes(), f


def test_control_py_prints_a_failing_fp8_line(model_copy):
    """``bench/control.py`` over the model configuration, on the CPU: after
    the reference's bfloat16 control, the model's line and its FP8
    control's, each number beside its limit, on the same batches: the
    model's correct, the FP8 control's not."""
    code = textwrap.dedent(f"""
        import sys
        sys.path[:0] = [{str(model_copy / "bench")!r}, {str(ROOT / "src")!r}]
        import control
        control.main(["--workload", "canon-ssb-sf1.nl-single", "--seeds", "11"],
                     sizes={SMALL!r})
    """)
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600, cwd=model_copy)
    assert res.returncode == 0, res.stderr[-3000:]
    lines = [json.loads(line) for line in res.stdout.strip().splitlines()]
    assert [x["program"] for x in lines] == ["reference_bf16", "model", "model_weights_fp8"]
    assert not lines[0]["correct"]
    model, fp8 = lines[1]["numbers"]["logit_gap"], lines[2]["numbers"]["logit_gap"]
    assert lines[1]["correct"] and model["value"] <= LOGIT_GAP == model["limit"]
    assert not lines[2]["correct"] and fp8["value"] > 100 * LOGIT_GAP
    assert "weights_fp8" in res.stderr.strip().splitlines()[-1]
