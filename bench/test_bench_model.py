"""The model check of a configuration that brings its own NL canonicalizer
(``yardstick/llm.py`` over the reduced ``canonicalizer-100m`` in float32,
against ``yardstick/dense_ref.py``), on the CPU: it passes a sound batch,
fails the faults it must fail, and shows the engine's left-pad defect; and
a model configuration, its NL mix and its cell come to the harness as new
files only."""
import collections
import json
import shutil
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

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


def test_left_padding_fails_the_logit_gap():
    """The engine's left-pad defect (ROADMAP Queue 3): ``ServingEngine.
    generate`` left-pads a batch to its longest prompt, and the model's
    attention sees the pads and takes them as positions, so the shorter
    question's logits depart from its unpadded forward pass.  A batch of
    questions of different lengths must fail ``logit_gap`` on today's
    engine, and each question alone must pass.  The model configuration's
    PR masks the pads in the engine (attention and SSM state), after which
    this test is to assert that the mixed batch passes."""
    assert logit_gap([[SHORT]]) <= LOGIT_GAP and logit_gap([[LONG]]) <= LOGIT_GAP
    assert logit_gap([[SHORT, LONG]]) > 100 * LOGIT_GAP


@pytest.mark.parametrize("fault", llm.FAULTS)
def test_a_broken_model_fails_the_logit_gap(fault):
    """The program's logits rounded to bfloat16, or one weight of its output
    head moved by 1e-2, fail the limit by two orders of magnitude."""
    assert logit_gap([[SHORT]], fault=fault) > 100 * LOGIT_GAP


def test_nothing_replayed_is_not_correct():
    assert llm.judge([], canon_config(), 1, "cpu")["logit_gap"]["value"] == float("inf")


def test_the_weights_are_the_seeds():
    cfg, _ = llm.model_config(canon_config())
    a, b, c = (llm.draw_params(cfg, s, "cpu") for s in (2**40 + 3, 2**40 + 3, 7))
    assert (a["lm_head"] == b["lm_head"]).all() and not (a["lm_head"] == c["lm_head"]).all()
    assert a["layers"][1]["ln2"].abs().max() > 0  # vectors drawn too, not zeros


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


def test_a_model_configuration_is_new_files_only(tmp_path):
    """A copy of ``bench/`` with a model configuration, an NL mix and a cell
    added, and nothing else changed: ``run_cell`` runs it end to end on the
    CPU; NL requests reach the engine, their outcomes are classed, and
    ``compared`` holds ``logit_gap`` and the NL requests' numbers with
    their limits; with weights drawn at random every question is gated, so
    the run is not correct though its model agrees with the reference; the
    same run with the model's logits rounded to bfloat16 underneath fails
    ``logit_gap``; no file of the copy differs from ``bench/``'s
    afterwards.  The mix asks one
    question a call, so that every engine batch is of one: a batch of
    questions of different lengths fails on the engine's left pads
    (``test_left_padding_fails_the_logit_gap``)."""
    ignore = shutil.ignore_patterns("__pycache__")
    shutil.copytree(BENCH, tmp_path / "bench", ignore=ignore)
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    _new_cell_files(tmp_path)
    code = textwrap.dedent(f"""
        import collections, json, sys, time
        sys.path[:0] = [{str(tmp_path / "bench")!r}, {str(ROOT / "src")!r}]
        from yardstick import compare, harness, llm
        built, runs = [], []
        llm.REPLAY_BATCHES = 1  # the run's longest batch and one drawn: shorter on the CPU
        build, check = llm.build, harness.check
        llm.build = lambda *a: built.append(build(*a)) or built[-1]
        harness.check = lambda run, *a: runs.append(run) or check(run, *a)
        out, broken = (harness.run_cell("canon-ssb-sf1.nl-single", 2**32 + 5, 1.5, False, "cpu",
                                        time.perf_counter(), sizes={SMALL!r}, fault=fault,
                                        log=lambda _: None) for fault in (None, "logits_bf16"))
        classes = collections.Counter(compare.answer_class(s) for s in runs[0].served)
        print(json.dumps({{"out": out, "broken": broken, "classes": classes,
                          "steps": built[0].bench_front.service.engine.steps,
                          "nl": sum(s.req.nl is not None for s in runs[0].served),
                          "module": harness.__file__}}))
    """)
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600, cwd=tmp_path)
    assert res.returncode == 0, res.stderr[-3000:]
    got = json.loads(res.stdout.strip().splitlines()[-1])
    assert got["module"].startswith(str(tmp_path))
    assert got["steps"] > 0
    assert got["nl"] > 0 and sum(got["classes"].values()) == got["nl"]
    assert all(k.startswith("nl.") for k in got["classes"])
    gap = got["out"]["compared"]["logit_gap"]
    assert gap["limit"] == LOGIT_GAP and 0 < gap["value"] <= LOGIT_GAP
    # weights drawn at random: the gate bypasses every question, so the run
    # compares no answer and is not correct, whatever its logit_gap reads
    numbers = got["out"]["compared"]
    assert got["classes"] == {"nl.gated": got["nl"]}
    assert numbers["answers"] == {"value": 0, "limit": 1}
    assert numbers["nl_gated_share"] == {"value": 1.0, "limit": NL_LIMITS["nl_gated_share"]}
    assert numbers["nl_unmapped"] == {"value": 0, "limit": NL_LIMITS["nl_unmapped"]}
    assert not got["out"]["correct"] and got["out"]["attempted"] == got["nl"]
    assert got["out"]["failed"] == 0
    assert not got["broken"]["correct"]
    assert got["broken"]["compared"]["logit_gap"]["value"] > 100 * LOGIT_GAP
    for f in BENCH.rglob("*"):
        if f.is_file() and "__pycache__" not in f.parts:
            assert (tmp_path / "bench" / f.relative_to(BENCH)).read_bytes() == f.read_bytes(), f
