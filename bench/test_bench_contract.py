"""BENCHMARK.json against the benchmark's contract: names, units, files
found by name, and the time a full check takes."""
import importlib.util
import json
import re
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
METRICS = SPEC["end_to_end"] + SPEC["per_layer"]


def test_top_level_keys():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["bench"] and SPEC["command"] == ["python3", "bench/run.py"]
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


@pytest.mark.parametrize("name", [m["name"] for m in METRICS]
                         + [c["name"] for c in SPEC["workloads"] + SPEC["configs"]]
                         + [c["traffic"] for c in SPEC["workloads"]])
def test_names_use_allowed_characters(name):
    assert NAME.match(name), name


@pytest.mark.parametrize("metric", METRICS, ids=lambda m: m["name"])
def test_metric_entries(metric):
    assert UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    cells = {c["name"] for c in SPEC["workloads"]}
    assert set(metric.get("workloads", cells)) <= cells
    if metric in SPEC["end_to_end"]:
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25
    else:
        assert metric["moves"] in {m["name"] for m in SPEC["end_to_end"]}
        end = next(m for m in SPEC["end_to_end"] if m["name"] == metric["moves"])
        assert set(metric["workloads"]) <= set(end.get("workloads", cells))


@pytest.mark.parametrize("metric", SPEC["per_layer"], ids=lambda m: m["name"])
def test_every_per_layer_metric_has_its_reader(metric):
    path = BENCH / "metrics" / f"{metric['name']}.py"
    spec = importlib.util.spec_from_file_location("reader", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert callable(mod.read)


@pytest.mark.parametrize("cell", SPEC["workloads"], ids=lambda c: c["name"])
def test_cells_find_their_files(cell):
    assert cell["chips"] in (1, 4) and 1 <= len(cell["why"]) <= 200
    cfg = json.loads((BENCH / "configs" / f"{cell['config']}.json").read_text())
    assert cfg["name"] == cell["config"]
    assert (BENCH / "traffic" / f"{cell['traffic']}.json").exists()
    reports = [m for m in SPEC["end_to_end"] if cell["name"] in m.get("workloads", [cell["name"]])]
    assert "setup_s" in {m["name"] for m in reports} and len(reports) >= 2
    assert any(cell["name"] in m["workloads"] for m in SPEC["per_layer"])
    assert cell["config"] in {c["name"] for c in SPEC["configs"]}


@pytest.mark.parametrize("config", SPEC["configs"], ids=lambda c: c["name"])
def test_configs(config):
    path = ROOT / config["file"]
    cfg = json.loads(path.read_text())
    assert config["reduced"] == cfg["reduced"] == []
    assert path.parent == BENCH / "configs"
    assert 1 <= len(config["source"]) <= 200


@pytest.mark.parametrize("path", sorted((BENCH / "configs").glob("*.json")), ids=lambda p: p.stem)
def test_the_modules_a_configuration_names_load(path):
    """Every configuration file's ``generator`` and ``reference`` modules,
    and where it has a canonicalizer its ``module`` and
    ``model_reference``, exist under ``bench/`` and load with the
    functions that the harness and ``control.py`` call."""
    from yardstick import modules

    cfg = json.loads(path.read_text())
    gen, ref = modules.load(cfg["generator"]), modules.load(cfg["reference"])
    assert callable(gen.generate) and callable(gen.port_dataset) and callable(ref.Reference)
    assert callable(ref.Reference.answer) and callable(ref.Reference.intent_of)
    canon = cfg.get("canonicalizer")
    if canon is not None:
        mod = modules.load(canon["module"])
        assert all(callable(getattr(mod, f))
                   for f in ("build", "replay", "judge", "plant", "control"))
        if "model_reference" in canon:
            assert callable(modules.load(canon["model_reference"]).forward)


def test_a_module_outside_the_benchmark_is_refused():
    from yardstick import modules

    for rel in ("../src/repro_torch/__init__.py", "yardstick/none.py", "configs/ssb-sf1.json"):
        with pytest.raises(SystemExit):
            modules.load(rel)
    assert modules.load("yardstick/llm.py") is modules.load("yardstick/llm.py")


def test_a_full_check_fits_its_time():
    runs = 2 + 14 * 24
    total = runs * (SPEC["run_seconds"] + 60) + 24 * 2 * 90 + 1200
    assert 1 <= SPEC["run_seconds"] <= 51 and total <= 43200
