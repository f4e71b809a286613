"""The port's roofline (``repro_torch.launch.roofline``) on the CPU.

* Its terms on a hand-made record equal the formulas, at the H100
  datasheet rates; an axis inside a node of 8 takes NVLink's rate, any
  other InfiniBand's (every axis of the production meshes).
* ``model_flops`` equals the reference's ``benchmarks/roofline.py``
  (imported by path) on every record of ``results/dryrun_torch.json``.
* Every record there carries ``bytes_global``, ``bytes_accessed_per_device``
  and collective bytes by mesh axis; the 20 ``zero3_params`` train cells
  are there, ``ok``, with their spec arithmetic's argument bytes.
* On a reduced cell ``bytes_global >= bytes_accessed_per_device``.
* ``main`` prints both meshes' tables and the variants'.
"""
import importlib.util
import json
from pathlib import Path

import pytest

from repro_torch.configs.registry import ASSIGNED, get, reduced
from repro_torch.launch import dryrun, roofline

ROOT = Path(__file__).resolve().parents[1]
RESULTS = ROOT / "results" / "dryrun_torch.json"


def _reference():
    spec = importlib.util.spec_from_file_location("reference_roofline",
                                                  ROOT / "benchmarks" / "roofline.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _records() -> dict:
    return json.loads(RESULTS.read_text())


def _record(mesh_shape: dict, **kw) -> dict:
    rec = {"arch": "qwen3-32b", "shape": "train_4k", "mesh": "single",
           "mesh_shape": mesh_shape, "status": "ok", "flops_global": 1.0e18,
           "bytes_global": 2.2e15, "params_active": 32.8e9,
           "memory": {"argument_bytes": 6.4e10},
           "collectives": {"total_bytes": 3e11,
                           "bytes_by_axis": {"data": 2e11, "model": 1e11}}}
    rec.update(kw)
    return rec


def test_terms_on_a_hand_made_record_equal_the_formulas():
    rec = _record({"data": 16, "model": 16})
    a = roofline.analyze(rec)
    compute = 1.0e18 / (256 * 989e12)
    memory = 2.2e15 / (256 * 3.35e12)
    collective = 2e11 / 50e9 + 1e11 / 50e9
    assert a["compute_s"] == pytest.approx(compute, rel=1e-12)
    assert a["memory_s"] == pytest.approx(memory, rel=1e-12)
    assert a["collective_s"] == pytest.approx(collective, rel=1e-12)
    assert a["collective_s_by_axis"] == pytest.approx({"data": 4.0, "model": 2.0})
    assert a["dominant"] == "collective" and a["step_bound_s"] == a["collective_s"]
    mf = 6.0 * 32.8e9 * 256 * 4096
    assert a["model_flops"] == mf
    assert a["useful_flops_ratio"] == pytest.approx(mf / 1.0e18)
    assert a["roofline_fraction"] == pytest.approx(mf / (256 * 989e12) / collective)
    ref = _reference().analyze({**rec, "collectives": {"total_bytes": 3e11}})
    assert set(ref) <= set(a)


@pytest.mark.parametrize("mesh_shape, want", [
    ({"data": 16, "model": 16}, {"data": 50e9, "model": 50e9}),
    ({"pod": 2, "data": 16, "model": 16}, {"pod": 50e9, "data": 50e9, "model": 50e9}),
    ({"data": 2, "model": 2}, {"data": 450e9, "model": 450e9}),
    ({"data": 4, "model": 8}, {"data": 50e9, "model": 450e9}),
    ({"data": 4, "model": 4}, {"data": 50e9, "model": 450e9}),
])
def test_an_axis_inside_a_node_of_eight_takes_nvlink(mesh_shape, want):
    assert roofline.axis_rates(mesh_shape) == want


def test_model_flops_equal_the_reference_on_every_record():
    ref = _reference()
    recs = [r for r in _records().values() if r.get("status") == "ok"]
    assert len(recs) >= 84
    for rec in recs:
        assert roofline.model_flops(rec) == ref.model_flops(rec), (rec["arch"], rec["shape"])


def test_every_record_has_bytes_and_collectives_by_axis():
    results = _records()
    for key, rec in results.items():
        assert rec["status"] == "ok", key
        assert rec["bytes_global"] > 0 and rec["bytes_accessed_per_device"] > 0, key
        coll = rec["collectives"]
        assert set(coll["bytes_by_axis"]) <= set(rec["mesh_shape"]), key
        assert sum(coll["bytes_by_axis"].values()) == coll["total_bytes"], key
        assert sum(coll["count_by_axis"].values()) == sum(coll["count_by_kind"].values()), key
    for arch in ASSIGNED:
        for mesh in ("single", "multi"):
            rec = results[f"{arch}|train_4k|{mesh}|zero3_params"]
            assert rec["memory"]["argument_bytes"] == dryrun.argument_bytes(
                get(arch), "train_4k", dryrun.MESH_SHAPES[mesh], "zero3_params")
            assert rec["memory"]["argument_bytes"] < \
                results[f"{arch}|train_4k|{mesh}"]["memory"]["argument_bytes"]


def test_bytes_global_bounds_the_bytes_of_one_rank_on_a_reduced_cell():
    ms = {"data": 2, "model": 2}
    r = dryrun.run_cell("qwen3-32b", "prefill_32k", "2x2", cfg=reduced("qwen3-32b"),
                        mesh_shape=ms, global_batch=8, seq_len=64)
    assert r["bytes_global"] >= r["bytes_accessed_per_device"] > 0
    a = roofline.analyze(r)
    by_axis = r["collectives"]["bytes_by_axis"]
    assert a["collective_s"] == pytest.approx(sum(by_axis.values()) / 450e9)
    assert a["memory_s"] == pytest.approx(r["bytes_global"] / (4 * 3.35e12))


def test_main_prints_both_meshes_and_the_variants(capsys):
    results = _records()
    roofline.main([str(RESULTS)])
    out = capsys.readouterr().out
    for mesh in ("single", "multi"):
        assert f"## Roofline ({mesh} = {roofline.CHIPS[mesh]} H100s" in out
        assert len(roofline.rows(results, mesh)) == sum(
            1 for k, r in results.items() if r["mesh"] == mesh and len(k.split("|")) == 3)
    variants = roofline.variants_table(results)
    assert len(variants) == 2 + 2 * 20  # each zero3_params cell beside its baseline
    assert all(line in out for line in variants)
    assert "## Every cell, single / multi pod" in out
