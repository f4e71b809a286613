"""Whole runs of every cell on the CPU at a small size, through the port's
plain PyTorch path: the service's answers against the reference for every
class of answer, the result line's keys, and what the run process loads."""
import json
import subprocess
import sys
import textwrap
import time
from pathlib import Path

import pytest

from yardstick import harness

BENCH = Path(__file__).resolve().parent
SMALL = {"lineorder": 20_000, "customer": 1_500, "supplier": 200, "part": 4_000}
QUICK = {
    "ssb-sf10.refresh": {"warmup_events": 2},
    "ssb-sf1.adhoc": {"warmup_events": 5, "max_events": 3000},
}
# the cells, and the mixes left out of BENCHMARK.json that the harness still runs
CELLS = [c["name"] for c in json.loads((BENCH.parent / "BENCHMARK.json").read_text())["workloads"]]
CELLS += [c for c in QUICK if c not in CELLS]


def rehearse(cell, seed=2**32 + 5, trace=False, fault=None, device="cpu"):
    return harness.run_cell(cell, seed, 1.5, trace, device, time.perf_counter(), sizes=SMALL,
                            fault=fault, mix_overrides=QUICK[cell], log=lambda _: None)


@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_correct_on_the_cpu(cell):
    out = rehearse(cell)
    assert list(out) == ["correct", "attempted", "failed", "metrics", "device", "compared"]
    assert out["correct"] and out["failed"] == 0 and out["attempted"] > 0
    assert set(out["metrics"]) == {m["name"] for m in harness.metric_specs(
        harness.load_cell(cell)[0], trace=False)}
    assert out["compared"]["wrong_groups"]["value"] == 0


def test_traced_run_reads_the_per_layer_metrics():
    """A traced run reads every per-layer metric of its cell but those of
    the kernels and the device, which the CPU has none of."""
    cell = "ssb-sf10.refresh"
    out = rehearse(cell, trace=True)
    assert out["correct"]
    want = {m["name"] for m in harness.metric_specs(harness.load_cell(cell)[0], trace=True)}
    assert set(out["metrics"]) == {n for n in want if not n.startswith(("seg_agg", "device"))}
    assert out["device"]["window_s"] > 0 and "breakdown" in out


def test_window_counters_are_the_kernels_launches_in_the_window(monkeypatch):
    """``Run.counters`` of the refresh cell: only ``launch.<kernel>``, each
    the launches between the window's two ends (set-up's and the
    comparison's left out).  On the CPU no kernel launches, so each
    aggregation the executor calls counts one here."""
    from repro_torch.kernels import binding
    from repro_torch.olap import executor as ex_mod

    for name in ("seg_agg_fused", "seg_agg_masked", "seg_agg_batch_blocks"):
        real = getattr(ex_mod, name)
        monkeypatch.setattr(ex_mod, name, lambda *a, _n=name, _f=real, **k: (
            binding.count_launch(f"bench_test.{_n}"), _f(*a, **k))[1])
    runs, in_window = [], []
    check, loop = harness.check, harness._closed_loop
    monkeypatch.setattr(harness, "check", lambda run, *a: runs.append(run) or check(run, *a))

    def counted_loop(*a, **k):
        before = binding.launch_counts()
        out = loop(*a, **k)
        in_window.append(binding.launch_counts() - before)
        return out

    monkeypatch.setattr(harness, "_closed_loop", counted_loop)
    assert rehearse("ssb-sf10.refresh")["correct"]
    want = {f"launch.{k}": v for k, v in in_window[0].items()}
    assert want and {k: v for k, v in runs[0].counters.items() if v} == want
    assert all(k.startswith("launch.") for k in runs[0].counters)


def test_open_loop_of_callers():
    """The open loop (Poisson arrivals handed to caller threads) that the
    left-out dashboard mix runs, driven here with the ad-hoc mix: every
    request that the seed's schedule holds is attempted and answered."""
    from yardstick import traffic

    over = {"loop": "open", "rate_per_s": 40, "callers": 2, "warmup_events": 5}
    mix = {**harness.load_cell("ssb-sf1.adhoc")[2], **over}
    due = sum(len(e.requests) for e in traffic.Generator(mix, 99, "window").schedule(1.5))
    out = harness.run_cell("ssb-sf1.adhoc", 99, 1.5, False, "cpu", time.perf_counter(),
                           sizes=SMALL, log=lambda _: None, mix_overrides=over)
    assert out["correct"] and out["failed"] == 0 and out["attempted"] == due > 0


def test_every_kind_of_answer_agrees_with_the_reference():
    """Through the service on the CPU: a dashboard's tiles (misses of one
    kernel B shared scan), the same tiles in other forms (exact hits), one
    level up (a roll-up hit), a tile narrowed to a member of its grouping
    (a filter-down hit) and a price floor (a miss through the host-mask
    branch), each equal to the reference."""
    import random

    from yardstick import flights, ssbgen, sqlforms, traffic
    from yardstick.reference import Reference, gap, table_answer

    data = ssbgen.generate(1, 31, sizes=SMALL)
    ref = Reference(data)
    svc, _ = harness.build_service(data, harness.load_cell("ssb-sf1.adhoc")[1], "cpu")
    base = flights.Intent("q2.1", "revenue", ("dates.d_year", "part.p_category"), (
        flights.Pred("supplier.s_region", "=", ("ASIA",)),))
    tiles = flights.tiles(base)
    member = sorted(k[1] for k in ref.answer(tiles[2]))[0]
    steps = [("miss", tiles, 0), ("hit_exact", tiles, 5),
             ("hit_rollup", [flights.roll(tiles[2], random.Random(1))], 3),
             ("hit_filterdown", [tiles[3].with_preds(
                 tiles[3].preds + (flights.Pred("part.p_category", "=", (member,)),))], 9),
             ("miss", [flights.with_price_floor(tiles[4], random.Random(2))], 2)]
    for status, intents, form in steps:
        reqs = [traffic.Request(it, form, sqlforms.render(it, form), "test") for it in intents]
        for it, r in zip(intents, svc.submit_batch(harness._requests(reqs))):
            assert r.status == status, (status, r.provenance)
            want = ref.answer(it)
            differ, widest = gap(table_answer(r.table, it.levels), want)
            assert want and not differ and widest < 1e-6


def test_the_run_loads_neither_jax_nor_the_jax_package():
    """A run's process, and the reference's modules alone, checked in a
    fresh interpreter: no top-level module ``jax``, ``jaxlib``, ``flax`` or
    ``repro`` after a rehearsal, and no ``repro_torch`` under the
    reference."""
    code = textwrap.dedent(f"""
        import sys, time
        sys.path[:0] = [{str(BENCH)!r}, {str(BENCH.parent / "src")!r}]
        from yardstick import flights, reference, sqlforms, ssbgen, traffic
        import random
        data = ssbgen.generate(1, 3, sizes={SMALL!r})
        it = flights.draw(random.Random(1))
        reference.Reference(data).answer(it)
        sqlforms.render(it, 5)
        assert not any(m.split(".")[0] == "repro_torch" for m in sys.modules), "reference"
        from yardstick import harness
        harness.run_cell("ssb-sf10.refresh", 9, 1.0, False, "cpu", time.perf_counter(),
                         sizes={SMALL!r}, mix_overrides={{"warmup_events": 1}},
                         log=lambda _: None)
        assert "repro_torch" in {{m.split(".")[0] for m in sys.modules}}
        print(harness.banned_modules())
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_run_refuses_without_a_card(tmp_path):
    """``bench/run.py`` on a machine without CUDA exits 2 and prints no
    result."""
    pytest.importorskip("torch")
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    out = subprocess.run([sys.executable, str(BENCH / "run.py"), "--workload",
                          "ssb-sf1.adhoc", "--seed", "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=300, cwd=BENCH.parent)
    assert out.returncode == 2 and out.stdout == ""


@pytest.mark.cuda
def test_adhoc_on_the_card(cuda_device):
    out = rehearse("ssb-sf1.adhoc", device="cuda")
    assert out["correct"] and out["device"]["platform"] == "gpu"


@pytest.fixture
def cuda_device():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return "cuda"
