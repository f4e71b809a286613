"""The port's concurrency analysis plane against the JAX package's.

* ``python -m repro_torch.analysis`` over its default paths (the port's
  concurrency-bearing packages, ``kernels`` and ``serving`` among them)
  finds nothing beyond its baseline, which is empty;
* the lock-order graph over ``repro_torch`` is acyclic and has the
  reference's edges, the scan plane's among them;
* the copied passes flag the seeded violations of the reference's fixture
  modules (``tests/fixtures/analysis_cases``) exactly as the reference's
  passes do.
"""
import os
import subprocess
import sys
from collections import Counter as TallyCounter

import pytest

from repro.analysis import annotations as janns
from repro.analysis import immutability as jimmutability
from repro.analysis import lockcheck as jlockcheck
from repro.analysis import lockorder as jlockorder
from repro.analysis.cli import _default_paths as _jdefault_paths
from repro_torch.analysis import annotations as anns
from repro_torch.analysis import immutability, lockcheck, lockorder
from repro_torch.analysis.cli import DEFAULT_PACKAGES, _default_paths, _repo_root
from repro_torch.analysis.cli import main as cli_main
from repro_torch.analysis.findings import load_baseline

ROOT = os.path.join(os.path.dirname(__file__), "..")
FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures", "analysis_cases")
# lock classes of the partition-parallel scan plane
SCAN_PLANE = ("OlapExecutor._scan_mutex", "OlapExecutor._subs_lock")


def _tally(findings):
    return TallyCounter((f.rule, f.file, f.identifier, f.line) for f in findings)


@pytest.fixture(scope="module")
def indexes():
    return (anns.build_index([FIXTURES], repo_root=FIXTURES),
            janns.build_index([FIXTURES], repo_root=FIXTURES))


@pytest.fixture(scope="module")
def live():
    root = _repo_root()
    return root, anns.build_index(_default_paths(root), repo_root=root)


def test_cli_module_is_clean_over_the_default_paths():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run([sys.executable, "-m", "repro_torch.analysis", "--strict",
                          "--json", "-"], cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "clean: no findings beyond baseline" in out.stdout
    assert out.stdout.startswith("repro_torch.analysis: ")


def test_default_paths_are_the_ports_packages():
    root = _repo_root()
    assert os.path.samefile(root, ROOT)
    paths = _default_paths(root)
    assert [os.path.basename(p) for p in paths] == list(DEFAULT_PACKAGES)
    assert {"kernels", "serving", "cluster", "service", "storage"} <= set(DEFAULT_PACKAGES)
    assert all(os.sep + os.path.join("src", "repro_torch") + os.sep in p for p in paths)


def test_cli_strict_in_process(capsys):
    assert cli_main(["--strict", "--json", "-"]) == 0
    assert "clean: no findings beyond baseline" in capsys.readouterr().out


def test_baseline_is_empty_by_policy():
    path = os.path.join(_repo_root(), "src", "repro_torch", "analysis", "baseline.json")
    assert load_baseline(path) == set()


def test_live_lock_graph_is_acyclic_and_the_references(live):
    root, index = live
    findings, _, edges = lockorder.run(index)
    assert findings == []
    jindex = janns.build_index(_jdefault_paths(root), repo_root=root)
    jfindings, _, jedges = jlockorder.run(jindex)
    assert jfindings == []
    assert set(edges) == set(jedges)
    assert {e[0] for e in edges} >= set(SCAN_PLANE)
    assert {("CacheCluster._topology_lock", "CacheShard.lock"),
            ("ReadWriteGate.write", "CacheShard.lock")} <= set(edges)


def test_live_tree_has_no_lock_or_immutability_findings(live):
    _, index = live
    assert lockcheck.run(index)[0] == []
    assert immutability.run(index)[0] == []


def test_guarded_annotations_cover_concurrent_classes(live):
    _, index = live
    guarded = {c.name: set(c.guarded) for m in index.modules
               for c in m.classes.values() if c.guarded}
    assert "_inflight" in guarded["CacheShard"]
    assert {"table", "error"} <= guarded["Flight"]
    assert "_templates" in guarded["SQLCanonicalizer"]
    assert "_memo" in guarded["MemoizedNL"]
    assert "_tenants" in guarded["CacheService"]
    assert "snapshot_id" in guarded["Tenant"]
    assert {"executions", "rows_scanned"} <= guarded["OlapExecutor"]
    assert "upload_ms" in guarded["DeviceDataset"]


def test_lock_discipline_findings_match_the_reference(indexes):
    index, jindex = indexes
    findings, waived = lockcheck.run(index)
    jfindings, jwaived = jlockcheck.run(jindex)
    assert _tally(findings) == _tally(jfindings)
    assert _tally(waived) == _tally(jwaived)
    got = TallyCounter((f.rule, f.identifier) for f in findings
                       if f.file == "bad_guarded.py")
    assert got == TallyCounter({
        ("guarded-by", "Counter.hits"): 3,
        ("guarded-by", "Counter.items"): 2,
        ("unannotated-shared-write", "Counter.notes"): 1,
    })
    assert [w.identifier for w in waived if w.file == "bad_guarded.py"] == ["Counter.hits"]
    lines = open(os.path.join(FIXTURES, "bad_guarded.py")).read().splitlines()
    for f in findings:
        if f.file == "bad_guarded.py":
            assert "FINDING" in lines[f.line - 1]


def test_lock_order_cycles_match_the_reference(indexes):
    index, jindex = indexes
    findings, _, edges = lockorder.run(index)
    jfindings, _, jedges = jlockorder.run(jindex)
    assert _tally(findings) == _tally(jfindings) and edges == jedges
    assert sorted(f.identifier for f in findings) == [
        "cycle:Inverted._a -> Inverted._b -> Inverted._a",
        "cycle:ViaCall._inner -> ViaCall._outer -> ViaCall._inner",
    ]
    assert "via ViaCall.nested" in edges[("ViaCall._inner", "ViaCall._outer")]


def test_immutability_findings_match_the_reference(indexes):
    index, jindex = indexes
    findings, waived = immutability.run(index)
    jfindings, jwaived = jimmutability.run(jindex)
    assert _tally(findings) == _tally(jfindings) and _tally(waived) == _tally(jwaived)
    assert sorted((f.rule, f.identifier) for f in findings) == [
        ("immutability", "Point.x"), ("immutability", "Point.y")]
    assert [w.identifier for w in waived] == ["Point.y"]
