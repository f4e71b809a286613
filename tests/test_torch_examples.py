"""The port's examples (``repro_torch.examples``) against the JAX package's
scripts (``examples/*.py``) on the CPU.

Each JAX script runs as a subprocess (``JAX_PLATFORMS=cpu``, its own
``XLA_FLAGS``, ``cwd`` a temporary directory, since the train script writes
``ckpts/`` relative to it); all of them start together when the first test
asks, and the port's ``main([..., "--device", "cpu"])`` runs in-process
meanwhile, its stdout captured.

- The four OLAP examples: the two stdouts are equal line for line, wall
  seconds and ``multi_pod_dryrun``'s device banner masked (at 40,000 rows on
  both sides).  ``streaming_append``'s live backend runs on ``--device`` in
  the port, where the JAX script runs it on the numpy oracle impl; the port
  is held to the JAX script with that one backend swapped for the JAX
  package's own device path, and to the script as it is in every line but
  the delta rows scanned (the fused backend shares one delta scan between
  the tiles of a shape).
- ``train_canonicalizer --steps 2`` from JAX's ``PRNGKey(0)`` init, passed to
  the port through ``params_from_jax``: at the example's bf16 the pairs and
  vocab line is equal, the losses agree to rtol 2e-4 and gnorm to rtol 1e-3
  (the frameworks round bf16 at different places: ~1e-4 apart), the
  held-out parsed and exact counts are equal; with both configs in f32 the
  losses (full precision) agree to rtol 1e-5 and every emitted string of
  the held-out answers is equal.
"""
import dataclasses
import json
import os
import re
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import reduced as jreduced
from repro_torch.configs.registry import reduced
from repro_torch.examples import (dashboard_session, multi_pod_dryrun, quickstart,
                                  streaming_append, train_canonicalizer)
from repro_torch.models.convert import params_from_jax
from repro_torch.olap.executor import OlapExecutor
from repro_torch.workloads import ssb

ROOT = Path(__file__).resolve().parents[1]
SCRIPTS = ROOT / "examples"
MULTI_POD_ROWS = 40_000
# the train script's reduced config (examples/train_canonicalizer.py)
TRAIN_CUT = dict(n_layers=4, d_model=256, d_ff=512, vocab=4096, n_heads=8, kv_heads=4,
                 head_dim=32)

# The JAX script with its live backend on the JAX package's device path: the
# first OlapExecutor it makes is the live tenant's, the second the oracle's.
_LIVE_ON_DEVICE = """
import runpy, sys
import repro.olap.executor as ex
real, made = ex.OlapExecutor, []
def executor(ds, impl="auto", **kw):
    made.append(impl)
    return real(ds, impl="auto" if len(made) == 1 else impl, **kw)
ex.OlapExecutor = executor
sys.argv = [{script!r}]
runpy.run_path(sys.argv[0], run_name="__main__")
"""

# The JAX train script with its config in f32; prints train()'s history (full
# precision losses) after the run.
_TRAIN_F32 = """
import dataclasses, json, runpy, sys
import jax.numpy as jnp
import repro.configs.registry as registry
import repro.training.train_lib as train_lib
real_reduced, real_train = registry.reduced, train_lib.train
registry.reduced = lambda name: dataclasses.replace(real_reduced(name), dtype=jnp.float32)
def train(*a, **k):
    out = real_train(*a, **k)
    print("HISTORY " + json.dumps(out["history"]))
    return out
train_lib.train = train
sys.argv = [{script!r}, "--steps", "2"]
runpy.run_path(sys.argv[0], run_name="__main__")
"""

JAX_RUNS = {
    "quickstart": [str(SCRIPTS / "quickstart.py")],
    "dashboard_session": [str(SCRIPTS / "dashboard_session.py")],
    "streaming_append": ["-c", _LIVE_ON_DEVICE.format(
        script=str(SCRIPTS / "streaming_append.py"))],
    "streaming_append_numpy": [str(SCRIPTS / "streaming_append.py")],
    "multi_pod_dryrun": [str(SCRIPTS / "multi_pod_dryrun.py"), str(MULTI_POD_ROWS)],
    "train_bf16": [str(SCRIPTS / "train_canonicalizer.py"), "--steps", "2"],
    "train_f32": ["-c", _TRAIN_F32.format(script=str(SCRIPTS / "train_canonicalizer.py"))],
}


class JaxRuns:
    """Every JAX script of ``JAX_RUNS`` started at once, each in a directory
    of its own, its output in files there; ``stdout(name)`` waits for one."""

    def __init__(self, base: Path):
        env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
        env.update(JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT / "src"))
        self.procs = {}
        for name, args in JAX_RUNS.items():
            cwd = base / name
            cwd.mkdir()
            with open(cwd / "stdout", "w") as out, open(cwd / "stderr", "w") as err:
                proc = subprocess.Popen([sys.executable, *args], cwd=cwd, env=env,
                                        stdout=out, stderr=err)
            self.procs[name] = (proc, cwd)

    def stdout(self, name: str) -> str:
        proc, cwd = self.procs[name]
        rc = proc.wait(timeout=600)
        assert rc == 0, (cwd / "stderr").read_text()[-4000:]
        return (cwd / "stdout").read_text()

    def close(self) -> None:
        for proc, _ in self.procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=60)


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    runs = JaxRuns(tmp_path_factory.mktemp("jax_examples"))
    try:
        yield runs
    finally:
        runs.close()


def _masked(text: str) -> list[str]:
    """The lines with wall seconds masked and the device banner dropped."""
    return [re.sub(r"\bin \d+\.\d+s\b", "in <s>", line)
            for line in text.splitlines() if not line.startswith("== scan plane")]


def _oracle_equal(served: list, n_fact: int) -> None:
    oracle = OlapExecutor(ssb.build(n_fact=n_fact, seed=0).dataset, impl="numpy")
    assert served and all(r.table.equals(oracle.execute(r.signature)) for r in served)


OLAP = {
    "quickstart": (quickstart, []),
    "dashboard_session": (dashboard_session, []),
    "streaming_append": (streaming_append, []),
    "multi_pod_dryrun": (multi_pod_dryrun, [str(MULTI_POD_ROWS)]),
}


@pytest.mark.parametrize("name", sorted(OLAP))
def test_olap_example_prints_the_jax_lines(name, jax_runs, capsys):
    module, argv = OLAP[name]
    served = []
    kw = {"served": served} if name in ("quickstart", "multi_pod_dryrun") else {}
    summary = module.main(argv + ["--device", "cpu"], **kw)
    got = capsys.readouterr().out
    want = jax_runs.stdout(name)
    assert _masked(got) == _masked(want)
    if name == "multi_pod_dryrun":
        assert got.splitlines()[0].startswith("== scan plane across 1 torch device(s) (cpu)")
        assert want.splitlines()[0].startswith("== scan plane")
    # the returned summary holds the printed numbers
    if name == "quickstart":
        assert summary["statuses"] == ["miss", "hit_exact", "hit_exact", "hit_rollup",
                                       "hit_rollup"]
        assert f"backend executions={summary['backend_executions']}" in got
        _oracle_equal(served, 30_000)
    elif name == "dashboard_session":
        assert f"hit rate        : {summary['hit_rate']:.3f}" in got
        assert f"{summary['warm_re_executed']} re-executed" in got
    elif name == "streaming_append":
        assert [t["hits"] for t in summary["ticks"]] == [10, 10, 10]
        assert f"{summary['refreshes']} delta merges" in got
    else:
        assert summary["rows_scanned"] == 2 * MULTI_POD_ROWS
        assert [p["executions"] for p in summary["per_partition"]] == [4] * 8
        _oracle_equal(served, MULTI_POD_ROWS)


def test_streaming_append_departs_only_in_delta_rows_scanned(jax_runs, capsys):
    """Against the JAX script as it is (live backend on the numpy impl, one
    delta scan per tile): every line equal but the ticks' rows scanned,
    which the fused backend shares between the tiles of a shape."""
    streaming_append.main(["--device", "cpu"])
    got = capsys.readouterr().out.splitlines()
    want = jax_runs.stdout("streaming_append_numpy").splitlines()
    assert len(got) == len(want)
    scanned = re.compile(r"([\d,]+) rows scanned$")
    for g, w in zip(got, want):
        if not g.startswith("tick "):
            assert g == w
            continue
        assert scanned.sub("", g) == scanned.sub("", w)
        rows = [int(scanned.search(s).group(1).replace(",", "")) for s in (g, w)]
        assert rows[0] < rows[1] and rows[0] % streaming_append.DELTA == 0


_STEP = re.compile(r"^\[train\] step (\d+) loss ([\d.]+) gnorm ([\d.]+) \(")
_HELD = re.compile(r"^held-out: (\d+)/8 parseable signatures, (\d+)/8 exact")


def _steps(text: str) -> dict:
    return {int(m[1]): (float(m[2]), float(m[3]))
            for m in map(_STEP.match, text.splitlines()) if m}


def _jax_init(dtype):
    jcfg = dataclasses.replace(jreduced("canonicalizer-100m"), dtype=dtype, **TRAIN_CUT)
    return jax.tree.map(np.asarray, jcfg.build().init_params(jcfg, jax.random.PRNGKey(0)))


def _port_train(tmp_path, dtype) -> dict:
    cfg = dataclasses.replace(reduced("canonicalizer-100m"), dtype=dtype, **TRAIN_CUT)
    params = params_from_jax(cfg, _jax_init(jnp.float32 if dtype == torch.float32
                                            else jnp.bfloat16), device="cpu")
    return train_canonicalizer.main(["--steps", "2", "--device", "cpu",
                                     "--ckpt-dir", str(tmp_path / "ckpts")], params=params)


def test_train_canonicalizer_matches_jax_in_bf16(jax_runs, capsys, tmp_path):
    summary = _port_train(tmp_path, torch.bfloat16)
    got = capsys.readouterr().out
    want = jax_runs.stdout("train_bf16")
    assert got.splitlines()[0] == want.splitlines()[0] == "312 training pairs, tokenizer vocab 280"
    ours, theirs = _steps(got), _steps(want)
    assert sorted(ours) == sorted(theirs) == [0, 1]
    for step in ours:
        np.testing.assert_allclose(ours[step][0], theirs[step][0], rtol=2e-4)
        np.testing.assert_allclose(ours[step][1], theirs[step][1], rtol=1e-3)
    held = [next(filter(None, map(_HELD.match, s.splitlines()))).groups() for s in (got, want)]
    assert held[0] == held[1]
    assert (summary["held_out"]["parsed"], summary["held_out"]["exact"]) == tuple(
        map(int, held[0]))


def test_train_canonicalizer_matches_jax_in_f32(jax_runs, capsys, tmp_path, monkeypatch):
    monkeypatch.setattr(train_canonicalizer, "reduced", lambda name: dataclasses.replace(
        reduced(name), dtype=torch.float32))
    summary = _port_train(tmp_path, torch.float32)
    got = capsys.readouterr().out
    want = jax_runs.stdout("train_f32")
    history = next(line for line in want.splitlines() if line.startswith("HISTORY "))
    theirs = [h["loss"] for h in json.loads(history[len("HISTORY "):])]
    np.testing.assert_allclose([h["loss"] for h in summary["history"]], theirs, rtol=1e-5)
    emitted = [[line.strip() for line in s.splitlines() if line.strip().startswith("emitted:")]
               for s in (got, want)]
    assert emitted[0] == emitted[1]
    assert len(emitted[0]) == sum(a["verdict"] == "reject"
                                  for a in summary["held_out"]["answers"])


@pytest.mark.parametrize("name", ["dashboard_session", "multi_pod_dryrun", "quickstart",
                                  "streaming_append", "train_canonicalizer"])
def test_examples_default_to_cuda(name, monkeypatch, tmp_path):
    """With no ``--device`` an example asks for the card, and raises where
    there is none: no fallback to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    module = {"dashboard_session": dashboard_session, "multi_pod_dryrun": multi_pod_dryrun,
              "quickstart": quickstart, "streaming_append": streaming_append,
              "train_canonicalizer": train_canonicalizer}[name]
    argv = ["--ckpt-dir", str(tmp_path / "ckpts")] if name == "train_canonicalizer" else []
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        module.main(argv)


def test_examples_run_as_modules_without_jax():
    """``python -m repro_torch.examples.<name> --help`` in a fresh interpreter
    where ``jax`` and ``repro`` cannot be imported."""
    code = textwrap.dedent(f"""
        import importlib.abc, runpy, sys
        class Block(importlib.abc.MetaPathFinder):
            def find_spec(self, name, path=None, target=None):
                if name.split(".")[0] in ("jax", "jaxlib", "repro", "benchmarks"):
                    raise ImportError("blocked: " + name)
        sys.meta_path.insert(0, Block())
        sys.path.insert(0, {str(ROOT / "src")!r})
        for name in ("quickstart", "dashboard_session", "streaming_append",
                     "multi_pod_dryrun", "train_canonicalizer"):
            sys.argv = [name, "--help"]
            try:
                runpy.run_module("repro_torch.examples." + name, run_name="__main__")
            except SystemExit as e:
                assert e.code == 0, (name, e.code)
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.count("--device") >= 5
