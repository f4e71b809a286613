"""The port stands alone: ``repro_torch`` and ``chip_smoke.py`` import
neither JAX nor the JAX package, and the executor refuses to run on a CUDA
device that is not there."""
import ast
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch

from repro_torch.olap.columnar import from_reference
from repro_torch.olap.executor import OlapExecutor

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"


def _forbidden(name: str) -> bool:
    return any(name == top or name.startswith(top + ".") for top in ("jax", "repro"))


def _imports(path: Path) -> list[str]:
    names = []
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.append(node.module)
    return names


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    bad = [n for n in _imports(path) if _forbidden(n)]
    assert not bad, f"{path}: {bad}"


def test_every_submodule_imports_without_jax():
    """In a fresh interpreter where ``jax`` and ``repro`` cannot be
    imported, every module of the port imports (the ``__main__`` modules
    run their command when imported; ``python -m`` runs them elsewhere),
    the service shell's subpackages among them."""
    code = textwrap.dedent(f"""
        import importlib, importlib.abc, pkgutil, sys
        class Block(importlib.abc.MetaPathFinder):
            def find_spec(self, name, path=None, target=None):
                if name.split(".")[0] in ("jax", "jaxlib", "repro"):
                    raise ImportError("blocked: " + name)
        sys.meta_path.insert(0, Block())
        sys.path.insert(0, {str(ROOT / "src")!r})
        import repro_torch
        names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")
                 if not m.name.endswith(".__main__")]
        for n in names:
            importlib.import_module(n)
        assert not any(m.split(".")[0] in ("jax", "repro") for m in sys.modules)
        print(" ".join(names))
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    names = set(out.stdout.split())
    assert len(names) >= 60
    for sub in ("analysis", "resilience", "obs", "cluster", "service", "storage"):
        assert f"repro_torch.{sub}" in names, sub
    assert {f"repro_torch.analysis.{m}" for m in (
        "annotations", "findings", "lockcheck", "lockorder", "immutability", "cli")} <= names
    assert {f"repro_torch.core.{m}" for m in ("metrics", "middleware", "refresh")} <= names
    assert {f"repro_torch.service.{m}" for m in ("api", "service", "pipeline")} <= names
    assert {f"repro_torch.storage.{m}" for m in ("manifest", "coldstore", "engine")} <= names
    assert {f"repro_torch.cluster.{m}" for m in ("cluster", "shard", "flight")} <= names
    assert {f"repro_torch.obs.{m}" for m in ("metrics", "trace", "audit")} <= names
    assert {f"repro_torch.resilience.{m}" for m in (
        "errors", "primitives", "policy", "faults")} <= names
    assert {f"repro_torch.training.{m}" for m in (
        "tokenizer", "data", "optimizer", "checkpoint", "train_lib")} <= names
    assert {"repro_torch.launch.train", "repro_torch.launch.serve"} <= names
    assert {"repro_torch.distributed.sharding", "repro_torch.distributed.elastic",
            "repro_torch.distributed.local", "repro_torch.launch.mesh",
            "repro_torch.launch.dryrun", "repro_torch.configs.shapes"} <= names


def test_default_device_raises_without_cuda(ssb_small, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ds = from_reference(ssb_small.dataset)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        OlapExecutor(ds)
    # the numpy oracle touches no device, the CPU path is asked for by name
    OlapExecutor(ds, impl="numpy")
    OlapExecutor(ds, device="cpu")


def test_chip_smoke_refuses_without_cuda(tmp_path, monkeypatch):
    """Where CUDA is absent the smoke run exits non-zero and prints no
    result line; so does a copy of the script alone, away from the port."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(ROOT))
    assert chip_smoke.main([]) != 0
    alone = tmp_path / "chip_smoke.py"
    alone.write_text((ROOT / "chip_smoke.py").read_text())
    out = subprocess.run([sys.executable, str(alone)], capture_output=True,
                         text=True, timeout=120, cwd=tmp_path)
    assert out.returncode != 0 and '"ok"' not in out.stdout
