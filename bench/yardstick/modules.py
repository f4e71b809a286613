"""Modules that a file of the benchmark names by its path under ``bench/``:
a configuration's ``generator``, ``reference``, ``canonicalizer.module``
and ``model_reference``, and the per-layer metrics' readers.

A module in a package directory of ``bench/`` (one with an
``__init__.py``, as ``yardstick/``) is imported under its package, so
that its relative imports work and a second load finds the first; any
other file is executed as a module of its own each time it is loaded.
"""
from __future__ import annotations

import importlib
import importlib.util
import re
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parents[1]


def path_of(rel: str) -> Path:
    """``bench/<rel>``, refused where it is no Python file under
    ``bench/``."""
    path = (BENCH_DIR / rel).resolve()
    if path.suffix != ".py" or BENCH_DIR not in path.parents or not path.is_file():
        raise SystemExit(f"no module of the benchmark at bench/{rel}")
    return path


def load(rel: str):
    """The module at ``bench/<rel>`` (e.g. ``yardstick/ssbgen.py``)."""
    path = path_of(rel)
    pkg = path.parent
    if pkg.parent == BENCH_DIR and (pkg / "__init__.py").exists():
        mod = importlib.import_module(f"{pkg.name}.{path.stem}")
        if Path(mod.__file__).resolve() != path:
            raise SystemExit(f"bench/{rel}: {pkg.name}.{path.stem} is imported from "
                             f"{mod.__file__}")
        return mod
    spec = importlib.util.spec_from_file_location("bench_" + re.sub(r"\W", "_", rel), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
