"""``python -m repro_torch.analysis`` — run the static concurrency passes.

Usage::

    python -m repro_torch.analysis [paths...] [--strict] [--json REPORT]
                                   [--baseline FILE | --no-baseline]
                                   [--print-lock-graph]

Default paths are the concurrency-bearing packages
(``src/repro_torch/{cluster,service,olap,core,storage,resilience,obs,
kernels,serving,training}``; training for its async checkpoint writers).  Findings matching the
checked-in baseline (``src/repro_torch/analysis/baseline.json``, keyed by
``(rule, file, identifier)`` — line-number independent) are reported but
do not fail the run; ``--strict`` exits non-zero on any *new* finding.
The JSON report (default ``ANALYSIS_report.json``) always carries the
full finding set plus the waived list, so CI artifacts show everything.
"""
from __future__ import annotations

import argparse
import os
import sys

from . import annotations as A
from . import immutability, lockcheck, lockorder
from .findings import load_baseline, split_baseline, write_report

DEFAULT_PACKAGES = ("cluster", "service", "olap", "core", "storage",
                    "resilience", "obs", "kernels", "serving", "training")


def _repo_root() -> str:
    # src/repro_torch/analysis/cli.py -> repo root is four levels up
    here = os.path.dirname(os.path.abspath(__file__))
    return os.path.dirname(os.path.dirname(os.path.dirname(here)))


def _default_paths(root: str) -> list:
    base = os.path.join(root, "src", "repro_torch")
    return [os.path.join(base, pkg) for pkg in DEFAULT_PACKAGES
            if os.path.isdir(os.path.join(base, pkg))]


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="concurrency invariant analysis: guarded-by lint, "
                    "lock-order graph, interning-immutability")
    parser.add_argument("paths", nargs="*", help="files or directories "
                        "(default: src/repro_torch/{%s})" % ",".join(
                            DEFAULT_PACKAGES))
    parser.add_argument("--strict", action="store_true",
                        help="exit 1 on findings not in the baseline")
    parser.add_argument("--json", default="ANALYSIS_report.json",
                        metavar="FILE", help="JSON report path "
                        "(default: %(default)s; '-' disables)")
    parser.add_argument("--baseline", default=None, metavar="FILE",
                        help="baseline file (default: the checked-in one)")
    parser.add_argument("--no-baseline", action="store_true",
                        help="treat every finding as new")
    parser.add_argument("--print-lock-graph", action="store_true",
                        help="dump the extracted acquisition digraph")
    args = parser.parse_args(argv)

    root = _repo_root()
    paths = [os.path.abspath(p) for p in args.paths] or _default_paths(root)
    index = A.build_index(paths, root)

    lc_findings, lc_waived = lockcheck.run(index)
    lo_findings, lo_waived, edges = lockorder.run(index)
    im_findings, im_waived = immutability.run(index)
    findings = sorted(lc_findings + lo_findings + im_findings,
                      key=lambda f: (f.file, f.line, f.rule, f.identifier))
    waived = sorted(lc_waived + lo_waived + im_waived,
                    key=lambda f: (f.file, f.line, f.rule, f.identifier))

    if args.no_baseline:
        baseline = set()
    else:
        bl_path = args.baseline or os.path.join(
            os.path.dirname(os.path.abspath(__file__)), "baseline.json")
        baseline = load_baseline(bl_path)
    new, baselined = split_baseline(findings, baseline)

    if args.print_lock_graph:
        print("lock-order acquisition digraph "
              f"({len(edges)} edge{'s' * (len(edges) != 1)}):")
        for (a, b), witness in sorted(edges.items()):
            print(f"  {a} -> {b}    [{witness}]")
        print()

    n_files = len(index.modules)
    n_guarded = sum(len(c.guarded) for m in index.modules
                    for c in m.classes.values())
    n_locks = sum(len(c.locks) for m in index.modules
                  for c in m.classes.values())
    print(f"repro_torch.analysis: {n_files} files, {n_guarded} guarded attrs, "
          f"{n_locks} locks, {len(edges)} order edges")

    for f in new:
        print(f"NEW  {f.render()}")
    for f in baselined:
        print(f"BASE {f.render()}")
    for f in waived:
        print(f"WAIV {f.render()}")

    if args.json != "-":
        write_report(args.json, paths=[os.path.relpath(p, root)
                                       for p in paths],
                     findings=findings, new=new, baselined=baselined,
                     waived=waived)
        print(f"report: {args.json}")

    if new:
        print(f"{len(new)} new finding{'s' * (len(new) != 1)}"
              f"{' (strict: failing)' if args.strict else ''}")
        return 1 if args.strict else 0
    print("clean: no findings beyond baseline")
    return 0


if __name__ == "__main__":
    sys.exit(main())
