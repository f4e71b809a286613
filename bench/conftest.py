"""Paths for the benchmark's own tests: ``bench/`` (the ``yardstick``
package and the metric readers) and ``src/`` (the port)."""
import sys
from pathlib import Path

_BENCH = Path(__file__).resolve().parent
for p in (str(_BENCH), str(_BENCH.parent / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)
