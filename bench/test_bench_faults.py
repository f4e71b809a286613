"""The comparison fails a run whose timed path is broken underneath: the
rest of a run (no look for a card) with a fault planted under the service,
once for each fault an OLAP cell can have."""
import time

import pytest

from yardstick import compare, harness

SMALL = {"lineorder": 20_000, "customer": 1_500, "supplier": 200, "part": 4_000}


@pytest.mark.parametrize("fault", compare.FAULTS)
@pytest.mark.parametrize("cell,quick", [
    ("ssb-sf1.adhoc", {"warmup_events": 5, "max_events": 3000}),
    ("ssb-sf10.refresh", {"warmup_events": 2}),
])
def test_a_broken_path_is_not_correct(cell, quick, fault):
    out = harness.run_cell(cell, 4242, 1.0, False, "cpu", time.perf_counter(), sizes=SMALL,
                           fault=fault, mix_overrides=quick, log=lambda _: None)
    assert out["correct"] is False
    assert out["compared"]["wrong_groups"]["value"] > 0 or \
        out["compared"]["widest_gap"]["value"] > out["compared"]["widest_gap"]["limit"]
