"""The control of the comparison that decides ``correct``: the plain
reference in bfloat16 (the precision below the float32 the configurations
state) put in the program's place, on a cell's own data and intents,
judged by the same comparison.  It has to come out not correct.

    python3 bench/control.py --workload <cell> --seeds 1 2 3 [--answers 100]

For each seed it draws the cell's data (the configuration's ``generator``
module) and its window's events, takes the first ``--answers`` distinct
intents, answers each with the configuration's ``reference`` module in
float64 and in bfloat16 (``answer(intent, control=True, device=...)``, on
the card where there is one), and prints the comparison's numbers beside
the limits.  The benchmark's runs do not run it.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parent
sys.path[:0] = [str(BENCH), str(BENCH.parent / "src")]


def control_numbers(name: str, seed: int, answers: int, device: str,
                    sizes: dict | None = None, seconds: float = 30.0) -> dict:
    from yardstick import compare, harness, modules, traffic
    from yardstick.reference import gap

    _, config, mix = harness.load_cell(name)
    data = modules.load(config["generator"]).generate(int(config["scale_factor"]), seed,
                                                      sizes=sizes)
    ref = modules.load(config["reference"]).Reference(data)
    intents = []
    for ev in traffic.Generator(mix, seed, "window").schedule(seconds):
        for r in ev.requests:
            if r.intent not in intents:
                intents.append(r.intent)
        if len(intents) >= answers:
            break
    rows = []
    for it in intents[:answers]:
        differ, widest = gap(ref.answer(it, control=True, device=device), ref.answer(it))
        rows.append(("control", differ, widest))
    return compare.judge(rows, config["limits"])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--answers", type=int, default=100)
    args = ap.parse_args(argv)
    import torch

    device = "cuda" if torch.cuda.is_available() else "cpu"
    for seed in args.seeds:
        out = control_numbers(args.workload, seed, args.answers, device)
        print(json.dumps({"workload": args.workload, "seed": seed, "device": device,
                          "correct": out["correct"], "numbers": out["numbers"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
