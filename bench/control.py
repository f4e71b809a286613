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
the limits.

A configuration with a ``canonicalizer`` entry has a model control too:
the NL questions of the window's first ``MODEL_EVENTS`` events, each
event's one engine batch as ``submit_batch`` hands them to the
canonicalizer, go through the module's ``control``, which judges the
program and its control (for ``yardstick/llm.py``, its weights rounded
through FP8) on the same batches; both lines are printed, each number
beside its limit, and the control's has to be not correct.  The
benchmark's runs do not run it.
"""
from __future__ import annotations

import argparse
import json
import math
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parent
sys.path[:0] = [str(BENCH), str(BENCH.parent / "src")]
MODEL_EVENTS = 4  # the window's first events whose questions the model control takes


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


def model_batches(mix: dict, seed: int) -> list[list[str]]:
    """The engine batches of the window's first ``MODEL_EVENTS`` events:
    each event's questions in order, one of each text, and none that an
    earlier event asked (``MemoizedNL`` answers those without the model)."""
    from yardstick import traffic

    seen, out = set(), []
    for ev in traffic.Generator(mix, seed, "window").schedule(30.0)[:MODEL_EVENTS]:
        texts = [t for t in dict.fromkeys(r.nl for r in ev.requests if r.nl is not None)
                 if t not in seen]
        seen.update(texts)
        if texts:
            out.append(texts)
    return out


def model_numbers(name: str, seed: int, device: str,
                  sizes: dict | None = None) -> tuple[dict, dict] | None:
    """(the program's numbers, its control's) from the canonicalizer
    module's ``control``, or None where the cell's configuration has no
    canonicalizer or its window asks no question."""
    from yardstick import harness, modules

    _, config, mix = harness.load_cell(name)
    if "canonicalizer" not in config:
        return None
    batches = model_batches(mix, seed)
    if not batches:
        return None
    data = modules.load(config["generator"]).generate(int(config["scale_factor"]), seed,
                                                      sizes=sizes)
    canon = modules.load(config["canonicalizer"]["module"])
    return canon.control(config, data, seed, device, batches)


def _correct(numbers: dict) -> bool:
    return all(math.isfinite(v["value"]) and v["value"] <= v["limit"] for v in numbers.values())


def main(argv=None, sizes: dict | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--answers", type=int, default=100)
    args = ap.parse_args(argv)
    import torch

    device = "cuda" if torch.cuda.is_available() else "cpu"
    for seed in args.seeds:
        head = {"workload": args.workload, "seed": seed, "device": device}
        out = control_numbers(args.workload, seed, args.answers, device, sizes=sizes)
        print(json.dumps({**head, "program": "reference_bf16", "correct": out["correct"],
                          "numbers": out["numbers"]}), flush=True)
        model = model_numbers(args.workload, seed, device, sizes=sizes)
        if model is None:
            continue
        for program, numbers in zip(("model", "model_weights_fp8"), model):
            print(json.dumps({**head, "program": program, "correct": _correct(numbers),
                              "numbers": numbers}), flush=True)
        for k, v in model[0].items():
            print(f"[control] seed {seed} {k}: model {v['value']!r}, weights_fp8 "
                  f"{model[1][k]['value']!r}, limit {v['limit']!r}", file=sys.stderr, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
