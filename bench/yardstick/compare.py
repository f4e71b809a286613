"""The comparison that decides ``correct``, and the faults that its test
plants under the service.

The numbers compared, each with a limit from the configuration file
(``limits``; ``PERF.md`` gives the readings each was set from):

* ``answers``: the sampled answers compared, at least 1;
* ``wrong_groups``: sampled answers whose set of groups differs from the
  reference's, or that came without a table (exact: limit 0);
* ``widest_gap``: over the sampled answers, the widest relative gap of a
  group's sum from the reference's (``reference.gap``);
* where the window served NL requests, ``nl_gated_share``: the share of
  them that the gate bypassed with no table (counted served, and faster
  than an answer, so a model that reads worse must not pass by gating
  more), and ``nl_unmapped``: sampled NL answers with a table whose
  executed signature the reference cannot express (an answer left
  unchecked), each against the configuration's ``limits`` of that name;
* where the configuration has an NL canonicalizer, the numbers of its
  module's ``judge`` (``logit_gap`` of ``yardstick/llm.py``).

A run is correct when it compared at least one answer and no number
passes its limit.  The sample covers every class of answer the window
served: each kind of hit, misses through kernel B and misses through
kernel A (the host-mask branch), so a false hit or a wrong miss of any
kind fails it; NL answers are classed apart (``nl.<status>``), and an NL
request that the gate bypassed with no table (``nl.gated``) has no answer
to compare.
"""
from __future__ import annotations

import numpy as np

FAULTS = ("alter_answer", "half_rows")


def answer_class(s) -> str:
    """``status``, and for a miss the kernel its scan took (``miss.A``: the
    host-mask branch; ``miss.B``: kernel B); an NL request's ``nl.<status>``,
    or ``nl.gated`` where it was bypassed with no table."""
    if s.req.nl is not None:
        return "nl.gated" if s.status == "bypass" and s.table is None else f"nl.{s.status}"
    if s.status == "miss":
        return "miss.A" if s.req.intent.host_mask else "miss.B"
    return s.status


def judge(rows: list[tuple[str, bool, float]], limits: dict, model: dict | None = None,
          nl: dict | None = None) -> dict:
    """``correct`` and the numbers compared, from the answers' rows (class,
    groups differ, widest gap), the model's numbers (``{name: {"value",
    "limit"}}``) and the NL requests' (``{"gated_share", "unmapped"}``,
    each against ``limits["nl_<name>"]``); all but ``answers`` are upper
    limits."""
    wrong = sum(1 for _, differ, _ in rows if differ)
    gaps = [g for _, differ, g in rows if not differ]
    widest = float(max(gaps)) if gaps else 0.0
    upper = {}
    if nl is not None:
        missing = sorted({f"nl_{k}" for k in nl} - set(limits))
        if missing:
            raise SystemExit(f"a configuration that is asked NL questions states the "
                             f"limits {missing}")
        upper = {f"nl_{k}": {"value": v, "limit": limits[f"nl_{k}"]} for k, v in nl.items()}
    upper.update(model or {})
    numbers = {
        "answers": {"value": len(rows), "limit": 1},
        "wrong_groups": {"value": wrong, "limit": limits["wrong_groups"]},
        "widest_gap": {"value": widest, "limit": limits["widest_gap"]},
        **upper,
    }
    correct = (len(rows) >= 1 and wrong <= limits["wrong_groups"]
               and bool(np.isfinite(widest)) and widest <= limits["widest_gap"]
               and all(np.isfinite(v["value"]) and v["value"] <= v["limit"]
                       for v in upper.values()))
    return {"correct": bool(correct), "numbers": numbers}


def plant(fault: str, executor):
    """Break the timed path under the service: ``alter_answer`` multiplies
    the first sum of every table the executor produces by 1.001;
    ``half_rows`` hands every aggregation kernel only the first half of
    the fact rows.  Returns the function that undoes it."""
    from repro_torch.olap import executor as ex_mod

    if fault == "alter_answer":
        real = executor._build_result

        def altered(*args, **kwargs):
            t = real(*args, **kwargs)
            m = t.columns.get("m0")
            if m is not None and len(m):
                m = np.array(m, dtype=np.float64)
                m[0] *= 1.001
                t.columns["m0"] = m
            return t

        executor._build_result = altered
        return lambda: delattr(executor, "_build_result")
    if fault == "half_rows":
        names = ("seg_agg_fused", "seg_agg_masked", "seg_agg_batch_blocks")
        saved = {n: getattr(ex_mod, n) for n in names}

        def halve(fn, n_row_args):
            def call(*args, **kwargs):
                n = args[0].shape[0] // 2
                cut = [a[:n] for a in args[:n_row_args]]
                return fn(*cut, *args[n_row_args:], **kwargs)
            return call

        ex_mod.seg_agg_fused = halve(saved["seg_agg_fused"], 3)  # values, ids, preds
        ex_mod.seg_agg_masked = halve(saved["seg_agg_masked"], 3)  # values, ids, mask

        def blocks(sum_block, mm_block, ids, pred_cols, bounds, num_groups):
            n = sum_block.shape[0] // 2
            return saved["seg_agg_batch_blocks"](
                sum_block[:n], None if mm_block is None else mm_block[:n], ids[:n],
                pred_cols[:n], bounds, num_groups)

        ex_mod.seg_agg_batch_blocks = blocks

        def undo():
            for n, f in saved.items():
                setattr(ex_mod, n, f)
        return undo
    raise ValueError(f"unknown fault {fault!r}: {FAULTS}")
