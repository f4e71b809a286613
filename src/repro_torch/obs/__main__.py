"""``python -m repro_torch.obs`` — query traces and the cache audit log offline.

Three subcommands over the JSONL sinks the plane writes:

* ``summarize <trace.jsonl>`` — per-trace span trees (wall times, durations,
  attributes), optionally filtered to one trace id;
* ``explain <audit.jsonl> --key <sig>`` — the lifecycle narrative of one
  cache entry: every event it went through, with the policy inputs
  (decayed hits, cost, bytes, benefit score) that drove each decision, and
  a one-line verdict on why it ultimately left the cache (if it did);
* ``false-hits <audit.jsonl>`` — liveness audit: replay the log and report
  any ``hit``/``derivation_hit`` served from a key that was not live in a
  servable tier at serve time (morgue/stale serves are degraded-mode by
  design and excluded).
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import Iterable, Optional


def _read_jsonl(path: str) -> list[dict]:
    out = []
    with open(path, "r", encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if line:
                out.append(json.loads(line))
    return out


# ---------------------------------------------------------------- summarize


def _span_tree_lines(spans: list[dict]) -> list[str]:
    by_id = {s["span"]: s for s in spans}
    children: dict = {}
    roots = []
    for s in spans:
        p = s.get("parent")
        if p and p in by_id:
            children.setdefault(p, []).append(s)
        else:
            roots.append(s)
    for kids in children.values():
        kids.sort(key=lambda s: s.get("start_s", 0.0))
    roots.sort(key=lambda s: s.get("start_s", 0.0))
    lines: list[str] = []

    def walk(s: dict, depth: int) -> None:
        attrs = s.get("attrs") or {}
        extra = ""
        if attrs:
            kv = ", ".join(f"{k}={attrs[k]}" for k in sorted(attrs))
            extra = f"  [{kv}]"
        lines.append(f"{'  ' * depth}{s['name']}  "
                     f"{s.get('dur_ms', 0.0):.3f}ms{extra}")
        for kid in children.get(s["span"], []):
            walk(kid, depth + 1)

    for r in roots:
        walk(r, 0)
    return lines


def cmd_summarize(args) -> int:
    spans = _read_jsonl(args.path)
    by_trace: dict[str, list[dict]] = {}
    for s in spans:
        by_trace.setdefault(s["trace"], []).append(s)
    ids = [args.trace] if args.trace else list(by_trace)
    if args.trace and args.trace not in by_trace:
        print(f"trace {args.trace} not found "
              f"({len(by_trace)} traces in {args.path})", file=sys.stderr)
        return 1
    for tid in ids:
        tspans = by_trace[tid]
        total = sum(s.get("dur_ms", 0.0) for s in tspans
                    if not s.get("parent"))
        print(f"trace {tid}: {len(tspans)} spans, "
              f"root {total:.3f}ms")
        for line in _span_tree_lines(tspans):
            print(f"  {line}")
    print(f"{len(ids)} trace(s), {len(spans)} span(s) total")
    return 0


# ------------------------------------------------------------------ explain

# events after which the key can still serve from a live tier
_KEEPS_LIVE = {"put", "hit", "derivation_hit", "refresh", "promote",
               "demote", "stale_serve"}
# events after which it cannot (evict is live-leaving only when its
# disposition says dropped; demotions stay servable from the cold tier)
_ENDS_LIVE = {"drop", "ttl_expiry"}


def _leaves_cache(e: dict) -> bool:
    if e["event"] in _ENDS_LIVE:
        return True
    if e["event"] == "evict":
        return e.get("disposition", "drop") == "drop"
    return False


def _policy_bits(e: dict) -> str:
    keys = ("tier", "hits", "decayed_hits", "cost_ms", "nbytes", "score",
            "age_s", "idle_s", "ttl_s", "reason", "disposition", "policy",
            "origin", "snapshot", "src_key", "derivation")
    kv = [f"{k}={e[k]}" for k in keys if k in e and e[k] is not None]
    return ", ".join(kv)


def cmd_explain(args) -> int:
    events = [e for e in _read_jsonl(args.path) if e["key"] == args.key]
    if not events:
        print(f"no audit events for key {args.key!r} in {args.path}",
              file=sys.stderr)
        return 1
    t0 = events[0]["ts"]
    for e in events:
        bits = _policy_bits(e)
        print(f"+{e['ts'] - t0:9.3f}s  {e['event']:<15}"
              f"{('  ' + bits) if bits else ''}")
    live = False
    last_exit = None
    for e in events:  # replay in order: the log is append-ordered
        if _leaves_cache(e):
            live = False
            last_exit = e
        elif e["event"] in ("put", "refresh", "promote", "demote"):
            live = True
    if last_exit is None:
        print(f"verdict: {args.key} never left the cache "
              f"({len(events)} events)")
    else:
        why = last_exit.get("reason") or last_exit["event"]
        bits = _policy_bits(last_exit)
        print(f"verdict: left the cache via {last_exit['event']} ({why})"
              + (f" — {bits}" if bits else ""))
        if live:
            print("         (re-admitted afterwards; currently live)")
    return 0


# --------------------------------------------------------------- false-hits


def cmd_false_hits(args) -> int:
    events = _read_jsonl(args.path)
    live: set = set()
    false_hits: list[dict] = []
    hits = 0
    for e in events:
        kind, key = e["event"], e["key"]
        if kind in ("hit", "derivation_hit"):
            hits += 1
            src = e.get("src_key", key) if kind == "derivation_hit" else key
            if src not in live:
                false_hits.append(e)
        elif kind in ("put", "refresh", "promote", "demote"):
            live.add(key)
        elif _leaves_cache(e):
            live.discard(key)
    for e in false_hits:
        print(f"FALSE HIT  ts={e['ts']:.3f}  {e['event']}  key={e['key']}"
              f"  {_policy_bits(e)}")
    print(f"{hits} hit(s) audited, {len(false_hits)} false, "
          f"{len(live)} key(s) live at end of log")
    return 0 if not false_hits else 2


# --------------------------------------------------------------------- main


def main(argv: Optional[Iterable[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs",
        description="Query observability sinks: trace summaries, "
                    "eviction explanations, false-hit audit.")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("summarize", help="print span trees from a trace "
                                         "JSONL sink")
    p.add_argument("path", help="trace JSONL file")
    p.add_argument("--trace", default=None, help="only this trace id")
    p.set_defaults(fn=cmd_summarize)

    p = sub.add_parser("explain", help="narrate one key's cache lifecycle "
                                       "from an audit JSONL sink")
    p.add_argument("path", help="audit JSONL file")
    p.add_argument("--key", required=True, help="signature key to explain")
    p.set_defaults(fn=cmd_explain)

    p = sub.add_parser("false-hits", help="audit that every hit was served "
                                          "from a live key")
    p.add_argument("path", help="audit JSONL file")
    p.set_defaults(fn=cmd_false_hits)

    args = ap.parse_args(list(argv) if argv is not None else None)
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
