"""End-to-end driver: train the ~100M canonicalizer LM on NL->signature pairs
for a few hundred steps with checkpointing, then serve it with grammar-
constrained JSON decoding and measure held-out canonicalization accuracy.

On the card (``--device cuda``, the default) the train step runs the
attention through the ``flash_attn`` kernel and its backward
(``flash_attn_bwd``), and the held-out evaluation prefills through
``flash_attn`` and decodes through ``decode_attn``.  Reduced defaults (4
layers, d_model 256, 8/4 heads of 32, batch 8 x 128, 120 steps) take
seconds there; pass --full for the real 100M config / 300 steps (the
production path).  A run resumes from the newest checkpoint in
``--ckpt-dir``.

The weights start from ``torch.Generator().manual_seed(0)``: seeds do not
carry across frameworks, so the losses are not the JAX script's numbers
(a caller may hand in other weights, e.g. JAX's init converted by
``models.convert.params_from_jax``).

    PYTHONPATH=src python -m repro_torch.examples.train_canonicalizer [--full] [--device cpu]
"""
from __future__ import annotations

import argparse
import dataclasses

import torch

from ..configs.registry import get, reduced
from ..core.sql_canon import SQLCanonicalizer
from ..serving.engine import CanonicalizerService, ServingEngine
from ..training.data import BatchIterator, build_pairs
from ..training.tokenizer import build_tokenizer
from ..training.train_lib import TrainConfig, train
from ..workloads import ssb
from ..workloads.paraphrase import gen_paraphrases

HELD_OUT = 8  # intents whose unseen paraphrase is asked after training


def held_out(wl, engine) -> dict:
    """The held-out evaluation through the serving engine: the last of 40
    paraphrases (seed 777 + i, an unseen template mix) of each of the first
    ``HELD_OUT`` intents, one at a time through a ``CanonicalizerService``
    (JSON-constrained decoding), each printed with its confidence and
    verdict.  Returns the parsed and exact counts and each answer (text,
    gold key, verdict, confidence, emitted JSON).  Raises on an answer that
    breaks the NLResult protocol (signature None iff error set)."""
    svc = CanonicalizerService(engine, wl.schema.name)
    canon = SQLCanonicalizer(wl.schema)
    asked = [(gen_paraphrases(intent, n=40, seed=777 + i)[-1],
              canon.canonicalize(intent.sql).key())
             for i, intent in enumerate(wl.intents[:HELD_OUT])]
    correct = parsed = 0
    answers = []
    for text, gold in asked:
        r = svc.canonicalize(text)
        if (r.signature is None) != (r.error is not None):
            raise AssertionError(f"NLResult breaks the protocol: {r}")
        exact = r.signature is not None and r.signature.key() == gold
        parsed += r.signature is not None
        correct += exact
        verdict = "EXACT" if exact else ("valid-json" if r.signature else "reject")
        print(f"  conf={r.confidence:.2f} {verdict:10s} | {text[:56]}")
        if verdict == "reject":
            print(f"      emitted: {r.raw_json[:90]!r}")
        answers.append({"text": text, "gold": gold, "verdict": verdict,
                        "confidence": r.confidence, "raw_json": r.raw_json})
    print(f"\nheld-out: {parsed}/{len(asked)} parseable signatures, "
          f"{correct}/{len(asked)} exact intent matches "
          f"(training longer / --full improves this; the safety layer gates the rest)")
    return {"questions": len(asked), "parsed": parsed, "exact": correct, "answers": answers}


def main(argv=None, params: dict | None = None) -> dict:
    """Train, then evaluate; ``params`` (on ``--device``), where given,
    replace the seeded init."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--ckpt-dir", default="ckpts/canonicalizer")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    wl = ssb.build(n_fact=2000)
    tok = build_tokenizer([wl])
    pairs = build_pairs([wl], paraphrases_per_intent=24)
    print(f"{len(pairs)} training pairs, tokenizer vocab {tok.vocab_size}")

    if args.full:
        cfg = get("canonicalizer-100m")
        steps = args.steps or 300
        batch, seq = 16, 192
    else:
        cfg = dataclasses.replace(reduced("canonicalizer-100m"),
                                  n_layers=4, d_model=256, d_ff=512, vocab=4096,
                                  n_heads=8, kv_heads=4, head_dim=32)
        steps = args.steps or 120
        batch, seq = 8, 128

    batches = BatchIterator(pairs, tok, batch=batch, seq_len=seq)
    out = train(cfg, TrainConfig(steps=steps, ckpt_dir=args.ckpt_dir,
                                 ckpt_every=50, log_every=20),
                batches, params=params, generator=torch.Generator().manual_seed(0),
                device=args.device)

    # ---- held-out evaluation through the real serving engine
    engine = ServingEngine(cfg, out["params"], tok, max_len=256, device=args.device)
    return {"pairs": len(pairs), "vocab": tok.vocab_size, "steps": steps,
            "start_step": out["start_step"], "history": out["history"],
            "held_out": held_out(wl, engine)}


if __name__ == "__main__":
    main()
