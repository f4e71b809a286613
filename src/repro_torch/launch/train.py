"""Training launcher: train the canonicalizer model on NL->signature pairs
(the JAX package's ``repro/launch/train.py``), on the GPU unless
``--device cpu``.

Builds SSB, NYC TLC and TPC-DS (1,000 fact rows each: the pairs and the
tokenizer depend on the schemas, not the rows), their NL->signature pairs
and a tokenizer over all three, then runs ``train_lib.train`` with
checkpoints in ``--ckpt-dir`` (the JAX package's format; a restart resumes
from the newest).  Each checkpoint's ``extra`` records the arch, whether
it is the reduced config, and the workloads the tokenizer was built over,
so ``launch.serve --ckpt-dir`` rebuilds the same token ids.

``--dryrun-mesh {single,multi}`` traces the distributed train step of
``--arch`` at ``train_4k`` on the production mesh instead
(``launch.dryrun.run_cell``, a fake process group on the CPU) and prints
its record.

Departure from the reference: ``--reduced`` widens the reduced config's
head to the tokenizer's vocabulary, as ``launch.serve`` does (the
reference stops with ``SystemExit``).

Usage:
    python -m repro_torch.launch.train --arch canonicalizer-100m --steps 300 \\
        --batch 16 --ckpt-dir ckpts/canon
    python -m repro_torch.launch.train --reduced --steps 2 --device cpu --ckpt-dir /tmp/ck
    python -m repro_torch.launch.train --arch qwen3-32b --dryrun-mesh single
"""
from __future__ import annotations

import argparse
import dataclasses

TOKENIZER_WORKLOADS = ("ssb", "nyc_tlc", "tpcds")


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="canonicalizer-100m")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=192)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--grad-compression", action="store_true")
    ap.add_argument("--reduced", action="store_true",
                    help="use the reduced smoke config of the arch")
    ap.add_argument("--dryrun-mesh", choices=["single", "multi"], default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    if args.dryrun_mesh:
        from .dryrun import run_cell

        res = run_cell(args.arch, "train_4k", args.dryrun_mesh)
        print(res)
        return res

    from ..configs.registry import get, reduced
    from ..training.data import BatchIterator, build_pairs
    from ..training.tokenizer import build_tokenizer
    from ..training.train_lib import TrainConfig, train
    from .serve import WORKLOADS

    cfg = reduced(args.arch) if args.reduced else get(args.arch)
    wls = [WORKLOADS[name].build(n_fact=1000) for name in TOKENIZER_WORKLOADS]
    tok = build_tokenizer(wls)
    if cfg.vocab < tok.vocab_size:
        if not args.reduced:
            raise SystemExit(f"arch vocab {cfg.vocab} < tokenizer {tok.vocab_size}")
        cfg = dataclasses.replace(cfg, vocab=tok.vocab_size)
    pairs = build_pairs(wls)
    print(f"[train] {len(pairs)} NL->signature pairs, vocab {tok.vocab_size}")
    batches = BatchIterator(pairs, tok, args.batch, args.seq_len)
    tcfg = TrainConfig(steps=args.steps, microbatches=args.microbatches,
                       ckpt_dir=args.ckpt_dir, grad_compression=args.grad_compression)
    out = train(cfg, tcfg, batches, device=args.device,
                extra={"arch": args.arch, "reduced": args.reduced,
                       "tokenizer_workloads": list(TOKENIZER_WORKLOADS)})
    if out["history"]:
        print(f"[train] done; final loss {out['history'][-1]['loss']:.4f}")
    return out


if __name__ == "__main__":
    main()
