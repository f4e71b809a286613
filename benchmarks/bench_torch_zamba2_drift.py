"""How far zamba2-7b's decode step drifts from a full forward, by depth, in
the JAX package and in the PyTorch port, on the CPU.

Teacher forcing holds one ``decode_step`` after a prefill over S tokens to
``forward`` over S+1.  At full width (d_model 3584, 112 SSD heads of 64,
the shared attention + geglu block after every 6 Mamba2 layers) with
initialised weights the model amplifies rounding layer by layer, in both
frameworks; this script reads the drift from the same weights (the JAX
init, converted) and tokens, in float32 and bfloat16, at depths cut from
81 to what this host's memory holds (each cut listed in the output).
Prints one JSON object.

    PYTHONPATH=src JAX_PLATFORMS=cpu python benchmarks/bench_torch_zamba2_drift.py
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import json

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs.registry import get as jget
from repro_torch.configs.registry import get
from repro_torch.models import zamba2
from repro_torch.models.convert import params_from_jax

NAME = "zamba2-7b"
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def jax_drift(cfg, params, tokens) -> float:
    mod = cfg.build()
    t = jnp.asarray(tokens)
    ext = jnp.concatenate([t, t[:, -1:]], axis=1)
    logits, caches, pos = mod.prefill(cfg, params, tokens=t)
    step = mod.decode_step(cfg, params, t[:, -1], caches, pos)[0]
    full = mod.forward(cfg, params, tokens=ext)[:, -1]
    return float(jnp.abs(step.astype(jnp.float32) - full.astype(jnp.float32)).max())


def port_drift(cfg, params, tokens) -> float:
    t = torch.from_numpy(tokens)
    with torch.inference_mode():
        logits, caches, pos = zamba2.prefill(cfg, params, tokens=t)
        step = zamba2.decode_step(cfg, params, t[:, -1], caches, pos)[0]
        full = zamba2.forward(cfg, params, tokens=torch.cat([t, t[:, -1:]], dim=1))[:, -1]
    return float((step.float() - full.float()).abs().max())


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--depths", default="6,7,12",
                    help="Mamba2 layers kept of 81, at least 6: the reference's prefill "
                         "needs one application of the shared block (after every 6th)")
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--seq", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    depths = [int(d) for d in args.depths.split(",")]
    full = jget(NAME)
    tokens = np.random.default_rng(args.seed).integers(
        0, full.vocab, size=(args.batch, args.seq)).astype(np.int32)
    out: dict = {"arch": NAME, "tokens": list(tokens.shape), "depths": depths,
                 "reduced": {"n_layers": f"{max(depths)} of {full.n_layers} at most, "
                             f"cut to each of {depths}"},
                 "shared_block_applications": {d: d // full.attn_every for d in depths}}
    for name, (jd, td) in DTYPES.items():
        jcfg = dataclasses.replace(full, n_layers=max(depths), dtype=jd)
        jp = jcfg.build().init_params(jcfg, jax.random.PRNGKey(args.seed))
        tcfg = dataclasses.replace(get(NAME), n_layers=max(depths), dtype=td)
        tp = params_from_jax(tcfg, jax.tree.map(np.asarray, jp), device="cpu")
        rows = {}
        for d in depths:
            jcut = {**jp, "mamba": jax.tree.map(lambda a, d=d: a[:d], jp["mamba"])}
            tcut = {**tp, "mamba": tp["mamba"][:d]}
            rows[d] = {"jax": jax_drift(dataclasses.replace(jcfg, n_layers=d), jcut, tokens),
                       "port": port_drift(dataclasses.replace(tcfg, n_layers=d), tcut, tokens)}
            print(json.dumps({name: {d: rows[d]}}), flush=True)
        out[f"decode_drift_{name}"] = rows
        del jp, tp
        gc.collect()
    print(json.dumps(out))


if __name__ == "__main__":
    main()
