"""How far mamba2-780m's decode step drifts from a full forward, by depth,
in the JAX package and in the PyTorch port, on the CPU.

Teacher forcing holds one ``decode_step`` after a prefill over S tokens to
``forward`` over S+1 (``tests/test_models_smoke.py``: 3e-2).  At full width
with initialised weights the model amplifies rounding layer by layer, so
the drift grows with depth in both frameworks; this script reads it from
the same weights (the JAX init, converted) and tokens, in float32 and
bfloat16, and the port's float32 prefill with one CPU thread against the
default thread count (its own rounding spread).  Prints one JSON object.

    PYTHONPATH=src JAX_PLATFORMS=cpu python benchmarks/bench_torch_mamba2_drift.py
"""
from __future__ import annotations

import argparse
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs.registry import get as jget
from repro_torch.configs.registry import get
from repro_torch.models import mamba2
from repro_torch.models.convert import params_from_jax

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
        logits, caches, pos = mamba2.prefill(cfg, params, tokens=t)
        step = mamba2.decode_step(cfg, params, t[:, -1], caches, pos)[0]
        full = mamba2.forward(cfg, params, tokens=torch.cat([t, t[:, -1:]], dim=1))[:, -1]
    return float((step - full).abs().max())


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--depths", default="1,2,4,12,48")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    depths = [int(d) for d in args.depths.split(",")]
    tokens = np.random.default_rng(args.seed).integers(
        0, jget("mamba2-780m").vocab, size=(4, 64)).astype(np.int32)
    out: dict = {"tokens": list(tokens.shape), "depths": depths}
    for name, (jd, td) in DTYPES.items():
        jcfg = dataclasses.replace(jget("mamba2-780m"), n_layers=max(depths), dtype=jd)
        jp = jcfg.build().init_params(jcfg, jax.random.PRNGKey(args.seed))
        tcfg = dataclasses.replace(get("mamba2-780m"), n_layers=max(depths), dtype=td)
        tp = params_from_jax(tcfg, jax.tree.map(np.asarray, jp), device="cpu")
        rows = {}
        for d in depths:
            jcut = {**jp, "layers": jax.tree.map(lambda a, d=d: a[:d], jp["layers"])}
            tcut = {**tp, "layers": tp["layers"][:d]}
            rows[d] = {"jax": jax_drift(dataclasses.replace(jcfg, n_layers=d), jcut, tokens),
                       "port": port_drift(dataclasses.replace(tcfg, n_layers=d), tcut, tokens)}
        out[f"decode_drift_{name}"] = rows
        if name == "float32":
            threads = torch.get_num_threads()
            with torch.inference_mode():
                t = torch.from_numpy(tokens)
                many = mamba2.prefill(tcfg, tp, tokens=t)[0]
                torch.set_num_threads(1)
                one = mamba2.prefill(tcfg, tp, tokens=t)[0]
                torch.set_num_threads(threads)
            out["port_float32_prefill_1_vs_default_threads"] = float((one - many).abs().max())
            out["default_threads"] = threads
    print(json.dumps(out))


if __name__ == "__main__":
    main()
