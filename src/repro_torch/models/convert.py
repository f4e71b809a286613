"""Parameters of the JAX package's transformer -> the port's layout.

``params_from_jax`` takes the JAX nested dict of arrays (``init_params``
output or a restored checkpoint, as numpy arrays), whose layers are
stacked on a leading (L, ...) axis in ``x @ W`` layout, and returns the
port's dict with one entry per layer, cast to ``cfg.dtype``.  Every value
passes through float32, which holds bfloat16 exactly.
"""
from __future__ import annotations

import numpy as np
import torch

from ..olap.columnar import resolve_device
from .model import ModelConfig


def params_from_jax(cfg: ModelConfig, tree: dict, device="cuda") -> dict:
    if cfg.kind != "dense":
        raise NotImplementedError(f"{cfg.kind!r} is not ported yet (ROADMAP.md, "
                                  "Queue 1 item 8)")
    dev = resolve_device(device)

    def tensor(a):
        return torch.from_numpy(np.array(a, dtype=np.float32)).to(device=dev,
                                                                  dtype=cfg.dtype)

    stacked = tree["layers"]
    out = {k: tensor(v) for k, v in tree.items() if k != "layers"}
    out["layers"] = [{k: tensor(v[i]) for k, v in stacked.items()}
                     for i in range(cfg.n_layers)]
    return out
