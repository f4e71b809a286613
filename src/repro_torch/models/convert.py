"""Parameters of the JAX package's models -> the port's layout.

``params_from_jax`` takes the JAX nested dict of arrays (``init_params``
output or a restored checkpoint, as numpy arrays) of the dense transformer
or of Mamba2, whose layers are stacked on a leading (L, ...) axis in
``x @ W`` layout, and returns the port's dict with one entry per layer.
Each leaf keeps its JAX dtype: the family's ``FLOAT32_LEAVES`` (Mamba2's
``dt_bias``, ``a_log``, ``d_skip``) stay float32, every other leaf is cast
to ``cfg.dtype``.  Every value passes through float32, which holds
bfloat16 exactly.
"""
from __future__ import annotations

import numpy as np
import torch

from ..olap.columnar import resolve_device
from .model import ModelConfig


def params_from_jax(cfg: ModelConfig, tree: dict, device="cuda") -> dict:
    f32_leaves = cfg.build().FLOAT32_LEAVES  # raises for a family not ported
    dev = resolve_device(device)

    def tensor(name, a):
        dtype = torch.float32 if name in f32_leaves else cfg.dtype
        return torch.from_numpy(np.array(a, dtype=np.float32)).to(device=dev, dtype=dtype)

    stacked = tree["layers"]
    out = {k: tensor(k, v) for k, v in tree.items() if k != "layers"}
    out["layers"] = [{k: tensor(k, v[i]) for k, v in stacked.items()}
                     for i in range(cfg.n_layers)]
    return out
