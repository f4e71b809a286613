"""Parameters between the JAX package's layout and the port's.

``params_from_jax`` takes the JAX nested dict of arrays (``init_params``
output or a restored checkpoint, as numpy arrays or CPU tensors) of the
dense transformer or of Mamba2, whose layers are stacked on a leading
(L, ...) axis in ``x @ W`` layout, and returns the port's dict with one
entry per layer.  Each leaf keeps its JAX dtype: the family's
``FLOAT32_LEAVES`` (Mamba2's ``dt_bias``, ``a_log``, ``d_skip``) stay
float32, every other leaf is cast to ``cfg.dtype``.  A numpy value passes
through float32, which holds bfloat16 exactly; a tensor is cast directly.

``params_to_jax`` is its inverse, and ``stack_layers`` the same for any
tree of the port's shape (the optimizer's moments): per-layer tensors are
stacked back to (L, ...) on the CPU, each in its own dtype, so bfloat16
is kept bit for bit.  The leaves are CPU tensors, not numpy arrays:
numpy has no bfloat16 without ``ml_dtypes``, which the port does not
use; ``.numpy()`` of a float32 leaf is the array the JAX package takes.
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
        src = a if isinstance(a, torch.Tensor) else torch.from_numpy(
            np.array(a, dtype=np.float32))
        return src.to(device=dev, dtype=dtype)

    stacked = tree["layers"]
    out = {k: tensor(k, v) for k, v in tree.items() if k != "layers"}
    out["layers"] = [{k: tensor(k, v[i]) for k, v in stacked.items()}
                     for i in range(cfg.n_layers)]
    return out


def stack_layers(tree: dict) -> dict:
    """A tree of the port's shape ({..., "layers": [per-layer dicts]}) in
    the JAX layout: each per-layer leaf stacked to (L, ...), every leaf a
    CPU tensor in its own dtype."""
    out = {k: v.detach().cpu() for k, v in tree.items() if k != "layers"}
    layers = tree["layers"]
    out["layers"] = {n: torch.stack([lp[n].detach().cpu() for lp in layers])
                     for n in layers[0]}
    return out


def unstack_layers(tree: dict, device="cuda") -> dict:
    """``stack_layers``' inverse, every leaf kept in its dtype, on
    ``device``."""
    dev = resolve_device(device)
    out = {k: torch.as_tensor(v).to(dev) for k, v in tree.items() if k != "layers"}
    stacked = tree["layers"]
    n_layers = len(next(iter(stacked.values())))
    out["layers"] = [{n: torch.as_tensor(v[i]).to(dev) for n, v in stacked.items()}
                     for i in range(n_layers)]
    return out


def params_to_jax(cfg: ModelConfig, params: dict) -> dict:
    """The port's parameters in the JAX package's layout (``params_from_jax``'s
    inverse): per-layer tensors stacked to (L, ...), CPU tensors in each
    leaf's dtype."""
    if len(params["layers"]) != cfg.n_layers:
        raise ValueError(f"{len(params['layers'])} layers for a {cfg.n_layers}-layer config")
    return stack_layers(params)
