"""Parameters between the JAX package's layout and the port's.

``params_from_jax`` takes the JAX nested dict of arrays (``init_params``
output or a restored checkpoint, as numpy arrays or CPU tensors) of any
family and returns the port's dict.  Each of JAX's stacks (``STACKS``:
``layers``, an MoE's ``dense_layers``, Zamba2's ``mamba``), whose leaves
carry a leading (L, ...) layer axis, becomes a list with one dict per
layer; any other subtree (Zamba2's ``shared_attn``) stays a dict.  Leaves
keep the ``x @ W`` layout and their shapes (an MoE's experts stay
(E_shards, E_local, D, F)).  Each leaf keeps its JAX dtype: the family's
``FLOAT32_LEAVES`` (Mamba2's ``dt_bias``, ``a_log``, ``d_skip``; the MoE
``router``) stay float32, every other leaf is cast to ``cfg.dtype``.  A
numpy value passes through float32, which holds bfloat16 exactly; a
tensor is cast directly.

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
from .model import STACKS, ModelConfig


def params_from_jax(cfg: ModelConfig, tree: dict, device="cuda") -> dict:
    f32_leaves = cfg.build().FLOAT32_LEAVES
    dev = resolve_device(device)

    def tensor(name, a):
        dtype = torch.float32 if name in f32_leaves else cfg.dtype
        src = a if isinstance(a, torch.Tensor) else torch.from_numpy(
            np.array(a, dtype=np.float32))
        return src.to(device=dev, dtype=dtype)

    out = {}
    for k, v in tree.items():
        if k in STACKS:
            n_layers = len(next(iter(v.values())))
            out[k] = [{n: tensor(n, a[i]) for n, a in v.items()} for i in range(n_layers)]
        elif isinstance(v, dict):
            out[k] = {n: tensor(n, a) for n, a in v.items()}
        else:
            out[k] = tensor(k, v)
    return out


def stack_layers(tree: dict) -> dict:
    """A tree of the port's shape (its stacks lists of per-layer dicts) in
    the JAX layout: each per-layer leaf stacked to (L, ...), every leaf a
    CPU tensor in its own dtype."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, list):
            out[k] = {n: torch.stack([lp[n].detach().cpu() for lp in v]) for n in v[0]}
        elif isinstance(v, dict):
            out[k] = {n: t.detach().cpu() for n, t in v.items()}
        else:
            out[k] = v.detach().cpu()
    return out


def unstack_layers(tree: dict, device="cuda") -> dict:
    """``stack_layers``' inverse, every leaf kept in its dtype, on
    ``device``."""
    dev = resolve_device(device)
    out = {}
    for k, v in tree.items():
        if k in STACKS:
            n_layers = len(next(iter(v.values())))
            out[k] = [{n: torch.as_tensor(a[i]).to(dev) for n, a in v.items()}
                      for i in range(n_layers)]
        elif isinstance(v, dict):
            out[k] = {n: torch.as_tensor(a).to(dev) for n, a in v.items()}
        else:
            out[k] = torch.as_tensor(v).to(dev)
    return out


def params_to_jax(cfg: ModelConfig, params: dict) -> dict:
    """The port's parameters in the JAX package's layout (``params_from_jax``'s
    inverse): per-layer tensors stacked to (L, ...), CPU tensors in each
    leaf's dtype."""
    n_layers = sum(len(params[k]) for k in STACKS if k in params)
    if n_layers != cfg.n_layers:
        raise ValueError(f"{n_layers} layers for a {cfg.n_layers}-layer config")
    return stack_layers(params)
