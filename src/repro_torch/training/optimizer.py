"""AdamW with a global-norm clip and a linear warmup, and error-feedback
int8 gradient compression: the JAX package's ``repro/training/
optimizer.py`` over the port's parameter trees.

The math is the reference's, step for step: float32 moments, the global
gradient norm clipped to ``clip_norm``, bias correction, decoupled weight
decay, and the new parameter rounded to its dtype every step (no float32
master copy).  ``torch.optim.AdamW`` orders these operations differently
and is not used.

The reference keeps each per-layer parameter as one stacked (L, ...) leaf;
the port keeps one tensor per layer.  Two rules follow the stacked leaf,
so that both packages give the same parameters after every step:

* weight decay goes on every leaf that is at least 2-D once stacked: every
  matrix, and every per-layer vector (``ln1``, ``ln2``: (L, D) stacked),
  but not ``final_norm`` (D,);
* ``compress_grads`` takes one int8 scale per stacked leaf: the largest
  magnitude over all layers of that parameter.

A tree is the port's: {name: tensor, ..., "layers": [{name: tensor}, ...]}.
The optimizer state is {"m": tree, "v": tree, "step": int}.  The ZeRO-1
specs of the reference (``zero1_spec``, ``opt_state_specs``) wait for the
port's distribution (ROADMAP.md Queue 1).
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100


def stacked_leaves(tree: dict) -> list[tuple[str, list]]:
    """(name, tensors) per leaf of the JAX package's stacked tree, in JAX's
    order (sorted keys): one tensor for a top-level leaf, one per layer for
    a per-layer leaf (``layers/<name>``)."""
    out = []
    for k in sorted(tree):
        if k == "layers":
            for n in sorted(tree["layers"][0]):
                out.append((f"layers/{n}", [lp[n] for lp in tree["layers"]]))
        else:
            out.append((k, [tree[k]]))
    return out


def tree_map(fn: Callable, tree: dict, *rest: dict) -> dict:
    """``fn`` over the tensors of trees of one structure."""
    return {k: ([{n: fn(lp[n], *(r[k][i][n] for r in rest)) for n in lp}
                 for i, lp in enumerate(v)] if k == "layers"
                else fn(v, *(r[k] for r in rest)))
            for k, v in tree.items()}


def from_stacked(like: dict, by_name: dict[str, list]) -> dict:
    """A tree shaped as ``like`` from ``stacked_leaves``-style groups."""
    return {k: ([{n: by_name[f"layers/{n}"][i] for n in lp} for i, lp in enumerate(v)]
                if k == "layers" else by_name[k][0])
            for k, v in like.items()}


def init_opt_state(params: dict) -> dict:
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device)  # noqa: E731
    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params), "step": 0}


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, params: dict, grads: dict, state: dict):
    """One AdamW step -> (new params, new state, global grad norm (a f32
    tensor, before the clip))."""
    step = state["step"] + 1
    lr = cfg.lr * min(step / max(cfg.warmup_steps, 1), 1.0)  # linear warmup
    flat_g = stacked_leaves(grads)
    gnorm = torch.sqrt(sum(torch.sum(torch.square(g.to(torch.float32)))
                           for _, gs in flat_g for g in gs))
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
    b1t = 1.0 - cfg.b1 ** step
    b2t = 1.0 - cfg.b2 ** step
    new_p, new_m, new_v = {}, {}, {}
    groups = zip(stacked_leaves(params), flat_g, stacked_leaves(state["m"]),
                 stacked_leaves(state["v"]))
    for (name, ps), (_, gs), (_, ms), (_, vs) in groups:
        # decoupled decay on matrices only, by the stacked leaf's dims
        decay = ps[0].dim() + name.startswith("layers/") >= 2
        new_p[name], new_m[name], new_v[name] = [], [], []
        for p, g, m, v in zip(ps, gs, ms, vs):
            gf = g.to(torch.float32) * scale
            m = cfg.b1 * m + (1 - cfg.b1) * gf
            v = cfg.b2 * v + (1 - cfg.b2) * gf * gf
            delta = (m / b1t) / (torch.sqrt(v / b2t) + cfg.eps)
            if decay:
                delta = delta + cfg.weight_decay * p.to(torch.float32)
            new_p[name].append((p.to(torch.float32) - lr * delta).to(p.dtype))
            new_m[name].append(m)
            new_v[name].append(v)
    return (from_stacked(params, new_p),
            {"m": from_stacked(params, new_m), "v": from_stacked(params, new_v),
             "step": step},
            gnorm)


# --------------------------------------- error-feedback int8 compression


@torch.no_grad()
def compress_grads(grads: dict, residual: dict | None = None):
    """Error-feedback int8 quantization -> (q, scales, new residual): q an
    int8 tree, ``scales`` one f32 scalar per stacked leaf ({name: scale},
    names as ``stacked_leaves``), the residual the quantization error that
    feeds into the next step."""
    if residual is None:
        residual = tree_map(lambda g: torch.zeros(g.shape, dtype=torch.float32,
                                                  device=g.device), grads)
    qs, errs, scales = {}, {}, {}
    for (name, gs), (_, rs) in zip(stacked_leaves(grads), stacked_leaves(residual)):
        gf = [g.to(torch.float32) + r for g, r in zip(gs, rs)]
        amax = torch.stack([x.abs().max() for x in gf]).max()
        scale = torch.clamp(amax, min=1e-12) / 127.0
        qs[name] = [torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
                    for x in gf]
        errs[name] = [x - qi.to(torch.float32) * scale for x, qi in zip(gf, qs[name])]
        scales[name] = scale
    return from_stacked(grads, qs), scales, from_stacked(grads, errs)


def decompress_grads(q: dict, scales: dict) -> dict:
    by_name = {name: [qi.to(torch.float32) * scales[name] for qi in qis]
               for name, qis in stacked_leaves(q)}
    return from_stacked(q, by_name)
