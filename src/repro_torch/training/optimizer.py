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
  matrix, and every per-layer vector of any stack (``ln1``, ``ln2``: (L, D)
  stacked), but not ``final_norm`` (D,) nor the vectors of Zamba2's
  unstacked ``shared_attn``;
* ``compress_grads`` takes one int8 scale per stacked leaf: the largest
  magnitude over all layers of that parameter.

A tree is the port's parameter tree of any family (``models/model.py``):
each stack of ``STACKS`` (``dense_layers``, ``layers``, ``mamba``) a list
of per-layer dicts, any other dict (``shared_attn``) a dict of tensors,
every other value a tensor.  ``stacked_leaves`` lists its leaves in JAX's
flattening order: top-level keys sorted, names sorted inside each key.
The optimizer state is {"m": tree, "v": tree, "step": int}.

ZeRO-1 (``zero1_spec``, ``opt_state_specs``: the reference's rule) shards
the moments over the data axes on their first unsharded dimension that
divides, which for a stack is often the layer axis.  No placement of a
per-layer tensor can say "layer l lives on data rank l // 4", so the
distributed path keeps the moments stacked: ``init_stacked_opt_state``
gives {"m": {name: (L, ...) tensor}, "v": ..., "step"} with the names and
order of ``stacked_leaves``, as DTensors laid out by ``opt_state_specs``.
``adamw_update`` takes either form; on the stacked one it stacks each
leaf's gradients and parameters, runs the same elementwise update in the
moments' layout, and hands the parameters back per layer, in their own
layout.

ZeRO-3 (the reference's ``zero3_params`` variant) stores the parameters in
that stacked form too, each laid out by its moments' spec
(``distributed.sharding.zero3_params``): parameters, gradients and moments
then share one layout, ``adamw_update`` runs elementwise with no copy and
returns the parameters stacked, and the compression takes the stacked
gradients as they are.
"""
from __future__ import annotations

import dataclasses

import torch

from ..distributed.sharding import P, to_placements, tree_map_specs
from ..models.model import STACKS, tree_map


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
    order (sorted keys, then sorted names): one tensor for a top-level leaf
    or a leaf of an unstacked dict (``shared_attn/<name>``), one per layer
    for a leaf of a stack (``<stack>/<name>``)."""
    out = []
    for k in sorted(tree):
        v = tree[k]
        if k in STACKS:
            out += [(f"{k}/{n}", [lp[n] for lp in v]) for n in sorted(v[0] if v else ())]
        elif isinstance(v, dict):
            out += [(f"{k}/{n}", [v[n]]) for n in sorted(v)]
        else:
            out.append((k, [v]))
    return out


def is_stacked(tree: dict) -> bool:
    """True for a tree in the stacked form ({name: tensor}, names as
    ``stacked_leaves``): ZeRO-3 parameters or gradients, stacked moments."""
    return all(isinstance(t, torch.Tensor) for t in tree.values())


def unflatten(by_name: dict[str, list]) -> dict:
    """The per-layer tree of ``stacked_leaves``-style groups, shaped by their
    names alone (``from_stacked`` without a tree to copy)."""
    out = {}
    for name, ts in by_name.items():
        k, _, n = name.partition("/")
        if k in STACKS:
            for lp, t in zip(out.setdefault(k, [{} for _ in ts]), ts):
                lp[n] = t
        elif n:
            out.setdefault(k, {})[n] = ts[0]
        else:
            out[k] = ts[0]
    return out


def from_stacked(like: dict, by_name: dict[str, list]) -> dict:
    """A tree shaped as ``like`` from ``stacked_leaves``-style groups."""
    out = {}
    for k, v in like.items():
        if k in STACKS:
            out[k] = [{n: by_name[f"{k}/{n}"][i] for n in lp} for i, lp in enumerate(v)]
        elif isinstance(v, dict):
            out[k] = {n: by_name[f"{k}/{n}"][0] for n in v}
        else:
            out[k] = by_name[k][0]
    return out


def init_opt_state(params: dict) -> dict:
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device)  # noqa: E731
    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params), "step": 0}


def in_stack(name: str) -> bool:
    """Whether the ``stacked_leaves`` leaf ``name`` is a leaf of a stack."""
    return name.split("/", 1)[0] in STACKS


def stack(name: str, ts: list):
    """A ``stacked_leaves`` group as the reference's leaf: a stack's layers
    stacked to (L, ...), any other leaf itself."""
    return torch.stack(ts) if in_stack(name) else ts[0]


def init_stacked_opt_state(params: dict, specs: dict | None = None, mesh=None) -> dict:
    """Zero moments in the stacked form: one float32 (L, ...) tensor per
    leaf of a stack, one tensor per other leaf, keyed by ``stacked_leaves``
    names; DTensors laid out by ``specs`` (``opt_state_specs(...)["m"]``)
    on ``mesh`` when both are given, built shard by shard."""
    out = {}
    for name, ps in stacked_leaves(params):
        shape = _stacked_shape(name, ps)
        if mesh is None:
            out[name] = torch.zeros(shape, dtype=torch.float32, device=ps[0].device)
        else:
            from torch.distributed.tensor import zeros

            out[name] = zeros(shape, dtype=torch.float32, device_mesh=mesh,
                              placements=to_placements(specs[name], mesh))
    return {"m": out, "v": {k: torch.zeros_like(t) for k, t in out.items()}, "step": 0}


def _stacked_shape(name: str, ps: list) -> tuple:
    return (len(ps), *ps[0].shape) if in_stack(name) else tuple(ps[0].shape)


def is_stacked_state(state: dict) -> bool:
    """True for the moments of ``init_stacked_opt_state``."""
    return is_stacked(state["m"])


def _layout(x, like):
    """``x`` in ``like``'s DTensor layout (``x`` itself where either is a
    plain tensor or the layouts agree)."""
    from torch.distributed.tensor import DTensor

    if not (isinstance(x, DTensor) and isinstance(like, DTensor)) \
            or tuple(x.placements) == tuple(like.placements):
        return x
    return x.redistribute(like.device_mesh, like.placements)


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, params: dict, grads: dict, state: dict,
                 moment_specs=None):
    """One AdamW step -> (new params, new state, global grad norm (a f32
    tensor, before the clip)).  ``state`` is the per-layer tree of
    ``init_opt_state`` or the stacked form of ``init_stacked_opt_state``;
    with stacked (ZeRO-3) parameters and gradients, the stacked form, and
    the new parameters come back stacked, in their layout.
    On the stacked form the update runs in the moments' layout; with
    ``moment_specs`` (any true value: the stacked moments carry their own
    layout) the new parameters are also cast to their dtype there, so the
    gather back to the parameters' layout moves their dtype, not float32,
    as the reference's ``moment_specs`` constraint does."""
    step = state["step"] + 1
    lr = cfg.lr * min(step / max(cfg.warmup_steps, 1), 1.0)  # linear warmup
    zero3 = is_stacked(params)
    if zero3:
        gnorm = torch.sqrt(_square_sum_by_layer(grads))
    else:
        flat_g = stacked_leaves(grads)
        gnorm = torch.sqrt(sum(torch.sum(torch.square(g.to(torch.float32)))
                               for _, gs in flat_g for g in gs))
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
    b1t = 1.0 - cfg.b1 ** step
    b2t = 1.0 - cfg.b2 ** step

    def upd(p, g, m, v, decay):
        gf = g.to(torch.float32) * scale
        m = cfg.b1 * m + (1 - cfg.b1) * gf
        v = cfg.b2 * v + (1 - cfg.b2) * gf * gf
        delta = (m / b1t) / (torch.sqrt(v / b2t) + cfg.eps)
        if decay:
            delta = delta + cfg.weight_decay * p.to(torch.float32)
        return p.to(torch.float32) - lr * delta, m, v

    if zero3:  # parameters, gradients and moments in one layout
        new_p, new_m, new_v = {}, {}, {}
        for name, p in params.items():
            pf, new_m[name], new_v[name] = upd(p, grads[name], state["m"][name],
                                               state["v"][name], p.dim() >= 2)
            new_p[name] = pf.to(p.dtype)
        return new_p, {"m": new_m, "v": new_v, "step": step}, gnorm

    if is_stacked_state(state):
        new_p, new_m, new_v = {}, {}, {}
        for (name, ps), (_, gs) in zip(stacked_leaves(params), flat_g):
            m, v = state["m"][name], state["v"][name]
            decay = len(_stacked_shape(name, ps)) >= 2
            p_all = stack(name, ps)
            pf, new_m[name], new_v[name] = upd(_layout(p_all, m), _layout(stack(name, gs), m),
                                               m, v, decay)
            if moment_specs:
                pf = pf.to(ps[0].dtype)
            pf = _layout(pf, p_all).to(ps[0].dtype)
            new_p[name] = [pf[i] for i in range(len(ps))] if in_stack(name) else [pf]
        return (from_stacked(params, new_p),
                {"m": new_m, "v": new_v, "step": step}, gnorm)

    new_p, new_m, new_v = {}, {}, {}
    groups = zip(stacked_leaves(params), flat_g, stacked_leaves(state["m"]),
                 stacked_leaves(state["v"]))
    for (name, ps), (_, gs), (_, ms), (_, vs) in groups:
        # decoupled decay on matrices only, by the stacked leaf's dims (a
        # stack's leaf has one more than the port's per-layer tensor)
        decay = ps[0].dim() + in_stack(name) >= 2
        new_p[name], new_m[name], new_v[name] = [], [], []
        for p, g, m, v in zip(ps, gs, ms, vs):
            pf, m, v = upd(p, g, m, v, decay)
            new_p[name].append(pf.to(p.dtype))
            new_m[name].append(m)
            new_v[name].append(v)
    return (from_stacked(params, new_p),
            {"m": from_stacked(params, new_m), "v": from_stacked(params, new_v),
             "step": step},
            gnorm)


def _square_sum_by_layer(grads: dict):
    """The sum of squares of stacked gradients, added layer by layer in
    ``stacked_leaves`` order as the per-layer tree's norm adds them, so that
    one rank gives its bits.  On a mesh each rank sums its own layers'
    shards, and those few floats per leaf are then made whole."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    total = 0
    for name, g in grads.items():
        stack_ = in_stack(name)
        if isinstance(g, DTensor):  # a pending sum is reduced before it is squared
            g = g.redistribute(g.device_mesh, [Replicate() if pl.is_partial() else pl
                                               for pl in g.placements])
        local = g.to_local() if isinstance(g, DTensor) else g
        sums = torch.stack([torch.sum(torch.square(x.to(torch.float32)))
                            for x in (local.unbind(0) if stack_ else (local,))])
        if isinstance(g, DTensor):
            pls = [Shard(0) if stack_ and pl == Shard(0) else
                   Partial() if isinstance(pl, Shard) else Replicate() for pl in g.placements]
            sums = DTensor.from_local(sums, g.device_mesh, pls, run_check=False,
                                      shape=(g.shape[0] if stack_ else 1,),
                                      stride=(1,)).full_tensor()
        for s in sums.unbind(0):
            total = total + s
    return total


# ------------------------------------------------------------------- ZeRO-1


def zero1_spec(spec: P, shape: tuple, data_axes: tuple, data_size: int) -> P:
    """Extend a param's TP spec so optimizer moments also shard over the data
    axes: pick the first dimension that is unsharded and divisible."""
    parts = list(spec) + [None] * (len(shape) - len(spec))
    for i, (ax, dim) in enumerate(zip(parts, shape)):
        if ax is None and dim % data_size == 0 and dim >= data_size:
            parts[i] = data_axes if len(data_axes) > 1 else data_axes[0]
            return P(*parts)
    return P(*parts)  # nothing divisible: stay TP-only


def stacked_specs(param_specs: dict, param_shapes: dict) -> dict:
    """{name: (stacked shape, stacked spec)} per ``stacked_leaves`` name: a
    stack's leaf takes the (L, ...) shape and its spec a leading ``None``,
    the reference's stacked leaf."""
    shapes = tree_map_specs(lambda t, s: (tuple(t.shape) if hasattr(t, "shape")
                                          else tuple(t), s), param_shapes, param_specs)
    out = {}
    for name, pairs in stacked_leaves(shapes):
        (shape, spec), n = pairs[0], len(pairs)
        out[name] = (((n, *shape), P(None, *spec)) if in_stack(name)
                     else (shape, spec))
    return out


def opt_state_specs(param_specs: dict, param_shapes: dict, data_axes: tuple,
                    data_size: int, zero1: bool = True) -> dict:
    """ZeRO-1 specs of the stacked moments: {"m": {name: P}, "v": ...,
    "step": P()}, ``zero1_spec`` of each stacked leaf (shapes may be shape
    tuples or tensors); without ``zero1`` each moment takes its
    parameter's stacked spec."""
    moment = {name: zero1_spec(spec, shape, data_axes, data_size) if zero1 else spec
              for name, (shape, spec) in stacked_specs(param_specs, param_shapes).items()}
    return {"m": moment, "v": dict(moment), "step": P()}


# --------------------------------------- error-feedback int8 compression


@torch.no_grad()
def compress_grads(grads: dict, residual: dict | None = None):
    """Error-feedback int8 quantization -> (q, scales, new residual): q an
    int8 tree, ``scales`` one f32 scalar per stacked leaf ({name: scale},
    names as ``stacked_leaves``), the residual the quantization error that
    feeds into the next step.  Stacked (ZeRO-3) gradients give q and the
    residual in their form and layout."""
    if is_stacked(grads):
        if residual is None:
            residual = {n: torch.zeros_like(g, dtype=torch.float32) for n, g in grads.items()}
        qs, errs, scales = {}, {}, {}
        for name, g in grads.items():
            gf = g.to(torch.float32) + residual[name]
            scales[name] = torch.clamp(gf.abs().max(), min=1e-12) / 127.0
            qs[name] = torch.clamp(torch.round(gf / scales[name]), -127, 127).to(torch.int8)
            errs[name] = gf - qs[name].to(torch.float32) * scales[name]
        return qs, scales, errs
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
    if is_stacked(q):
        return {name: qi.to(torch.float32) * scales[name] for name, qi in q.items()}
    by_name = {name: [qi.to(torch.float32) * scales[name] for qi in qis]
               for name, qis in stacked_leaves(q)}
    return from_stacked(q, by_name)
