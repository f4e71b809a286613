"""Sharding rules and activation-sharding hints: the JAX package's
``repro/distributed/sharding.py`` over ``torch.distributed`` DTensors.

A spec is the port's :class:`P`: one entry per tensor dimension, each a
mesh-axis name, a tuple of names (that dimension split over several mesh
axes, the first name major), or ``None`` (not split).  ``to_placements``
turns it into DTensor placements on a ``DeviceMesh``.  Parameter specs come
from param-tree paths with JAX's rules, word for word (Megatron-style TP
over ``model``, batch over ``("pod", "data")``).  The port keeps a layer
stack as a list of per-layer tensors; each takes the spec of JAX's stacked
(L, ...) leaf with its leading ``None`` dropped.

Activation hints go through a context: layer code calls ``hint(x,
"residual")`` and the launcher decides what, if anything, that means.  With
no context, or on a plain tensor, ``hint`` returns its input: the models on
one device run the same code.  The context also carries the mesh the
models' own buffers (decode caches, ``cache_zeros``) are laid out on.
"""
from __future__ import annotations

import contextlib
import contextvars
from typing import Optional

import torch


class P(tuple):
    """A partition spec: ``P(None, "model")``, ``P(("pod", "data"), None)``."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


_ACTIVE: contextvars.ContextVar[dict] = contextvars.ContextVar(
    "repro_torch_sharding_hints", default={})


@contextlib.contextmanager
def sharding_hints(hints: dict, mesh=None):
    """Within the block, ``hint(x, name)`` lays a DTensor ``x`` out by
    ``hints[name]``; ``mesh`` (a ``DeviceMesh``) is where ``cache_zeros``
    builds the caches named in ``hints["cache"]`` (a function of (path,
    shape) -> P)."""
    token = _ACTIVE.set({**hints, "_mesh": mesh})
    try:
        yield
    finally:
        _ACTIVE.reset(token)


def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def hint(x, name: str):
    """Redistribute DTensor ``x`` to the named activation spec if one is
    active; otherwise ``x`` itself."""
    spec = _ACTIVE.get().get(name)
    if spec is None or not is_dtensor(x):
        return x
    placements = to_placements(spec, x.device_mesh)
    if tuple(x.placements) == tuple(placements):
        return x
    return x.redistribute(x.device_mesh, placements)


def settle(x):
    """A DTensor with its pending sums (``Partial``) reduced, whole on those
    mesh dimensions; anything else as it is.  A vocab-split embedding
    lookup leaves a pending sum whose mask serves one reduction only, so its
    output is settled before it is used twice."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate

    pls = [Replicate() if pl.is_partial() else pl for pl in x.placements]
    if pls == list(x.placements):
        return x
    # the gradient, too, must arrive whole there: DTensor cannot turn a
    # pending sum into the lookup's masked one
    return grad_in_layout(x.redistribute(x.device_mesh, pls))


def grad_in_layout(x):
    """DTensor ``x`` itself, whose gradient is brought to ``x``'s own
    layout before it flows on (``from_local``'s backward redistributes it
    there); anything else as it is.  Where a gradient could come back in a
    layout the ops before cannot take (a pending sum, or rows split over
    more ranks than a view's leading dimension has), this pins it."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import DTensor

    return DTensor.from_local(x.to_local(grad_placements=x.placements), x.device_mesh,
                              x.placements, run_check=False)


def cache_zeros(path: str, shape: tuple, dtype, device):
    """Zeros for a model's cache buffer ``path`` ("layers", "state",
    "attn_k", ...): a DTensor laid out by the active ``hints["cache"]`` on
    the active mesh, built shard by shard; a plain tensor with no such
    context."""
    ctx = _ACTIVE.get()
    spec_fn, mesh = ctx.get("cache"), ctx.get("_mesh")
    if spec_fn is None or mesh is None:
        return torch.zeros(shape, dtype=dtype, device=device)
    from torch.distributed.tensor import zeros

    return zeros(shape, dtype=dtype, device_mesh=mesh,
                 placements=to_placements(spec_fn(path, shape), mesh))


@contextlib.contextmanager
def on_mesh(mesh, hints: Optional[dict] = None):
    """Run the models on ``mesh``: the plain tensors they build (RoPE's
    angles, masks, positions) count as whole on every rank
    (``implicit_replication``), and ``hints`` are active."""
    from torch.distributed.tensor.experimental import implicit_replication

    with implicit_replication(), sharding_hints(hints or {}, mesh):
        yield


def batch_size_of(mesh) -> int:
    """The ranks a batch is split over: the product of the mesh's batch axes."""
    n = 1
    for a in batch_axes(mesh.mesh_dim_names):
        n *= mesh[a].size()
    return n


def shard_batch(batch: dict, mesh) -> dict:
    """A batch of arrays as DTensors on ``mesh``, rows split over its
    batch axes where they divide, whole otherwise."""
    from torch.distributed.tensor import distribute_tensor

    baxes, n = batch_axes(mesh.mesh_dim_names), batch_size_of(mesh)
    dev = torch.device(mesh.device_type, torch.cuda.current_device()) \
        if mesh.device_type == "cuda" else torch.device(mesh.device_type)
    out = {}
    for k, v in batch.items():
        t = torch.as_tensor(v).to(dev)
        spec = P(baxes if t.shape[0] % n == 0 else None)
        out[k] = distribute_tensor(t, mesh, to_placements(spec, mesh))
    return out


# ------------------------------------------------------------ placements


def _names(entry) -> tuple:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def to_placements(spec, mesh) -> tuple:
    """DTensor placements of ``spec`` on ``mesh``: ``Shard(i)`` on each mesh
    dimension that splits tensor dimension ``i``, ``Replicate()`` on the
    others.  A dimension split over several mesh axes is split by them in
    the mesh's order (major first), as JAX splits it by the order in the
    spec; a spec that names them in another order raises."""
    from torch.distributed.tensor import Replicate, Shard

    names = tuple(mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    for i, entry in enumerate(spec):
        axes = _names(entry)
        pos = [names.index(a) for a in axes]
        if pos != sorted(pos):
            raise ValueError(f"spec {spec}: {axes} is not in the mesh's order {names}")
        for j in pos:
            out[j] = Shard(i)
    return tuple(out)


def local_shape(shape: tuple, spec, mesh_shape: dict, coord: Optional[dict] = None) -> tuple:
    """The shard of ``shape`` that the device at ``coord`` (axis -> index,
    default all 0) holds under ``spec`` on a mesh of ``mesh_shape`` (axis ->
    size), by DTensor's rule: each split takes ``ceil(n / k)`` rows, the last
    ones fewer or none.  Arithmetic only: no mesh is built."""
    coord = coord or {}
    out = []
    for i, n in enumerate(shape):
        entry = spec[i] if i < len(spec) else None
        for a in _names(entry):
            k, j = mesh_shape[a], coord.get(a, 0)
            size = -(-n // k)
            n = max(0, min(size, n - j * size))
        out.append(n)
    return tuple(out)


def global_offset(shape: tuple, placements, mesh) -> tuple:
    """Where this rank's shard of a tensor of ``shape`` laid out by
    ``placements`` on ``mesh`` starts, per dimension: DTensor's rule (each
    split takes ``ceil(n / k)`` rows), in integers, so that it also runs
    on FakeTensors."""
    from torch.distributed.tensor import Shard

    coord = mesh.get_coordinate()
    size, off = list(shape), [0] * len(shape)
    for d, pl in enumerate(placements):
        if isinstance(pl, Shard):
            i = pl.dim % len(shape)
            chunk = -(-size[i] // mesh.size(d))
            start = min(coord[d] * chunk, size[i])
            off[i] += start
            size[i] = min(chunk, size[i] - start)
    return tuple(off)


# --------------------------------------------------------------- param rules


def batch_axes(mesh_axis_names) -> tuple:
    return tuple(a for a in ("pod", "data") if a in mesh_axis_names)


def param_spec(path: str, shape: tuple, model_size: int, stacked: bool) -> P:
    """TP sharding rule for one parameter, by its tree path.

    ``stacked``: the leading axis is the scanned layer axis; rules shift by 1.
    Output-dim sharding applies only when divisible by the model-axis size —
    small models (e.g. gemma-2b's 8 q-heads) replicate instead, which is the
    honest cost of narrow models on wide meshes.
    """
    off = 1 if stacked else 0

    def dim_ok(i: int) -> bool:
        return shape[i + off] % model_size == 0

    def spec(*axes) -> P:
        return P(*([None] * off + list(axes)))

    leaf = path.split("/")[-1]
    if leaf in ("embed",):
        return P("model", None) if shape[0] % model_size == 0 else P(None, None)
    if leaf in ("lm_head",):
        return P(None, "model") if shape[1] % model_size == 0 else P(None, None)
    if leaf in ("wq", "wk", "wv", "w1", "w3", "wz", "wx", "in_up"):
        return spec(None, "model") if dim_ok(1) else spec(None, None)
    if leaf in ("wo", "w2", "out_proj"):
        return spec("model", None) if dim_ok(0) else spec(None, None)
    if leaf in ("moe_w1", "moe_w3"):  # (Es, El, D, F) expert-sharded
        return spec("model", None, None, None)
    if leaf in ("moe_w2",):
        return spec("model", None, None, None)
    if leaf in ("conv",):  # depthwise conv (K, d_inner)
        return spec(None, "model") if dim_ok(1) else spec(None, None)
    # norms, biases, routers, dt/A params: replicated
    return spec(*([None] * (len(shape) - off)))


def _shape(leaf) -> tuple:
    return tuple(leaf.shape) if hasattr(leaf, "shape") else tuple(leaf)


def tree_param_specs(params_shape, model_size: int, stacked_prefixes=("layers",)):
    """A spec tree parallel to a port parameter or shape tree (lists of
    per-layer dicts for the stacks).  A leaf of a stack named in
    ``stacked_prefixes`` takes JAX's rule for its stacked (L, ...) shape,
    the leading ``None`` dropped."""

    def walk(tree, path, stacked, depth):
        if isinstance(tree, dict):
            return {k: walk(v, f"{path}/{k}" if path else k,
                            stacked or k in stacked_prefixes, depth)
                    for k, v in tree.items()}
        if isinstance(tree, list):
            return [walk(v, path, stacked, len(tree)) for v in tree]
        shape = _shape(tree)
        if depth:  # a layer of a stack: JAX's spec of the (L, ...) leaf
            spec = param_spec(path, (depth, *shape), model_size, stacked)
            full = list(spec) + [None] * (len(shape) + 1 - len(spec))
            if full[0] is not None:
                raise ValueError(f"{path}: spec {spec} splits the layer axis")
            return P(*full[1:])
        return param_spec(path, shape, model_size, stacked)

    return walk(params_shape, "", False, 0)


def tree_map_specs(fn, tree, spec_tree):
    """``fn(leaf, spec)`` over a parameter tree and its spec tree."""
    if isinstance(tree, dict):
        return {k: tree_map_specs(fn, v, spec_tree[k]) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map_specs(fn, v, s) for v, s in zip(tree, spec_tree)]
    return fn(tree, spec_tree)


def distribute_tree(params, spec_tree, mesh):
    """Each tensor of ``params`` as a DTensor laid out by its spec: the
    counterpart of JAX's ``named_sharding_tree`` plus ``device_put``."""
    from torch.distributed.tensor import distribute_tensor

    def put(t, spec):
        return distribute_tensor(t.detach(), mesh, to_placements(spec, mesh))

    return tree_map_specs(put, params, spec_tree)


# ------------------------------------------------------------------ ZeRO-3


def zero3_params(params: dict, specs: dict, mesh) -> dict:
    """A per-layer parameter tree in the ZeRO-3 layout, the reference's
    ``zero3_params`` variant: {name: DTensor}, names and order as
    ``optimizer.stacked_leaves``, a stack's leaf one (L, ...) tensor, each
    laid out by ``specs[name]``, its ZeRO-1 moment spec
    (``opt_state_specs(...)["m"]``): the data axes split the first
    unsplit dim that divides, for a stack often the layer axis."""
    from torch.distributed.tensor import distribute_tensor

    from ..training.optimizer import stack, stacked_leaves

    return {name: distribute_tensor(stack(name, [t.detach() for t in ts]), mesh,
                                    to_placements(specs[name], mesh))
            for name, ts in stacked_leaves(params)}


def gather_params(stacked: dict) -> dict:
    """The per-layer tree the models read, from ZeRO-3 parameters: each
    stacked leaf redistributed once from its ZeRO-3 layout to its
    tensor-parallel one (the reference's rule for the stacked shape: whole
    over the data axes and along the layer axis; an all-gather in the
    parameters' dtype), then split into its layers, a local split of a
    whole dim.  A leaf that no data axis splits moves nothing.  Not
    differentiable: ``zero3_grads`` is its adjoint."""
    from ..training.optimizer import in_stack, unflatten

    by_name = {}
    for name, t in stacked.items():
        if is_dtensor(t):
            mesh = t.device_mesh
            model = mesh.size(mesh.mesh_dim_names.index("model"))
            pls = to_placements(param_spec(name, tuple(t.shape), model, in_stack(name)), mesh)
            if tuple(t.placements) != pls:
                t = t.redistribute(t.device_mesh, pls)
        by_name[name] = list(t.unbind(0)) if in_stack(name) else [t]
    return unflatten(by_name)


def zero3_grads(grads: dict, like: dict) -> dict:
    """Per-layer gradients of ``gather_params(like)``'s tree as gradients of
    the stacked leaves, in their ZeRO-3 layout: each leaf's layers stacked
    (pending sums kept pending) and redistributed once to ``like[name]``'s
    placements, which reduce-scatters a pending sum over the data axes."""
    from ..training.optimizer import stack, stacked_leaves

    out = {}
    for name, gs in stacked_leaves(grads):
        g, t = stack(name, gs), like[name]
        if is_dtensor(g) and tuple(g.placements) != tuple(t.placements):
            g = g.redistribute(t.device_mesh, t.placements)
        out[name] = g
    return out
