"""Mixture-of-Experts FFN with capacity-bounded gather dispatch: the port of
the JAX package's ``repro/models/moe.py``.

Expert weights keep JAX's layout, (E_shards, E_local, D, F), so converted
and checkpointed weights need no reshape; expert ``s * E_local + j`` is
``moe_w1[s, j]``.  The routing is JAX's, to the token:

  * top-k over the f32 router logits, ties to the lower expert index
    (``jax.lax.top_k``'s order; a row of zeros routes to experts 0..k-1);
    a softmax over the k logits in f32, cast to x's dtype;
  * per expert a capacity ``cap = min(T, max(8, int(T k / E *
    capacity_factor)))``: the first ``cap`` tokens routed to it in token
    order are kept, the rest are dropped, and the empty slots read a zero
    pad row (left-pad tokens route and take capacity like any other);
  * the experts run in JAX's scan order, one local index j at a time for
    every shard at once (a batched product over the shard axis), and each
    step's gated outputs are added into ``y`` in x's dtype.  A token holds
    at most one slot of an expert, so each shard's outputs scatter into a
    table of their own without collisions, and the shards' tables are
    summed in a fixed order: the sum is the same on every run and device
    (an ``index_add_`` of all shards at once adds a token's duplicates
    with atomics on the card, in an order that changes from run to run).

On a sharded model (DTensors on a ``DeviceMesh``) ``moe_ffn`` runs per
shard through ``local_map``: each data shard routes its own tokens, and
the experts split over ``model`` as JAX's rule lays ``moe_w1/w2/w3`` out
(their leading axis).  The capacity stays JAX's, over every token of the
batch: the shards exchange their hit counts per expert (one all-gather of
E integers), and a shard keeps a hit only while the hits of the shards
before it in token order leave room.  Each model rank sums its own
experts' outputs, and the ranks' sums are added by the reduction that
follows (a ``Partial`` output).

There is no Pallas kernel on this path: routing and expert products are
plain PyTorch on every device, as they are plain ``jnp`` in JAX.  The
``record_function`` ranges ``moe.routing`` (router, top-k, slot choice,
the gathers and the gated scatter-adds) and ``moe.experts`` (the expert
products and activations) let a ``torch.profiler`` trace split the
device time between them.
"""
from __future__ import annotations

import contextlib
import contextvars

import torch
import torch.nn.functional as F

from ..distributed import local
from ..distributed.sharding import batch_axes, global_offset, grad_in_layout, hint, is_dtensor
from .model import ModelConfig

# the routes dropped for capacity, one lazy count per ``moe_ffn`` call,
# while ``count_dropped`` is open
_DROPPED: contextvars.ContextVar = contextvars.ContextVar("moe_dropped", default=None)


@contextlib.contextmanager
def count_dropped():
    """Within the block, every ``moe_ffn`` call appends the number of
    (token, expert) routes it dropped for capacity, a 0-dim int64 tensor on
    its device (no host sync), to the list this yields."""
    counts: list = []
    token = _DROPPED.set(counts)
    try:
        yield counts
    finally:
        _DROPPED.reset(token)


def expert_shards(cfg: ModelConfig) -> int:
    """The leading expert axis of JAX's layout (``repro/models/transformer.py``)."""
    return 16 if cfg.n_experts % 16 == 0 else 1


def moe_param_shapes(cfg: ModelConfig, e_shards: int) -> dict:
    e_local = cfg.n_experts // e_shards
    d, f = cfg.d_model, cfg.d_ff
    glu = cfg.activation in ("swiglu", "geglu")
    shapes = {"router": (d, cfg.n_experts),  # float32 (FLOAT32_LEAVES)
              "moe_w1": (e_shards, e_local, d, f), "moe_w2": (e_shards, e_local, f, d)}
    if glu:
        shapes["moe_w3"] = (e_shards, e_local, d, f)
    if cfg.n_shared_experts:
        fs = f * cfg.n_shared_experts
        shapes["shared_w1"] = (d, fs)
        shapes["shared_w2"] = (fs, d)
        if glu:
            shapes["shared_w3"] = (d, fs)
    return shapes


def capacity(cfg: ModelConfig, t: int) -> int:
    """Slots per (shard, local expert) for ``t`` tokens."""
    return min(t, max(8, int(t * cfg.top_k / cfg.n_experts * cfg.capacity_factor)))


def route(p: dict, xt, cfg: ModelConfig, prior_of=None, t_all: int | None = None):
    """xt: (T, D) -> (gates (T, k) in xt's dtype, ids (T, k), slots (Es, El,
    cap) token index per slot, T where empty, slot gates (Es, El, cap)).

    For one shard of a batch of ``t_all`` tokens, ``prior_of(ids)`` gives
    the hits (Es, El) of the tokens before this shard's: the capacity is
    that of ``t_all`` tokens, and those hits take its first slots."""
    t = xt.shape[0]
    k = cfg.top_k
    e_shards = expert_shards(cfg)
    e_local = cfg.n_experts // e_shards
    logits = xt.to(torch.float32) @ p["router"].to(torch.float32)  # (T, E)
    # a stable descending sort: equal logits keep the lower expert first
    top, ids = torch.sort(logits, dim=-1, descending=True, stable=True)
    top, ids = top[:, :k], ids[:, :k]
    gates = torch.softmax(top, dim=-1).to(xt.dtype)
    # hit[e, t]: token t routes to expert e; its gate there
    hit = torch.zeros((t, cfg.n_experts), dtype=torch.bool, device=xt.device)
    hit.scatter_(1, ids, True)
    gate = torch.zeros((t, cfg.n_experts), dtype=xt.dtype, device=xt.device)
    gate.scatter_(1, ids, gates)
    hit = hit.T.reshape(e_shards, e_local, t)
    gate = gate.T.reshape(e_shards, e_local, t)
    # the first ``cap`` hits in token order: hits sort by token index, the
    # rest share the fill value t (so which of them topk picks is moot)
    order = torch.arange(t, device=xt.device)
    prio = torch.where(hit, order, t)
    cap = capacity(cfg, t if t_all is None else t_all)
    slots = torch.topk(prio, min(cap, t), dim=-1, largest=False).values
    if prior_of is not None:
        room = (cap - prior_of(ids)).clamp(min=0)  # (Es, El)
        rank = torch.arange(slots.shape[-1], device=xt.device)
        slots = torch.where(rank < room[..., None], slots, t)
    pad = torch.zeros((e_shards, e_local, 1), dtype=gate.dtype, device=gate.device)
    slot_gates = torch.cat([gate, pad], dim=-1).gather(-1, slots)
    return gates, ids, slots, slot_gates


def _act(cfg: ModelConfig):
    if cfg.activation == "geglu":
        return lambda h: F.gelu(h, approximate="tanh")  # jax.nn.gelu's default
    return F.silu


def moe_ffn(p: dict, x, cfg: ModelConfig):
    """x: (B, S, D) -> (B, S, D).  Top-k routing with capacity factor."""
    b, s, d = x.shape
    t = b * s
    # on DTensors the tokens' gradient comes back in their own layout, which
    # the view back to (B, S, D) takes
    xt = grad_in_layout(x.reshape(t, d))
    glu = cfg.activation in ("swiglu", "geglu")
    act = _act(cfg)
    if is_dtensor(x) or is_dtensor(p["moe_w1"]):
        y = _routed_sharded(p, xt, cfg)
    else:
        y = _routed(p, xt, cfg)
    if cfg.n_shared_experts:
        h = xt @ p["shared_w1"]
        h = act(h) * (xt @ p["shared_w3"]) if glu else act(h)
        y = y + h @ p["shared_w2"]
    return hint(y.reshape(b, s, d), "residual")


def _routed(p: dict, xt, cfg: ModelConfig, prior_of=None, t_all=None, first: int = 0):
    """The routed experts' gated sum (T, D) for tokens ``xt`` (T, D), with
    the expert shards ``first``, ``first + 1``, ... that ``p``'s expert
    weights hold (all of them by default)."""
    t, d = xt.shape
    glu = cfg.activation in ("swiglu", "geglu")
    act = _act(cfg)
    with torch.profiler.record_function("moe.routing"):
        _, _, slots, slot_gates = route(p, xt, cfg, prior_of, t_all)
        e_here = p["moe_w1"].shape[0]
        if e_here != slots.shape[0]:
            slots = slots[first:first + e_here]
            slot_gates = slot_gates[first:first + e_here]
        counts = _DROPPED.get()
        if counts is not None:
            counts.append(t * cfg.top_k - (slots < t).sum())
        # capacity overflow and empty slots gather row T and add nothing
        xpad = torch.cat([xt, xt.new_zeros((1, d))], dim=0)
    e_shards = slots.shape[0]
    y = xt.new_zeros((t + 1, d))
    for j in range(slots.shape[1]):  # JAX's scan over the local experts
        sel = slots[:, j]  # (Es, cap)
        with torch.profiler.record_function("moe.routing"):
            xe = xpad[sel]  # (Es, cap, D)
        with torch.profiler.record_function("moe.experts"):
            h = torch.bmm(xe, p["moe_w1"][:, j])
            if glu:
                h = act(h) * torch.bmm(xe, p["moe_w3"][:, j])
            elif cfg.activation == "squared_relu":
                r = F.relu(h)
                h = r * r
            else:
                h = act(h)
            out = torch.bmm(h, p["moe_w2"][:, j])  # (Es, cap, D)
        with torch.profiler.record_function("moe.routing"):
            out = out * slot_gates[:, j, :, None].to(out.dtype)
            # row T, the pad, takes the empty slots' zeros
            table = out.new_zeros((e_shards, t + 1, d))
            table.scatter_(1, sel[..., None].expand(-1, -1, d), out)
            y = y + (table[0] if e_shards == 1 else table.sum(0))
    return y[:t]


def _routed_sharded(p: dict, xt, cfg: ModelConfig):
    """``_routed`` on DTensors: each rank routes its data shard of the
    tokens against the whole capacity and runs its ``model`` shard of the
    experts; the result is split as the tokens on the data axes and a
    pending sum (``Partial``) on the others."""
    import torch.distributed._functional_collectives as funcol
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    w1 = p["moe_w1"]
    mesh = (xt if is_dtensor(xt) else w1).device_mesh
    whole = [Replicate()] * mesh.ndim
    xt = local.on_mesh(xt, mesh)
    # the tokens stay split on the batch axes only: the experts split on
    # the model axis
    split = [isinstance(pl, Shard) and pl.dim == 0 and name in batch_axes(mesh.mesh_dim_names)
             for pl, name in zip(xt.placements, mesh.mesh_dim_names)]
    data_dims = [d for d, sp in enumerate(split) if sp]
    coord = mesh.get_coordinate()
    shard = 0
    for d in data_dims:
        shard = shard * mesh.size(d) + coord[d]
    names = ["moe_w1", "moe_w2"] + (["moe_w3"] if "moe_w3" in p else [])
    ws = [local.on_mesh(p[n], mesh) for n in names]
    w_pl = tuple(pl if isinstance(pl, Shard) else Replicate() for pl in ws[0].placements)
    experts = [isinstance(pl, Shard) for pl in w_pl]
    # per mesh dimension: the tokens split (their rows and their outputs
    # split, every weight's gradient a sum), the experts split (the
    # outputs and the tokens' and router's gradients sums), or neither
    # (all whole)
    def per_dim(tokens, experts_, neither):
        return [tokens if sp else experts_ if ex else neither
                for sp, ex in zip(split, experts)]

    x_pl, x_grad = per_dim(Shard(0), Replicate(), Replicate()), \
        per_dim(Shard(0), Partial(), Replicate())
    r_grad = per_dim(Partial(), Partial(), Replicate())
    w_grad = tuple(Partial() if sp else pl if ex else Replicate()
                   for sp, ex, pl in zip(split, experts, w_pl))
    off = global_offset(tuple(ws[0].shape), w_pl, mesh)
    t_all, n_exp = xt.shape[0], cfg.n_experts

    def prior_of(ids):
        flat = ids.reshape(-1)
        counts = flat.new_zeros(n_exp).scatter_add_(0, flat, torch.ones_like(flat))[None]
        for d in reversed(data_dims):  # the major axis gathered last
            counts = funcol.all_gather_tensor(counts, 0, (mesh, d))
        before = counts[:shard].sum(0) if shard else torch.zeros_like(counts[0])
        return before.reshape(expert_shards(cfg), -1)

    n_split = 1  # the shards of the work: the tokens' and the experts'
    for d in range(mesh.ndim):
        n_split *= mesh.size(d) if split[d] or experts[d] else 1

    def body(x_l, router, *w_l):
        with local.split_work(n_split):
            return _routed(dict(zip(["router", *names], [router, *w_l])), x_l, cfg,
                           prior_of if data_dims else None, t_all, first=off[0])

    fn = local_map(body, out_placements=per_dim(Shard(0), Partial(), Replicate()),
                   in_placements=(tuple(x_pl), tuple(whole), *[w_pl] * len(ws)),
                   in_grad_placements=(tuple(x_grad), tuple(r_grad), *[w_grad] * len(ws)),
                   device_mesh=mesh, redistribute_inputs=True)
    return fn(xt, local.on_mesh(p["router"], mesh), *ws)
