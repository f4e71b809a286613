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


def route(p: dict, xt, cfg: ModelConfig):
    """xt: (T, D) -> (gates (T, k) in xt's dtype, ids (T, k), slots (Es, El,
    cap) token index per slot, T where empty, slot gates (Es, El, cap))."""
    t = xt.shape[0]
    k = cfg.top_k
    e_shards, e_local = p["moe_w1"].shape[:2]
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
    slots = torch.topk(prio, capacity(cfg, t), dim=-1, largest=False).values
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
    xt = x.reshape(t, d)
    glu = cfg.activation in ("swiglu", "geglu")
    act = _act(cfg)
    with torch.profiler.record_function("moe.routing"):
        _, _, slots, slot_gates = route(p, xt, cfg)
        counts = _DROPPED.get()
        if counts is not None:
            counts.append(t * cfg.top_k - (slots < t).sum())
        # capacity overflow and empty slots gather row T and add nothing
        xpad = torch.cat([xt, xt.new_zeros((1, d))], dim=0)
    e_shards = slots.shape[0]
    y = x.new_zeros((t + 1, d))
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
    y = y[:t]
    if cfg.n_shared_experts:
        h = xt @ p["shared_w1"]
        h = act(h) * (xt @ p["shared_w3"]) if glu else act(h)
        y = y + h @ p["shared_w2"]
    return y.reshape(b, s, d)
