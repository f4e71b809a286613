"""The plain reference of the dense transformer family (the registry's
``kind: dense``, e.g. ``canonicalizer-100m``): full-sequence logits in
float32, plain torch, TF32 off, no kernel, cache or batching.

``forward(cfg, params, tokens)``: ``cfg`` a dict of the architecture's
sizes and switches (``n_heads``, ``kv_heads``, ``head_dim``, ``qk_norm``,
``rope_theta``, ``rope_fraction``, ``activation``, ``tie_embeddings``,
``name``), ``params`` the benchmark's drawn weights in the served dtype
(upcast to float32 one layer at a time), ``tokens`` (B, S) ids, all rows
real (no padding).  Returns logits (B, S, V) in float32.

The block, as the family is defined: pre-norm residual blocks
``x + attn(rmsnorm(x))`` and ``x + mlp(rmsnorm(x))``; RMS norm with
epsilon 1e-6 scaled by ``1 + w``; grouped-query attention, query head
``h`` reading key/value head ``h // (n_heads / kv_heads)``, causal,
scaled by ``head_dim ** -0.5``, with an optional RMS norm of each query
and key head before the rotary embedding; rotary embedding on interleaved
pairs ``(x[2i], x[2i+1])`` at angle ``pos * theta ** (-2i / rot)`` over
the first ``rot`` channels (``rot`` = ``head_dim * rope_fraction``,
rounded down to even); SwiGLU ``(silu(x W1) * (x W3)) W2`` (or GeGLU,
squared ReLU, GELU); a final RMS norm and the output head (the embedding's
transpose where tied).  Gemma's embedding is scaled by ``sqrt(d_model)``.
Imports nothing of the port and no JAX.
"""
from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F

EPS = 1e-6


@contextlib.contextmanager
def no_tf32():
    """float32 products in float32: TF32 off for the block, as it was after."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def rmsnorm(x, w):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + EPS) * (1.0 + w.float())


def rope(x, positions, theta: float, fraction: float):
    """x (B, S, H, Dh): interleaved pairs of the first ``rot`` channels
    rotated by their position's angle."""
    dh = x.shape[-1]
    rot = int(dh * fraction) // 2 * 2
    inv = theta ** (-torch.arange(0, rot, 2, dtype=torch.float32, device=x.device) / rot)
    ang = positions.float()[:, None] * inv  # (S, rot/2)
    cos, sin = torch.cos(ang)[None, :, None], torch.sin(ang)[None, :, None]
    x1, x2 = x[..., 0:rot:2], x[..., 1:rot:2]
    out = x.clone()
    out[..., 0:rot:2] = x1 * cos - x2 * sin
    out[..., 1:rot:2] = x2 * cos + x1 * sin
    return out


def attention(cfg: dict, p: dict, x):
    b, s, _ = x.shape
    h, hkv, dh = cfg["n_heads"], cfg["kv_heads"], cfg["head_dim"]
    q = (x @ p["wq"].float()).view(b, s, h, dh)
    k = (x @ p["wk"].float()).view(b, s, hkv, dh)
    v = (x @ p["wv"].float()).view(b, s, hkv, dh)
    if cfg["qk_norm"]:
        q, k = rmsnorm(q, p["q_norm"]), rmsnorm(k, p["k_norm"])
    pos = torch.arange(s, device=x.device)
    q = rope(q, pos, cfg["rope_theta"], cfg["rope_fraction"]).transpose(1, 2)
    k = rope(k, pos, cfg["rope_theta"], cfg["rope_fraction"]).transpose(1, 2)
    v = v.transpose(1, 2)
    k = k.repeat_interleave(h // hkv, dim=1)
    v = v.repeat_interleave(h // hkv, dim=1)
    scores = (q @ k.transpose(-1, -2)) / math.sqrt(dh)
    causal = torch.ones(s, s, dtype=torch.bool, device=x.device).tril()
    scores = scores.masked_fill(~causal, float("-inf"))
    out = torch.softmax(scores, dim=-1) @ v  # (B, H, S, Dh)
    return out.transpose(1, 2).reshape(b, s, h * dh) @ p["wo"].float()


def mlp(activation: str, p: dict, x):
    a = x @ p["mlp_w1"].float()
    if activation == "swiglu":
        a = F.silu(a) * (x @ p["mlp_w3"].float())
    elif activation == "geglu":
        a = F.gelu(a, approximate="tanh") * (x @ p["mlp_w3"].float())
    elif activation == "squared_relu":
        a = F.relu(a) ** 2
    elif activation == "gelu":
        a = F.gelu(a, approximate="tanh")
    else:
        raise ValueError(f"unknown activation {activation!r}")
    return a @ p["mlp_w2"].float()


def forward(cfg: dict, params: dict, tokens):
    """Logits (B, S, V) in float32 of ``tokens`` (B, S)."""
    with no_tf32():
        x = params["embed"][tokens.long()].float()
        if cfg["name"].startswith("gemma"):
            x = x * math.sqrt(x.shape[-1])
        for lp in params.get("dense_layers", []) + params["layers"]:
            if "mlp_w1" not in lp:
                raise ValueError("the dense reference has no expert layer")
            x = x + attention(cfg, lp, rmsnorm(x, lp["ln1"]))
            x = x + mlp(cfg["activation"], lp, rmsnorm(x, lp["ln2"]))
        x = rmsnorm(x, params["final_norm"])
        head = params["embed"].T if cfg["tie_embeddings"] else params["lm_head"]
        return x @ head.float()
