"""Shared model layers: norms, RoPE, GQA attention, GLU MLPs.

Plain functions over dicts of parameters, with the arithmetic of the JAX
package's ``repro/models/layers.py``.  Projection matrices keep JAX's
``x @ W`` layout: (d_in, d_out).  Attention calls the two attention kernels
through their dispatchers: ``flash_attention`` in prefill and
``decode_attention`` in each decode step (CUDA tensors launch the
hand-written kernels, CPU tensors take the plain versions).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..kernels.decode_attn.ops import decode_attention
from ..kernels.flash_attn.ops import flash_attention


def rmsnorm(x, w, eps: float = 1e-6):
    """RMS norm computed in f32, scaled by (1 + w), cast back to x's dtype."""
    xf = x.to(torch.float32)
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * (1.0 + w.to(torch.float32))).to(x.dtype)


# ------------------------------------------------------------------- rotary


def rope_angles(positions, head_dim: int, theta: float, fraction: float = 1.0):
    """positions: (...,) -> (cos, sin) of shape (..., rot/2)."""
    rot = int(head_dim * fraction) // 2 * 2
    exponent = torch.arange(0, rot, 2, dtype=torch.float32, device=positions.device) / rot
    inv = 1.0 / (theta ** exponent)
    ang = positions.to(torch.float32)[..., None] * inv  # (..., rot/2)
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x, cos, sin, fraction: float = 1.0):
    """x: (B, S, H, Dh); cos/sin: (B, S, rot/2) or (S, rot/2).  Rotates
    interleaved pairs (x[..., 0::2], x[..., 1::2]); with a partial rotary
    fraction the tail past ``rot`` is left as it is."""
    dh = x.shape[-1]
    rot = int(dh * fraction) // 2 * 2
    xr, xp = x[..., :rot], x[..., rot:]
    x1, x2 = xr[..., ::2], xr[..., 1::2]
    if cos.dim() == 2:
        cos, sin = cos[None, :, None, :], sin[None, :, None, :]
    else:
        cos, sin = cos[:, :, None, :], sin[:, :, None, :]
    y1 = x1 * cos - x2 * sin
    y2 = x2 * cos + x1 * sin
    yr = torch.stack([y1, y2], dim=-1).reshape(xr.shape)
    if rot < dh:
        return torch.cat([yr, xp.to(yr.dtype)], dim=-1).to(x.dtype)
    return yr.to(x.dtype)


# ---------------------------------------------------------------- attention


def attn_param_shapes(d_model: int, n_heads: int, kv_heads: int, head_dim: int,
                      qk_norm: bool) -> dict:
    shapes = {
        "wq": (d_model, n_heads * head_dim),
        "wk": (d_model, kv_heads * head_dim),
        "wv": (d_model, kv_heads * head_dim),
        "wo": (n_heads * head_dim, d_model),
    }
    if qk_norm:
        shapes["q_norm"] = (head_dim,)
        shapes["k_norm"] = (head_dim,)
    return shapes


def _write_slot(cache, new, idx):
    """cache (B, Hkv, Smax, Dh)[b, :, idx[b]] = new[b], in place.  A slot at
    or past Smax is not written: the JAX package's scatter drops it."""
    smax = cache.shape[2]
    rows = torch.arange(cache.shape[0], device=cache.device)
    slot = idx.clamp(max=smax - 1).long()
    keep = (idx < smax)[:, None, None]
    cache[rows, :, slot] = torch.where(keep, new.to(cache.dtype), cache[rows, :, slot])


def attention(p, x, *, n_heads, kv_heads, head_dim, qk_norm=False,
              rope_theta=1e4, rope_fraction=1.0, positions=None,
              kv_cache=None, cache_pos=None):
    """GQA attention.

    Prefill: x (B, S, D), kv_cache None -> (out, (k, v)) with k/v
    (B, Hkv, S, Dh) for seeding the cache.  Queries take RoPE positions
    0..S-1 and attend causally to every earlier position, pads included.
    Decode: x (B, 1, D), kv_cache = (k, v) preallocated (B, Hkv, Smax, Dh),
    cache_pos (B,) current lengths -> (out, the same cache), the new K/V
    written in place at ``cache_pos``.
    """
    b, s, _ = x.shape
    q = (x @ p["wq"]).reshape(b, s, n_heads, head_dim)
    k = (x @ p["wk"]).reshape(b, s, kv_heads, head_dim)
    v = (x @ p["wv"]).reshape(b, s, kv_heads, head_dim)
    if qk_norm:
        q = rmsnorm(q, p["q_norm"])
        k = rmsnorm(k, p["k_norm"])
    if positions is None:
        positions = (torch.arange(s, device=x.device)[None, :] if cache_pos is None
                     else cache_pos[:, None])
    cos, sin = rope_angles(positions, head_dim, rope_theta, rope_fraction)
    q = apply_rope(q, cos, sin, rope_fraction)
    k = apply_rope(k, cos, sin, rope_fraction)

    if kv_cache is None:
        qh, kh, vh = (t.transpose(1, 2) for t in (q, k, v))  # (B, H, S, Dh)
        out = flash_attention(qh, kh, vh, causal=True)
        out = out.transpose(1, 2).reshape(b, s, n_heads * head_dim)
        return out @ p["wo"], (kh, vh)

    ck, cv = kv_cache
    _write_slot(ck, k.reshape(b, kv_heads, head_dim), cache_pos)
    _write_slot(cv, v.reshape(b, kv_heads, head_dim), cache_pos)
    out = decode_attention(q.reshape(b, n_heads, head_dim), ck, cv, cache_pos + 1)
    return out.reshape(b, 1, n_heads * head_dim) @ p["wo"], (ck, cv)


# --------------------------------------------------------------------- MLPs


def mlp_param_shapes(d_model: int, d_ff: int, activation: str) -> dict:
    if activation in ("swiglu", "geglu"):
        return {"w1": (d_model, d_ff), "w3": (d_model, d_ff), "w2": (d_ff, d_model)}
    return {"w1": (d_model, d_ff), "w2": (d_ff, d_model)}  # squared_relu / gelu


def mlp(p, x, activation: str):
    """GLU or plain MLP; gelu is the tanh approximation (jax.nn.gelu's)."""
    h = x @ p["w1"]
    if activation == "swiglu":
        h = F.silu(h) * (x @ p["w3"])
    elif activation == "geglu":
        h = F.gelu(h, approximate="tanh") * (x @ p["w3"])
    elif activation == "squared_relu":
        r = F.relu(h)
        h = r * r
    elif activation == "gelu":
        h = F.gelu(h, approximate="tanh")
    else:
        raise ValueError(f"unknown activation {activation!r}")
    return h @ p["w2"]
