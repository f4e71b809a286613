"""Shared model layers: norms, RoPE, GQA attention, GLU MLPs.

Plain functions over dicts of parameters, with the arithmetic of the JAX
package's ``repro/models/layers.py``.  Projection matrices keep JAX's
``x @ W`` layout: (d_in, d_out).  Attention calls the two attention kernels
through their dispatchers: ``flash_attention`` in prefill and
``decode_attention`` in each decode step (CUDA tensors launch the
hand-written kernels, CPU tensors take the plain versions).

The activation hints of the JAX package (``distributed.sharding.hint``)
stand where JAX's do; with no hint context they return their input.  On
DTensors (a model sharded on a ``DeviceMesh``) a projection whose output
is split into heads is first laid out whole per head (``_heads``), and the
decode step writes each rank's cache shard in place (``_write_slot``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..distributed.sharding import hint, is_dtensor
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


def _heads(t, n: int, shape: tuple):
    """``t.reshape(shape)``, where ``shape`` splits ``t``'s last dimension
    into ``n`` heads.  A DTensor split on that dimension by a mesh
    dimension whose size does not divide ``n`` is first gathered whole on
    it: a shard would hold part of a head."""
    if is_dtensor(t):
        from torch.distributed.tensor import Replicate, Shard

        pls = [Replicate() if isinstance(pl, Shard) and pl.dim % t.dim() == t.dim() - 1
               and n % t.device_mesh.size(d) else pl
               for d, pl in enumerate(t.placements)]
        if pls != list(t.placements):
            t = t.redistribute(t.device_mesh, pls)
    return t.reshape(shape)


def _write_slot(cache, new, idx):
    """cache (B, Hkv, Smax, Dh)[b, :, idx[b]] = new[b], in place.  A slot at
    or past Smax is not written: the JAX package's scatter drops it.  A
    DTensor cache is written shard by shard: ``new`` and ``idx`` are laid
    out as the cache's batch and heads, and a shard of cache slots takes
    the rows whose slot falls in it."""
    if is_dtensor(cache):
        return _write_slot_sharded(cache, new, idx)
    _write_slot_local(cache, new, idx, 0)


def _write_slot_local(cache, new, idx, offset: int):
    smax = cache.shape[2]
    rows = torch.arange(cache.shape[0], device=cache.device)
    slot = (idx - offset).clamp(min=0, max=smax - 1).long()
    keep = ((idx >= offset) & (idx < offset + smax))[:, None, None]
    cache[rows, :, slot] = torch.where(keep, new.to(cache.dtype), cache[rows, :, slot])


def _write_slot_sharded(cache, new, idx):
    from torch.distributed.tensor import DTensor, Replicate, Shard

    from ..distributed.sharding import global_offset

    mesh, pls = cache.device_mesh, cache.placements

    def local(t, keep_dims):
        if not is_dtensor(t):
            t = DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim, run_check=False)
        want = [pl if isinstance(pl, Shard) and pl.dim in keep_dims else Replicate()
                for pl in pls]
        return t.redistribute(mesh, want).to_local()

    offset = global_offset(tuple(cache.shape), pls, mesh)
    _write_slot_local(cache.to_local(), local(new, (0, 1)), local(idx, (0,)), offset[2])


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
    q = _heads(x @ p["wq"], n_heads, (b, s, n_heads, head_dim))
    k = _heads(x @ p["wk"], kv_heads, (b, s, kv_heads, head_dim))
    v = _heads(x @ p["wv"], kv_heads, (b, s, kv_heads, head_dim))
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
        qh = hint(q.transpose(1, 2), "attn_heads")  # (B, H, S, Dh)
        kh, vh = k.transpose(1, 2), v.transpose(1, 2)
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
    h = hint(h, "mlp_hidden")
    return h @ p["w2"]
