"""Plain PyTorch version of one-token GQA attention over a KV cache, with the
arithmetic of the JAX package's jnp oracle (``repro/kernels/decode_attn/
ref.py::decode_attention_ref``): q is scaled in f32 and cast back to its
dtype, logits accumulate in f32, and p is cast to v's dtype before the
product with v.  The CUDA kernel keeps p in f32, as the Pallas kernel does,
so in bf16 the two differ as the JAX kernel and its oracle do.  ``ops``
takes this version for tensors on the CPU."""
from __future__ import annotations

import torch


def decode_attention_ref(q, k, v, pos, scale: float | None = None):
    """q: (B, H, Dh); k, v: (B, Hkv, S, Dh); pos: (B,) valid cache lengths.

    Attends to cache positions [0, pos_b) per batch row.  Returns (B, H, Dh)."""
    b, h, dh = q.shape
    hkv, s = k.shape[1], k.shape[2]
    group = h // hkv
    scale = scale if scale is not None else dh ** -0.5
    qg = (q.to(torch.float32) * scale).reshape(b, hkv, group, dh).to(q.dtype)
    logits = torch.einsum("bkgd,bksd->bkgs", qg.to(torch.float32),
                          k.to(torch.float32))  # (B, Hkv, G, S)
    mask = torch.arange(s, device=q.device)[None, None, None, :] \
        < pos.to(q.device)[:, None, None, None]
    logits = logits.masked_fill(~mask, float("-inf"))
    p = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    p = p / p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bkgs,bksd->bkgd", p.to(v.dtype).to(torch.float32),
                       v.to(torch.float32))
    return out.reshape(b, h, dh).to(q.dtype)
