"""Plain PyTorch version of causal GQA attention (prefill path), with the
arithmetic of the JAX package's jnp oracle (``repro/kernels/flash_attn/
ref.py::mha_ref``): everything in f32, one cast to q's dtype at the end.
``ops`` takes it for tensors on the CPU; the CUDA kernel is held against it
on the card."""
from __future__ import annotations

import torch


def mha_ref(q, k, v, causal: bool = True, scale: float | None = None):
    """q: (B, H, S, Dh); k, v: (B, Hkv, S, Dh) with H % Hkv == 0.

    Returns (B, H, S, Dh) in q's dtype; query head h reads KV head
    h // (H // Hkv)."""
    b, h, s, dh = q.shape
    group = h // k.shape[1]
    scale = scale if scale is not None else dh ** -0.5
    qf = q.to(torch.float32) * scale
    kf = k.to(torch.float32).repeat_interleave(group, dim=1)
    vf = v.to(torch.float32).repeat_interleave(group, dim=1)
    logits = torch.einsum("bhqd,bhkd->bhqk", qf, kf)
    if causal:
        mask = torch.ones((s, s), dtype=torch.bool, device=q.device).tril()
        logits = logits.masked_fill(~mask, float("-inf"))
    p = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    p = p / p.sum(dim=-1, keepdim=True)
    return torch.einsum("bhqk,bhkd->bhqd", p, vf).to(q.dtype)
