"""Plain PyTorch versions of causal GQA attention (prefill path).

``mha_ref`` has the arithmetic of the JAX package's jnp oracle
(``repro/kernels/flash_attn/ref.py::mha_ref``): everything in f32, one cast
to q's dtype at the end.  ``ops`` takes it for tensors on the CPU; the CUDA
kernel is held against it on the card.  ``flash_tiled_ref`` repeats the
CUDA kernel's own arithmetic tile by tile (``tiled_attention``, which the
bf16 decode kernel shares), so that the CPU tests can hold that arithmetic
to ``mha_ref`` and to the Pallas kernel; nothing on the serving path calls
it.  ``mha_bwd_ref`` is the gradient of ``mha_ref``, written out: the
plain version of the backward kernel (``csrc/flash_attn_bwd.cu``), which
``ops.FlashAttention`` launches on the card."""
from __future__ import annotations

import math

import torch

LOG2E = 1.0 / math.log(2.0)


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


def mha_bwd_ref(q, k, v, do, causal: bool = True, scale: float | None = None):
    """The gradient of ``mha_ref`` at (q, k, v) for the output gradient
    ``do``: (dq, dk, dv) in the inputs' dtypes.  P is recomputed in f32,
    dV = P^T dO, dP = dO V^T, dS = P * (dP - rowsum(dO * O)), dQ = scale
    dS K, dK = dS^T (scale q); dK and dV sum over each KV head's group of
    query heads.  All in f32 and cast once, as autograd of ``mha_ref``'s
    f32 arithmetic and final cast gives."""
    b, h, s, dh = q.shape
    hkv = k.shape[1]
    group = h // hkv
    scale = scale if scale is not None else dh ** -0.5
    qf = q.to(torch.float32) * scale
    kf = k.to(torch.float32).repeat_interleave(group, dim=1)
    vf = v.to(torch.float32).repeat_interleave(group, dim=1)
    dof = do.to(torch.float32)
    logits = qf @ kf.transpose(-1, -2)
    if causal:
        mask = torch.ones((s, s), dtype=torch.bool, device=q.device).tril()
        logits = logits.masked_fill(~mask, float("-inf"))
    p = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    p = p / p.sum(dim=-1, keepdim=True)
    o = p @ vf
    dv = p.transpose(-1, -2) @ dof
    ds = p * (dof @ vf.transpose(-1, -2) - (dof * o).sum(dim=-1, keepdim=True))
    dq = (ds @ kf) * scale
    dk = ds.transpose(-1, -2) @ qf

    def per_kv_head(t):
        return t.reshape(b, hkv, group, s, dh).sum(dim=2)

    return dq.to(q.dtype), per_kv_head(dk).to(k.dtype), per_kv_head(dv).to(v.dtype)


def flash_tiled_ref(q, k, v, causal: bool = True, scale: float | None = None,
                    block_k: int = 64):
    """``mha_ref``'s function with the arithmetic of ``csrc/flash_attn.cu``
    (see ``tiled_attention``).  Returns q's dtype."""
    s = q.shape[2]
    rows = torch.arange(s, device=q.device)[:, None]
    return tiled_attention(q, k, v, rows + 1 if causal else torch.full_like(rows, s),
                           scale, block_k)


def tiled_attention(q, k, v, kmax, scale: float | None = None, block_k: int = 64):
    """q: (B, H, Sq, Dh); k, v: (B, Hkv, Sk, Dh); query row i attends to keys
    [0, kmax[..., i, 0]) (kmax broadcasts against (B, H, Sq, 1)), with the
    CUDA kernels' arithmetic: an online softmax over tiles of ``block_k``
    keys, f32 logits, running max, denominator and accumulator.

    bfloat16 inputs take the tensor-core steps (``kernels/csrc/
    attn_tile.cuh``, shared by the prefill and the bf16 decode kernel):
    logits are the bf16 products (exact in f32) summed in f32 and scaled
    after the product by scale * log2(e), so p = exp2(s - m); p is split
    into hi = bf16(p) and lo = bf16(p - hi), and hi v + lo v go into the
    f32 accumulator.  float32 inputs take the prefill kernel's CUDA-core
    steps: q scaled before the product, p kept in f32.  Returns q's
    dtype."""
    b, h, sq, dh = q.shape
    group = h // k.shape[1]
    scale = scale if scale is not None else dh ** -0.5
    bf16 = q.dtype == torch.bfloat16
    qf = q.to(torch.float32) if bf16 else q.to(torch.float32) * scale
    kf = k.to(torch.float32).repeat_interleave(group, dim=1)
    vf = v.to(torch.float32).repeat_interleave(group, dim=1)
    exp = torch.exp2 if bf16 else torch.exp
    m = torch.full((b, h, sq, 1), -1e30, device=q.device)
    l = torch.zeros((b, h, sq, 1), device=q.device)
    acc = torch.zeros((b, h, sq, dh), device=q.device)
    for t0 in range(0, k.shape[2], block_k):
        kt, vt = kf[:, :, t0:t0 + block_k], vf[:, :, t0:t0 + block_k]
        logits = qf @ kt.transpose(-1, -2)
        if bf16:
            logits = logits * (scale * LOG2E)
        cols = t0 + torch.arange(kt.shape[2], device=q.device)
        logits = logits.masked_fill(cols >= kmax, -1e30)
        m_new = torch.maximum(m, logits.amax(dim=-1, keepdim=True))
        p = exp(logits - m_new)
        alpha = exp(m - m_new)
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        if bf16:
            hi = p.to(torch.bfloat16).to(torch.float32)
            lo = (p - hi).to(torch.bfloat16).to(torch.float32)
            pv = hi @ vt + lo @ vt
        else:
            pv = p @ vt
        acc = acc * alpha + pv
        m = m_new
    return (acc / l.clamp_min(1e-30)).to(q.dtype)


def flash_bwd_tiled_ref(q, k, v, o, do, causal: bool = True, scale: float | None = None,
                        block: int | None = None):
    """``mha_bwd_ref``'s function with the arithmetic of ``csrc/
    flash_attn_bwd.cu``: every value widened to f32, q scaled before the
    products; each row's logsumexp by an online max and sum over tiles of
    ``block`` keys (64 up to head dim 128, else 32, as the kernel tiles);
    D = rowsum(dO * O) from the forward's output ``o`` as given (rounded
    to its dtype); P = exp(s - lse); dK, dV summed over the group and the
    query tiles in f32; one rounding to the inputs' dtype."""
    b, h, s, dh = q.shape
    hkv = k.shape[1]
    group = h // hkv
    scale = scale if scale is not None else dh ** -0.5
    block = block or (32 if dh > 128 else 64)
    qf = q.to(torch.float32) * scale
    kf = k.to(torch.float32).repeat_interleave(group, dim=1)
    vf = v.to(torch.float32).repeat_interleave(group, dim=1)
    dof = do.to(torch.float32)
    rows = torch.arange(s, device=q.device)[:, None]
    m = torch.full((b, h, s, 1), -1e30, device=q.device)
    l = torch.zeros((b, h, s, 1), device=q.device)
    for t0 in range(0, s, block):
        logits = qf @ kf[:, :, t0:t0 + block].transpose(-1, -2)
        cols = t0 + torch.arange(logits.shape[-1], device=q.device)
        if causal:
            logits = logits.masked_fill(cols > rows, -1e30)
        m_new = torch.maximum(m, logits.amax(dim=-1, keepdim=True))
        l = l * torch.exp(m - m_new) + torch.exp(logits - m_new).sum(dim=-1, keepdim=True)
        m = m_new
    lse = m + torch.log(l)
    d = (dof * o.to(torch.float32)).sum(dim=-1, keepdim=True)
    logits = qf @ kf.transpose(-1, -2)
    p = torch.exp(logits - lse)
    if causal:
        p = p.masked_fill(torch.arange(s, device=q.device) > rows, 0.0)
    ds = p * (dof @ vf.transpose(-1, -2) - d)
    dq = (ds @ kf) * scale
    dk = (ds.transpose(-1, -2) @ qf).reshape(b, hkv, group, s, dh).sum(dim=2)
    dv = (p.transpose(-1, -2) @ dof).reshape(b, hkv, group, s, dh).sum(dim=2)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)
