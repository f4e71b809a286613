"""Plain PyTorch versions of one-token GQA attention over a KV cache.

``decode_attention_ref`` has the arithmetic of the JAX package's jnp oracle
(``repro/kernels/decode_attn/ref.py::decode_attention_ref``): q is scaled
in f32 and cast back to its dtype, logits accumulate in f32, and p is cast
to v's dtype before the product with v.  The CUDA kernel keeps p in f32,
as the Pallas kernel does, so in bf16 the two differ as the JAX kernel and
its oracle do.  ``ops`` takes this version for tensors on the CPU.
``decode_tiled_ref`` (the bf16 instance: the prefill kernel's tile steps
over the cache) and ``decode_chunked_ref`` (the f32 instance: partials per
chunk of cache slots, then their combine) repeat the CUDA kernel's own
arithmetic, so that the CPU tests can hold it to the other two; nothing on
the serving path calls them."""
from __future__ import annotations

import torch

from ..flash_attn.ref import tiled_attention


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


def decode_chunked_ref(q, k, v, pos, scale: float | None = None, chunk: int = 32):
    """``decode_attention_ref``'s function with the arithmetic of
    ``csrc/decode_attn.cu``: for each chunk of ``chunk`` cache slots that
    starts below min(pos_b, S), a partial (acc, m, l) in f32 over q scaled
    in f32 (slots at or past pos read as 0 and masked with -1e30); then the
    live partials of each row combined in chunk order, m* = max m_i, out =
    sum acc_i exp(m_i - m*) / max(sum l_i exp(m_i - m*), 1e-30) (the kernel
    sums the l terms over a shuffle tree: the same terms, another order).
    A row with pos <= 0 gives zeros.  Returns (B, H, Dh) in q's dtype."""
    b, h, dh = q.shape
    hkv, s = k.shape[1], k.shape[2]
    group = h // hkv
    scale = scale if scale is not None else dh ** -0.5
    qf = (q.to(torch.float32) * scale).reshape(b, hkv, group, dh)
    n = pos.to(q.device).to(torch.int64).clamp(max=s)
    ms, ls, accs, lives = [], [], [], []
    for c0 in range(0, s, chunk):
        slots = c0 + torch.arange(min(chunk, s - c0), device=q.device)
        inside = (slots[None, :] < n[:, None])[:, None, :, None]  # (B, 1, C, 1)
        kc = torch.where(inside, k[:, :, c0:c0 + chunk].to(torch.float32), 0.0)
        vc = torch.where(inside, v[:, :, c0:c0 + chunk].to(torch.float32), 0.0)
        logits = torch.einsum("bkgd,bksd->bkgs", qf, kc)
        logits = logits.masked_fill(~inside[..., 0][:, :, None, :], -1e30)
        m = logits.amax(dim=-1, keepdim=True)
        p = torch.exp(logits - m)
        ms.append(m)
        ls.append(p.sum(dim=-1, keepdim=True))
        accs.append(torch.einsum("bkgs,bksd->bkgd", p, vc))
        lives.append((c0 < n)[:, None, None, None])
    live = torch.stack(lives)  # (chunks, B, 1, 1, 1)
    m = torch.where(live, torch.stack(ms), -torch.inf)
    m_star = m.amax(dim=0)
    w = torch.where(live, torch.exp(m - m_star), 0.0)
    l = torch.zeros_like(ls[0])
    acc = torch.zeros_like(accs[0])
    for i in range(len(accs)):  # chunk order, as the kernel's combine
        l = l + torch.where(live[i], ls[i] * w[i], 0.0)
        acc = acc + torch.where(live[i], accs[i] * w[i], 0.0)
    return (acc / l.clamp_min(1e-30)).reshape(b, h, dh).to(q.dtype)


def decode_tiled_ref(q, k, v, pos, scale: float | None = None, block_k: int = 64):
    """``decode_attention_ref``'s function with the arithmetic of the bf16
    instance of ``csrc/decode_attn.cu``: each head's query row through the
    prefill kernel's tile steps (``flash_attn.ref.tiled_attention``) over
    the first min(pos_b, S) cache slots, slots at or past it read as 0 and
    masked.  A row with pos <= 0 gives zeros.  Returns (B, H, Dh) in q's
    dtype."""
    s = k.shape[2]
    n = pos.to(q.device).to(torch.int64).clamp(max=s)[:, None, None, None]
    inside = torch.arange(s, device=q.device)[None, None, :, None] < n
    k, v = (torch.where(inside, t, torch.zeros((), dtype=t.dtype)) for t in (k, v))
    out = tiled_attention(q[:, :, None], k, v, n, scale, block_k)[:, :, 0]
    return torch.where(n[..., 0] > 0, out, torch.zeros((), dtype=out.dtype))
