"""Dispatching wrapper for causal GQA attention: CUDA tensors go to the
hand-written kernel (``kernel.py``), CPU tensors to the plain version
(``ref.py``).  There is no switch that sends CUDA tensors to the plain
version."""
from __future__ import annotations

from ..binding import on_cuda
from . import kernel, ref


def flash_attention(q, k, v, causal: bool = True, scale: float | None = None):
    """q: (B, H, S, Dh); k, v: (B, Hkv, S, Dh) -> (B, H, S, Dh)."""
    if on_cuda("flash_attention", q, k, v):
        return kernel.flash_attention_cuda(q.contiguous(), k.contiguous(),
                                           v.contiguous(), causal, scale)
    return ref.mha_ref(q, k, v, causal=causal, scale=scale)
