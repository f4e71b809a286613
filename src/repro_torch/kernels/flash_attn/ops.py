"""Dispatching wrapper for causal GQA attention: CUDA tensors go to the
hand-written kernels (``kernel.py``), CPU tensors to the plain version
(``ref.py``).  There is no switch that sends CUDA tensors to the plain
version.

On CUDA, where grad is enabled and an input requires it, the call goes
through :class:`FlashAttention`, whose forward launches the forward kernel
and whose backward launches the backward kernel; otherwise (the serving
engine runs under ``torch.inference_mode``) it launches the forward
kernel alone.  CPU tensors take ``mha_ref`` under autograd."""
from __future__ import annotations

import torch

from ..binding import on_cuda
from . import kernel, ref


class FlashAttention(torch.autograd.Function):
    """Causal GQA attention on the card with its gradient: forward
    ``kernel.flash_attention_cuda`` (saving q, k, v and the output),
    backward ``kernel.flash_attention_bwd_cuda``."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, scale):
        out = kernel.flash_attention_cuda(q, k, v, causal, scale)
        ctx.save_for_backward(q, k, v, out)
        ctx.causal, ctx.scale = causal, scale
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out = ctx.saved_tensors
        dq, dk, dv = kernel.flash_attention_bwd_cuda(q, k, v, out, dout.contiguous(),
                                                     ctx.causal, ctx.scale)
        return dq, dk, dv, None, None


def flash_attention(q, k, v, causal: bool = True, scale: float | None = None):
    """q: (B, H, S, Dh); k, v: (B, Hkv, S, Dh) -> (B, H, S, Dh)."""
    if on_cuda("flash_attention", q, k, v):
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                        or v.requires_grad):
            return FlashAttention.apply(q, k, v, causal, scale)
        return kernel.flash_attention_cuda(q, k, v, causal, scale)
    return ref.mha_ref(q, k, v, causal=causal, scale=scale)
