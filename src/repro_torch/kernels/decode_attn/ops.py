"""Dispatching wrapper for KV-cache decode attention: CUDA tensors go to the
hand-written kernel (``kernel.py``), CPU tensors to the plain version
(``ref.py``).  There is no switch that sends CUDA tensors to the plain
version."""
from __future__ import annotations

import torch

from ..binding import on_cuda
from . import kernel, ref


def decode_attention(q, k, v, pos, scale: float | None = None):
    """q: (B, H, Dh); k, v: (B, Hkv, S, Dh); pos: (B,) -> (B, H, Dh)."""
    if on_cuda("decode_attention", q, k, v, pos):
        return kernel.decode_attention_cuda(
            q.contiguous(), k.contiguous(), v.contiguous(),
            pos.to(torch.int32).contiguous(), scale)
    return ref.decode_attention_ref(q, k, v, pos, scale=scale)
