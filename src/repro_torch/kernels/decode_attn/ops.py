"""Dispatching wrapper for KV-cache decode attention: CUDA tensors go to the
hand-written kernel (``kernel.py``), CPU tensors to the plain version
(``ref.py``).  There is no switch that sends CUDA tensors to the plain
version.  DTensors go through ``distributed.local.call``, as the flash
wrapper's do: heads split on ``model``, batch on the data axes, a cache
split along its slots gathered whole first."""
from __future__ import annotations

import torch

from ...distributed import local
from ..binding import on_cuda, refuse_grad
from . import kernel, ref


def decode_attention(q, k, v, pos, scale: float | None = None):
    """q: (B, H, Dh); k, v: (B, Hkv, S, Dh); pos: (B,) -> (B, H, Dh)."""
    if local.any_dtensor(q, k, v, pos):
        n_heads, n_kv = q.shape[1], k.shape[1]

        def shard(start, ql, kl, vl, pl):
            kl, vl = local.gqa_slice(kl, vl, start, ql.shape[1], n_heads, n_kv)
            return decode_attention(ql, kl, vl, pl, scale)

        return local.call(shard, [local.Arg(q, 0, 1), local.Arg(k, 0, 1),
                                  local.Arg(v, 0, 1), local.Arg(pos, 0)], [(0, 1)])
    if on_cuda("decode_attention", q, k, v, pos):
        refuse_grad("decode_attention", "Queue 3, kernel wrappers that cut the autograd "
                    "graph", q, k, v)
        return kernel.decode_attention_cuda(
            q.contiguous(), k.contiguous(), v.contiguous(),
            pos.to(torch.int32).contiguous(), scale)
    return ref.decode_attention_ref(q, k, v, pos, scale=scale)
