"""Dispatching wrapper for the chunked Mamba2 SSD scan: CUDA tensors go to
the hand-written kernel (``kernel.py``), CPU tensors to the plain version
(``ref.py``).  There is no switch that sends CUDA tensors to the plain
version.  DTensors go through ``distributed.local.call``: heads split on
``model``, batch on the data axes, B and C whole on every rank."""
from __future__ import annotations

import torch

from ...distributed import local
from ..binding import on_cuda, refuse_grad
from . import kernel, ref


def ssd_scan(x, dt, A, Bm, Cm, chunk: int = 128, return_state: bool = False):
    """x: (B, S, H, P); dt: (B, S, H); A: (H,); Bm, Cm: (B, S, N) -> y
    (B, S, H, P) in x's dtype, and with ``return_state`` also the final
    state (B, H, P, N) float32.  ``chunk`` is the plain version's chunk
    length; the kernel chunks by its own."""
    if local.any_dtensor(x, dt, A, Bm, Cm):
        def shard(_, *xs):
            return ssd_scan(*xs, chunk=chunk, return_state=return_state)

        args = [local.Arg(x, 0, 2), local.Arg(dt, 0, 2), local.Arg(A, None, 0),
                local.Arg(Bm, 0), local.Arg(Cm, 0)]
        return local.call(shard, args, [(0, 2), (0, 1)] if return_state else [(0, 2)])
    if on_cuda("ssd_scan", x, dt, A, Bm, Cm):
        refuse_grad("ssd_scan", "Queue 1 item 1, Mamba2 training on the card: an "
                    "ssd_scan backward kernel", x, dt, A, Bm, Cm)
        f32 = torch.float32
        return kernel.ssd_scan_cuda(
            x.contiguous(), dt.to(f32).contiguous(), A.to(f32).contiguous(),
            Bm.to(f32).contiguous(), Cm.to(f32).contiguous(), return_state)
    y = ref.ssd_chunked(x, dt, A, Bm, Cm, chunk=chunk)
    return (y, ref.ssd_final_state(x, dt, A, Bm)) if return_state else y


def ssd_step(state, xt, dt, A, bt, ct):
    """One decode step of the scan, plain PyTorch on every device (JAX's is
    plain jnp): state (B, H, P, N), xt (B, H, P), dt (B, H), A (H,), bt,
    ct (B, N) -> (y (B, H, P) in xt's dtype, the new state in float32).
    DTensors go through ``distributed.local.call`` as ``ssd_scan`` does."""
    if local.any_dtensor(state, xt, dt, A, bt, ct):
        def shard(_, *xs):
            return ref.ssd_decode_step(*xs)

        args = [local.Arg(state, 0, 1), local.Arg(xt, 0, 1), local.Arg(dt, 0, 1),
                local.Arg(A, None, 0), local.Arg(bt, 0), local.Arg(ct, 0)]
        return local.call(shard, args, [(0, 1), (0, 1)])
    return ref.ssd_decode_step(state, xt, dt, A, bt, ct)
