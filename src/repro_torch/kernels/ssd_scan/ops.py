"""Dispatching wrapper for the chunked Mamba2 SSD scan: CUDA tensors go to
the hand-written kernel (``kernel.py``), CPU tensors to the plain version
(``ref.py``).  There is no switch that sends CUDA tensors to the plain
version."""
from __future__ import annotations

import torch

from ..binding import on_cuda
from . import kernel, ref


def ssd_scan(x, dt, A, Bm, Cm, chunk: int = 128, return_state: bool = False):
    """x: (B, S, H, P); dt: (B, S, H); A: (H,); Bm, Cm: (B, S, N) -> y
    (B, S, H, P) in x's dtype, and with ``return_state`` also the final
    state (B, H, P, N) float32.  ``chunk`` is the plain version's chunk
    length; the kernel chunks by its own."""
    if on_cuda("ssd_scan", x, dt, A, Bm, Cm):
        f32 = torch.float32
        return kernel.ssd_scan_cuda(
            x.contiguous(), dt.to(f32).contiguous(), A.to(f32).contiguous(),
            Bm.to(f32).contiguous(), Cm.to(f32).contiguous(), return_state)
    y = ref.ssd_chunked(x, dt, A, Bm, Cm, chunk=chunk)
    return (y, ref.ssd_final_state(x, dt, A, Bm)) if return_state else y
