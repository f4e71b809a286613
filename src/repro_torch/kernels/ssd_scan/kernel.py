"""CUDA chunked Mamba2 SSD scan for Hopper (``csrc/ssd_scan.cu``).

``ssd_scan_cuda`` replaces the Pallas TPU kernel ``_ssd_kernel`` of the JAX
package (``repro/kernels/ssd_scan/kernel.py``): x (B, S, H, P) float32 or
bfloat16, dt (B, S, H), A (H,), Bm and Cm (B, S, N) float32 -> y (B, S, H,
P) in x's dtype, and with ``return_state`` also the final state (B, H, P,
N) float32 that the kernel carried past the last chunk.  One block per
(batch row, group of 192 / P heads) loops over chunks of 32 steps with each
head's state in its warps' registers; every product runs on the tensor
cores as three TF32 products of split operands (``ref.ssd_tiled_ref`` is
that arithmetic in plain PyTorch).  The kernel is built for head dims
``HEAD_DIMS`` and state sizes that are multiples of 16 up to
``MAX_STATE``; any other raises ``ValueError``, as do x, Bm and Cm that
do not start on a 16-byte boundary.  The wrapper checks its inputs,
allocates the outputs, launches on the current stream, raises on a launch
error and counts each launch as ``ssd_scan`` in ``binding.launch_counts``.  The plain versions
are ``ref.ssd_ref`` (sequential) and ``ref.ssd_chunked``.
"""
from __future__ import annotations

import ctypes

import torch

from ..binding import (INT, PTR, check_aligned, check_tensor, count_launch, declare_once,
                       raise_on)
from ..build import load

HEAD_DIMS = (16, 32, 64)
MAX_STATE = 128
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
F32 = (torch.float32,)


def _declare(lib) -> None:
    lib.ssd_scan_launch.argtypes = [PTR, PTR, PTR, PTR, PTR, PTR, PTR, INT, INT,
                                    INT, INT, INT, INT, PTR]
    lib.ssd_scan_launch.restype = INT
    lib.ssd_scan_error_string.argtypes = [INT]
    lib.ssd_scan_error_string.restype = ctypes.c_char_p


def _lib() -> ctypes.CDLL:
    return declare_once(load("ssd_scan"), _declare)


def ssd_scan_cuda(x, dt, A, Bm, Cm, return_state: bool = False):
    """x: (B, S, H, P); dt: (B, S, H); A: (H,); Bm, Cm: (B, S, N); all
    contiguous CUDA tensors -> y, or (y, final state) with ``return_state``."""
    dev = x.device
    check_tensor("x", x, DTYPES, 4, dev)
    check_tensor("dt", dt, F32, 3, dev)
    check_tensor("A", A, F32, 1, dev)
    check_tensor("Bm", Bm, F32, 3, dev)
    check_tensor("Cm", Cm, F32, 3, dev)
    b, s, h, p = x.shape
    n = Bm.shape[-1]
    if dt.shape != (b, s, h) or A.shape != (h,) or Bm.shape != (b, s, n) \
            or Cm.shape != Bm.shape:
        raise ValueError(f"dt {tuple(dt.shape)} / A {tuple(A.shape)} / Bm "
                         f"{tuple(Bm.shape)} / Cm {tuple(Cm.shape)} do not match "
                         f"x {tuple(x.shape)}")
    if p not in HEAD_DIMS:
        raise ValueError(f"head dim {p}: the kernel is built for {HEAD_DIMS}")
    if n < 16 or n > MAX_STATE or n % 16:
        raise ValueError(f"state size {n}: the kernel takes multiples of 16 up to "
                         f"{MAX_STATE}")
    for name, t in (("x", x), ("Bm", Bm), ("Cm", Cm)):
        check_aligned(name, t)
    y = torch.empty_like(x)
    state = torch.empty((b, h, p, n), dtype=torch.float32, device=dev) \
        if return_state else None
    if b * h:
        lib = _lib()
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            rc = lib.ssd_scan_launch(
                x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
                Cm.data_ptr(), y.data_ptr(), None if state is None else state.data_ptr(),
                b, h, s, p, n, DTYPES[x.dtype], stream)
        raise_on(rc, lib.ssd_scan_error_string, "ssd_scan")
        count_launch("ssd_scan")
    return (y, state) if return_state else y
