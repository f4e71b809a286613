"""CUDA causal GQA prefill attention for Hopper (``csrc/flash_attn.cu``).

``flash_attention_cuda`` replaces the Pallas TPU kernel ``_flash_kernel`` of
the JAX package (``repro/kernels/flash_attn/kernel.py``): q (B, H, S, Dh),
k and v (B, Hkv, S, Dh), float32 or bfloat16 -> (B, H, S, Dh) in q's dtype,
blockwise online softmax in f32, K tiles above the diagonal skipped.  In
bfloat16 the products run on the tensor cores, each K/V tile staged once
per GQA group (``ref.flash_tiled_ref`` is the same arithmetic in plain
PyTorch); float32 multiplies on the CUDA cores.  The kernel is built for
the head dims in ``HEAD_DIMS`` (16, 32, 64, 112, 128, 192 and 256: those
of the reference's registry and kernel tests); any other raises
``ValueError``, where the Pallas kernel takes any head dim (ROADMAP.md,
deliberate departures).
The wrapper checks its inputs, allocates the output, launches on the
current stream, raises on a launch error and counts each launch as
``flash_attn`` in ``binding.launch_counts``.  The plain version is
``ref.mha_ref``.
"""
from __future__ import annotations

import ctypes

import torch

from ..binding import (FLOAT, INT, PTR, check_aligned, check_tensor, count_launch,
                       raise_on)
from ..build import ATTN_HEAD_DIMS, load

HEAD_DIMS = ATTN_HEAD_DIMS
DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _lib() -> ctypes.CDLL:
    lib = load("flash_attn")
    if lib.flash_attn_launch.argtypes is None:  # first use: declare the C ABI
        lib.flash_attn_launch.argtypes = [PTR, PTR, PTR, PTR, INT, INT, INT, INT,
                                          INT, INT, FLOAT, INT, PTR]
        lib.flash_attn_launch.restype = INT
        lib.flash_attn_error_string.argtypes = [INT]
        lib.flash_attn_error_string.restype = ctypes.c_char_p
    return lib


def flash_attention_cuda(q, k, v, causal: bool = True, scale: float | None = None):
    """q: (B, H, S, Dh); k, v: (B, Hkv, S, Dh), contiguous CUDA tensors of
    one dtype -> (B, H, S, Dh).  ``scale`` defaults to Dh ** -0.5."""
    dev = q.device
    for name, t in (("q", q), ("k", k), ("v", v)):
        check_tensor(name, t, DTYPES, 4, dev)
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k, v dtypes differ: {q.dtype}, {k.dtype}, {v.dtype}")
    b, h, s, dh = q.shape
    hkv = k.shape[1]
    if k.shape != (b, hkv, s, dh) or v.shape != k.shape:
        raise ValueError(f"k {tuple(k.shape)} / v {tuple(v.shape)} do not match "
                         f"q {tuple(q.shape)}")
    if hkv < 1 or h % hkv:
        raise ValueError(f"{h} query heads are not a multiple of {hkv} KV heads")
    if dh not in HEAD_DIMS:
        raise ValueError(f"head dim {dh}: the kernel is built for {HEAD_DIMS}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        check_aligned(name, t)
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.flash_attn_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, h, hkv,
            s, dh, int(bool(causal)), dh ** -0.5 if scale is None else float(scale),
            DTYPES[q.dtype], stream)
    raise_on(rc, lib.flash_attn_error_string, "flash_attn")
    count_launch("flash_attn")
    return out
