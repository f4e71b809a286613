"""CUDA one-token GQA attention over a KV cache for Hopper
(``csrc/decode_attn.cu``).

``decode_attention_cuda`` replaces the Pallas TPU kernel ``_decode_kernel``
of the JAX package (``repro/kernels/decode_attn/kernel.py``): q (B, H, Dh),
k and v (B, Hkv, S, Dh), float32 or bfloat16, and valid lengths pos (B,)
int32 -> (B, H, Dh) in q's dtype.  The G = H / Hkv query heads of a group
read each cache tile once; nothing at or past pos is read.  The kernel is
built for head dims 64 and 128 and groups of up to ``MAX_GROUP`` heads; any
other raises ``ValueError``.  The wrapper checks its inputs, allocates the
output, launches on the current stream, raises on a launch error and
counts each launch as ``decode_attn`` in ``binding.launch_counts``.  The
plain version is ``ref.decode_attention_ref``.
"""
from __future__ import annotations

import ctypes

import torch

from ..binding import FLOAT, INT, PTR, check_tensor, count_launch, raise_on
from ..build import load

HEAD_DIMS = (64, 128)
MAX_GROUP = 128  # the group's q and accumulator are staged in shared memory
DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _lib() -> ctypes.CDLL:
    lib = load("decode_attn")
    if lib.decode_attn_launch.argtypes is None:  # first use: declare the C ABI
        lib.decode_attn_launch.argtypes = [PTR, PTR, PTR, PTR, PTR, INT, INT, INT,
                                           INT, INT, FLOAT, INT, PTR]
        lib.decode_attn_launch.restype = INT
        lib.decode_attn_error_string.argtypes = [INT]
        lib.decode_attn_error_string.restype = ctypes.c_char_p
    return lib


def decode_attention_cuda(q, k, v, pos, scale: float | None = None):
    """q: (B, H, Dh); k, v: (B, Hkv, S, Dh) of q's dtype; pos: (B,) int32;
    all contiguous CUDA tensors -> (B, H, Dh).  ``scale`` defaults to
    Dh ** -0.5."""
    dev = q.device
    check_tensor("q", q, DTYPES, 3, dev)
    check_tensor("k", k, (q.dtype,), 4, dev)
    check_tensor("v", v, (q.dtype,), 4, dev)
    check_tensor("pos", pos, (torch.int32,), 1, dev)
    b, h, dh = q.shape
    hkv, s = k.shape[1], k.shape[2]
    if k.shape != (b, hkv, s, dh) or v.shape != k.shape or pos.shape != (b,):
        raise ValueError(f"k {tuple(k.shape)} / v {tuple(v.shape)} / pos "
                         f"{tuple(pos.shape)} do not match q {tuple(q.shape)}")
    if hkv < 1 or h % hkv:
        raise ValueError(f"{h} query heads are not a multiple of {hkv} KV heads")
    if h // hkv > MAX_GROUP:
        raise ValueError(f"{h // hkv} query heads per KV head; the kernel "
                         f"takes at most {MAX_GROUP}")
    if dh not in HEAD_DIMS:
        raise ValueError(f"head dim {dh}: the kernel is built for {HEAD_DIMS}")
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.decode_attn_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), pos.data_ptr(),
            out.data_ptr(), b, h, hkv, s, dh,
            dh ** -0.5 if scale is None else float(scale), DTYPES[q.dtype], stream)
    raise_on(rc, lib.decode_attn_error_string, "decode_attn")
    count_launch("decode_attn")
    return out
