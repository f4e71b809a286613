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

``flash_attention_bwd_cuda`` is its backward (``csrc/flash_attn_bwd.cu``,
new in the port: no Pallas kernel has one, and the JAX package
differentiates ``mha_ref``): dq, dk, dv from q, k, v, the forward's output
and its gradient, each launch counted as ``flash_attn_bwd``.  In bfloat16
every product runs on the tensor cores in two kernels (dQ with each row's
logsumexp, then dK and dV), with P and dS split into bf16 hi + lo
(``ref.flash_bwd_tiled_ref`` is the same arithmetic in plain PyTorch);
float32 multiplies on the CUDA cores.  Its plain version is
``ref.mha_bwd_ref``.
"""
from __future__ import annotations

import ctypes

import torch

from ..binding import (FLOAT, INT, PTR, check_aligned, check_tensor, count_launch,
                       declare_once, raise_on)
from ..build import ATTN_HEAD_DIMS, load

HEAD_DIMS = ATTN_HEAD_DIMS
DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _declare(lib) -> None:
    lib.flash_attn_launch.argtypes = [PTR, PTR, PTR, PTR, INT, INT, INT, INT,
                                      INT, INT, FLOAT, INT, PTR]
    lib.flash_attn_launch.restype = INT
    lib.flash_attn_error_string.argtypes = [INT]
    lib.flash_attn_error_string.restype = ctypes.c_char_p


def _lib() -> ctypes.CDLL:
    return declare_once(load("flash_attn"), _declare)


def _declare_bwd(lib) -> None:
    lib.flash_attn_bwd_launch.argtypes = [PTR] * 9 + [INT] * 6 + [FLOAT, INT, PTR]
    lib.flash_attn_bwd_launch.restype = INT
    lib.flash_attn_bwd_error_string.argtypes = [INT]
    lib.flash_attn_bwd_error_string.restype = ctypes.c_char_p


def _lib_bwd() -> ctypes.CDLL:
    return declare_once(load("flash_attn_bwd"), _declare_bwd)


def _check_qkv(q, k, v, extra=()):
    """Raise unless q (B, H, S, Dh) and k, v (B, Hkv, S, Dh), and each
    (name, tensor) of ``extra`` shaped as q, are contiguous CUDA tensors of
    one dtype on q's device at a head dim the kernels are built for."""
    dev = q.device
    named = (("q", q), ("k", k), ("v", v), *extra)
    for name, t in named:
        check_tensor(name, t, DTYPES, 4, dev)
    if any(t.dtype != q.dtype for _, t in named):
        raise TypeError("dtypes differ: " + ", ".join(f"{n} {t.dtype}" for n, t in named))
    b, h, s, dh = q.shape
    hkv = k.shape[1]
    if k.shape != (b, hkv, s, dh) or v.shape != k.shape:
        raise ValueError(f"k {tuple(k.shape)} / v {tuple(v.shape)} do not match "
                         f"q {tuple(q.shape)}")
    for name, t in extra:
        if t.shape != q.shape:
            raise ValueError(f"{name} {tuple(t.shape)} does not match q {tuple(q.shape)}")
    if hkv < 1 or h % hkv:
        raise ValueError(f"{h} query heads are not a multiple of {hkv} KV heads")
    if dh not in HEAD_DIMS:
        raise ValueError(f"head dim {dh}: the kernel is built for {HEAD_DIMS}")
    for name, t in named:
        check_aligned(name, t)


def flash_attention_cuda(q, k, v, causal: bool = True, scale: float | None = None):
    """q: (B, H, S, Dh); k, v: (B, Hkv, S, Dh), contiguous CUDA tensors of
    one dtype -> (B, H, S, Dh).  ``scale`` defaults to Dh ** -0.5."""
    dev = q.device
    _check_qkv(q, k, v)
    b, h, s, dh = q.shape
    hkv = k.shape[1]
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


def flash_attention_bwd_cuda(q, k, v, o, do, causal: bool = True,
                             scale: float | None = None):
    """The gradient of causal GQA attention: q, o, do (B, H, S, Dh) and k, v
    (B, Hkv, S, Dh), contiguous CUDA tensors of one dtype, o the forward's
    output and do its gradient -> (dq, dk, dv) shaped and typed as q, k,
    v.  ``scale`` defaults to Dh ** -0.5."""
    dev = q.device
    _check_qkv(q, k, v, (("o", o), ("do", do)))
    b, h, s, dh = q.shape
    hkv = k.shape[1]
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if dq.numel() == 0:
        return dq, dk, dv
    stats = torch.empty((2, b * h * s), dtype=torch.float32, device=dev)  # lse, D per row
    lib = _lib_bwd()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.flash_attn_bwd_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
            dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), stats.data_ptr(), b, h, hkv, s,
            dh, int(bool(causal)), dh ** -0.5 if scale is None else float(scale),
            DTYPES[q.dtype], stream)
    raise_on(rc, lib.flash_attn_bwd_error_string, "flash_attn_bwd")
    count_launch("flash_attn_bwd")
    return dq, dk, dv
