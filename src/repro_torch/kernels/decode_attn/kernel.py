"""CUDA one-token GQA attention over a KV cache for Hopper
(``csrc/decode_attn.cu``).

``decode_attention_cuda`` replaces the Pallas TPU kernel ``_decode_kernel``
of the JAX package (``repro/kernels/decode_attn/kernel.py``): q (B, H, Dh),
k and v (B, Hkv, S, Dh), float32 or bfloat16, and valid lengths pos (B,)
int32 -> (B, H, Dh) in q's dtype.  Nothing at or past pos is read, and pos
is never read on the host.  bfloat16 runs one warp per (batch, KV head, 16
query heads, 8 output columns) through the prefill kernel's own tile step,
so a decode step matches ``flash_attention_cuda``'s row for the same token
bit for bit (``ref.decode_tiled_ref`` is that arithmetic in plain
PyTorch).  float32 splits the cache into chunks of ``CHUNK`` slots, one
block each, and the last live block of each (batch, KV head) combines
their partials (``ref.decode_chunked_ref``).  The kernel is built for the
head dims in ``HEAD_DIMS`` (those of ``flash_attention_cuda``) and groups
of up to ``MAX_GROUP`` heads; any other raises ``ValueError``.  The wrapper checks its inputs, allocates the output,
launches on the current stream, raises on a launch error and counts each
launch as ``decode_attn`` in ``binding.launch_counts``.  The plain version
is ``ref.decode_attention_ref``.
"""
from __future__ import annotations

import ctypes

import torch

from ...analysis.sanitizer import make_lock
from ..binding import (FLOAT, INT, PTR, check_aligned, check_tensor, count_launch,
                       declare_once, raise_on)
from ..build import ATTN_HEAD_DIMS, load

HEAD_DIMS = ATTN_HEAD_DIMS
MAX_GROUP = 128  # float32 stages the group's scaled q and p in shared memory
CHUNK = 32  # cache slots per float32 block (kChunk in csrc/decode_attn.cu)
DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# (device index, stream) -> (tickets, partials): the float32 instance's
# scratch, grown on demand.  Each launch leaves every ticket at 0 again, and launches
# on one stream run in order, so a stream's launches share one scratch.
_SCRATCH_LOCK = make_lock("decode_attn._SCRATCH_LOCK")
_SCRATCH: dict[tuple[int, int], tuple] = {}  # guarded-by: _SCRATCH_LOCK


def _declare(lib) -> None:
    lib.decode_attn_chunk.argtypes = []
    lib.decode_attn_chunk.restype = INT
    if lib.decode_attn_chunk() != CHUNK:
        raise RuntimeError(f"decode_attn: the library's chunk is "
                           f"{lib.decode_attn_chunk()}, the wrapper's {CHUNK}")
    lib.decode_attn_error_string.argtypes = [INT]
    lib.decode_attn_error_string.restype = ctypes.c_char_p
    lib.decode_attn_launch.restype = INT
    lib.decode_attn_launch.argtypes = [PTR, PTR, PTR, PTR, PTR, INT, INT, INT,
                                       INT, INT, FLOAT, INT, PTR, PTR, PTR]


def _lib() -> ctypes.CDLL:
    return declare_once(load("decode_attn"), _declare)


def _scratch(dev, stream: int, n_tickets: int, n_partial: int):
    """Tickets (int32, zero) and partials (float32) of at least these sizes
    for launches on ``stream``."""
    with _SCRATCH_LOCK:
        have = _SCRATCH.get((dev.index, stream))
        if have is None or have[0].numel() < n_tickets or have[1].numel() < n_partial:
            n_tickets = max(n_tickets, 0 if have is None else have[0].numel())
            n_partial = max(n_partial, 0 if have is None else have[1].numel())
            have = _SCRATCH[(dev.index, stream)] = (
                torch.zeros(n_tickets, dtype=torch.int32, device=dev),
                torch.empty(n_partial, dtype=torch.float32, device=dev))
        return have


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
    check_aligned("k", k)
    check_aligned("v", v)
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        part = tickets = None  # the bfloat16 instance takes no scratch
        if q.dtype == torch.float32:
            chunks = max(1, -(-s // CHUNK))
            tickets, part = (t.data_ptr() for t in _scratch(
                dev, stream, b * hkv, b * h * chunks * (dh + 2)))
        rc = lib.decode_attn_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), pos.data_ptr(),
            out.data_ptr(), b, h, hkv, s, dh,
            dh ** -0.5 if scale is None else float(scale), DTYPES[q.dtype], stream,
            part, tickets)
    raise_on(rc, lib.decode_attn_error_string, "decode_attn")
    count_launch("decode_attn")
    return out
