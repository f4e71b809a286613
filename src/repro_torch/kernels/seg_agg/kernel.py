"""CUDA grouped-aggregation kernels for Hopper (``csrc/seg_agg.cu``).

Two kernels, each replacing one Pallas TPU kernel of the JAX package
(``repro/kernels/seg_agg/kernel.py``):

* ``seg_agg_cuda`` (kernel A) <- ``_seg_agg_kernel``: values (N, M) f32,
  group ids (N,) int32 and a row mask (N,) f32 -> (G, M) SUM/MIN/MAX, with
  the select or the multiply mask contract;
* ``seg_agg_fused_cuda`` (kernel B) <- ``_seg_agg_fused_kernel``: the row
  mask is built inside the kernel from predicate columns (N, P) f32 and
  range bounds (S, P, K, 2) f32, for S signatures in one pass over the rows
  -> (S, G, M).

Both are one template: kernel A is kernel B with one signature whose mask
column is given.  Each call is one cooperative launch.  Its slots are
privatised by their count S*G*M (``fused_tier``, ``masked_tier``), the
first tier that leaves two blocks per SM: per thread, or per warp for
several signatures, both updated without atomics, which makes SUM
bit-reproducible; then per block with shared-memory atomics, and past what
a block holds global atomics.  Below the global tier the blocks' partials
go to a workspace this module owns and are combined in a fixed order
inside the same launch.

Both are bound by the bytes they read (see the note in the source).  The
wrappers check device, dtype, shape, contiguity and 16-byte alignment,
allocate the output, launch on the current stream and raise on a launch
error; each counts every kernel launch, as ``seg_agg`` or
``seg_agg_fused``, in ``binding.launch_counts``.  Their plain PyTorch
versions are in ``ref.py``.
"""
from __future__ import annotations

import ctypes

import torch

from ...analysis.sanitizer import make_lock
from ..binding import (INT as _INT, LL as _LL, PTR as _PTR, check_aligned, check_tensor,
                       count_launch, declare_once, raise_on)
from ..build import load

OPS = {"sum": 0, "min": 1, "max": 2}
MAX_SIGNATURES = 64  # one launch evaluates at most this many signatures
MAX_BOUNDS_BYTES = 32 * 1024  # (S, P, K, 2) bounds staged in shared memory
# the slot tiers (``fused_tier``, ``masked_tier``; kernel A takes no per-warp
# slots); "thread" and "warp" are bit-reproducible
TIERS = ("thread", "warp", "block", "global")
DETERMINISTIC = ("thread", "warp")

# (device index, stream) -> (barrier counters, workspace): both kernels'
# scratch, grown on demand.  Each launch leaves the counters at 0 again, and
# launches on one stream run in order, so a stream's launches share one.
_SCRATCH_LOCK = make_lock("seg_agg._SCRATCH_LOCK")
_SCRATCH: dict[tuple[int, int], tuple] = {}  # guarded-by: _SCRATCH_LOCK


def _declare(lib) -> None:
    lib.seg_agg_launch.argtypes = [_PTR, _PTR, _PTR, _PTR, _LL, _INT, _INT,
                                   _INT, _INT, _PTR, _PTR, _PTR]
    lib.seg_agg_launch.restype = _INT
    lib.seg_agg_plan.argtypes = [_LL, _INT, _INT, _INT, _INT, ctypes.POINTER(_LL)]
    lib.seg_agg_plan.restype = _INT
    lib.seg_agg_fused_launch.argtypes = [_PTR, _PTR, _PTR, _PTR, _PTR, _LL,
                                         _INT, _INT, _INT, _INT, _INT,
                                         _INT, _PTR, _PTR, _PTR]
    lib.seg_agg_fused_launch.restype = _INT
    lib.seg_agg_fused_plan.argtypes = [_LL, _INT, _INT, _INT, _INT, _INT, _INT,
                                       ctypes.POINTER(_LL)]
    lib.seg_agg_fused_plan.restype = _INT
    lib.seg_agg_error_string.argtypes = [_INT]
    lib.seg_agg_error_string.restype = ctypes.c_char_p


def _lib() -> ctypes.CDLL:
    return declare_once(load("seg_agg"), _declare)


def _check(name: str, t, dtype, ndim: int, device) -> None:
    check_tensor(name, t, (dtype,), ndim, device)


def _raise_on(lib, rc: int, what: str) -> None:
    raise_on(rc, lib.seg_agg_error_string, what)


def _op_code(op: str) -> int:
    if op not in OPS:
        raise ValueError(f"unknown op {op!r}")
    return OPS[op]


def seg_agg_cuda(values, ids, mask, num_groups: int, op: str = "sum",
                 select: bool = True):
    """Kernel A: (N, M) f32 values, (N,) int32 ids, (N,) f32 mask ->
    (num_groups, M) f32.  ``select`` keeps masked-out rows out of every
    group; ``select=False`` is the multiply contract of ``seg_agg_ref``
    (SUM adds value * mask; MIN/MAX always select)."""
    code = _op_code(op)
    dev = values.device
    _check("values", values, torch.float32, 2, dev)
    _check("ids", ids, torch.int32, 1, dev)
    _check("mask", mask, torch.float32, 1, dev)
    n, m = values.shape
    if ids.shape[0] != n or mask.shape[0] != n:
        raise ValueError(f"rows disagree: values {n}, ids {ids.shape[0]}, "
                         f"mask {mask.shape[0]}")
    if num_groups < 1 or num_groups >= 2 ** 31:
        raise ValueError(f"num_groups out of range: {num_groups}")
    for name, t in (("values", values), ("ids", ids), ("mask", mask)):
        check_aligned(name, t)
    out = torch.empty((num_groups, m), dtype=torch.float32, device=dev)
    if out.numel() == 0:
        return out
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        _, n_work = _masked_plan(lib, n, m, num_groups, code, select)
        bar, work = _scratch(dev, stream, n_work)
        rc = lib.seg_agg_launch(values.data_ptr(), ids.data_ptr(),
                                mask.data_ptr(), out.data_ptr(), n, m,
                                num_groups, code, int(bool(select)), stream,
                                work.data_ptr(), bar.data_ptr())
    _raise_on(lib, rc, "seg_agg")
    count_launch("seg_agg")
    return out


def _check_plan(lib, tier: int, work, what: str) -> tuple[int, int]:
    if tier < 0:
        _raise_on(lib, -tier, what)
    return tier, work.value


def _masked_plan(lib, n: int, m: int, g: int, code: int, select: bool) -> tuple[int, int]:
    work = _LL(0)
    return _check_plan(lib, lib.seg_agg_plan(n, m, g, code, int(bool(select)),
                                             ctypes.byref(work)), work, "seg_agg plan")


def _plan(lib, n: int, m: int, p: int, k: int, s: int, g: int, code: int) -> tuple[int, int]:
    work = _LL(0)
    return _check_plan(lib, lib.seg_agg_fused_plan(n, m, p, k, s, g, code, ctypes.byref(work)),
                       work, "seg_agg_fused plan")


def masked_tier(n: int, m: int, num_groups: int, op: str = "sum",
                select: bool = True) -> str:
    """Kernel A's slot tier for one launch at this shape (on the current
    CUDA device): one of ``TIERS`` other than "warp"."""
    return TIERS[_masked_plan(_lib(), n, m, num_groups, _op_code(op), select)[0]]


def fused_tier(n: int, m: int, p: int, k: int, s: int, num_groups: int,
               op: str = "sum") -> str:
    """Kernel B's slot tier for one launch at this shape (on the current
    CUDA device): one of ``TIERS``."""
    return TIERS[_plan(_lib(), n, m, p, k, s, num_groups, _op_code(op))[0]]


def _scratch(dev, stream: int, n_work: int):
    """Barrier counters (int32, zero) and a float32 workspace of at least
    ``n_work`` floats for launches on ``stream``."""
    with _SCRATCH_LOCK:
        have = _SCRATCH.get((dev.index, stream))
        if have is None or have[1].numel() < n_work:
            n_work = max(n_work, 0 if have is None else have[1].numel())
            have = _SCRATCH[(dev.index, stream)] = (
                torch.zeros(2, dtype=torch.int32, device=dev) if have is None else have[0],
                torch.empty(max(n_work, 1), dtype=torch.float32, device=dev))
        return have


def seg_agg_fused_cuda(values, ids, pred_cols, bounds, num_groups: int,
                       op: str = "sum"):
    """Kernel B: (N, M) f32 values, (N,) int32 ids, (N, P) f32 predicate
    columns, (S, P, K, 2) f32 bounds -> (S, num_groups, M) f32.  A row
    counts for signature s iff, for every predicate, one of s's K inclusive
    ranges holds its value (NaN sentinel and pad ranges as in
    ``ref.bounds_mask_ref``); P == 0 admits every row.  More than
    ``MAX_SIGNATURES`` signatures take one launch per chunk."""
    code = _op_code(op)
    dev = values.device
    _check("values", values, torch.float32, 2, dev)
    _check("ids", ids, torch.int32, 1, dev)
    _check("pred_cols", pred_cols, torch.float32, 2, dev)
    _check("bounds", bounds, torch.float32, 4, dev)
    n, m = values.shape
    s_total, p, k, two = bounds.shape
    if ids.shape[0] != n or pred_cols.shape[0] != n:
        raise ValueError(f"rows disagree: values {n}, ids {ids.shape[0]}, "
                         f"pred_cols {pred_cols.shape[0]}")
    if pred_cols.shape[1] != p or two != 2 or k < 1:
        raise ValueError(f"bounds {tuple(bounds.shape)} do not match "
                         f"pred_cols {tuple(pred_cols.shape)}")
    if num_groups < 1 or s_total * num_groups >= 2 ** 31:
        raise ValueError(f"group space out of range: {s_total} x {num_groups}")
    chunk = min(s_total, MAX_SIGNATURES)
    if chunk * p * k * 2 * 4 > MAX_BOUNDS_BYTES:
        raise ValueError(f"bounds {tuple(bounds.shape)} exceed the "
                         f"{MAX_BOUNDS_BYTES}-byte shared-memory budget")
    for name, t in (("values", values), ("ids", ids), ("pred_cols", pred_cols)):
        check_aligned(name, t)
    out = torch.empty((s_total, num_groups, m), dtype=torch.float32, device=dev)
    if out.numel() == 0:
        return out
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        for s0 in range(0, s_total, chunk):
            s1 = min(s0 + chunk, s_total)
            _, n_work = _plan(lib, n, m, p, k, s1 - s0, num_groups, code)
            bar, work = _scratch(dev, stream, n_work)
            rc = lib.seg_agg_fused_launch(
                values.data_ptr(), ids.data_ptr(), pred_cols.data_ptr(),
                bounds[s0:s1].data_ptr(), out[s0:s1].data_ptr(), n, m, p, k,
                s1 - s0, num_groups, code, stream, work.data_ptr(), bar.data_ptr())
            _raise_on(lib, rc, "seg_agg_fused")
            count_launch("seg_agg_fused")
    return out
