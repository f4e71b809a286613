"""What the ctypes-bound kernel wrappers share: the one-time declaration of
a library's C ABI, dispatch by device, the refusal of gradients a kernel
has no backward for, input checks, the launch-error check, and the one
registry of kernel launches."""
from __future__ import annotations

import collections
import contextlib
import contextvars
import ctypes

import torch

from ..analysis.sanitizer import make_lock

PTR, LL, INT, FLOAT = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_float

# the service's shard threads launch kernels concurrently
_LAUNCH_LOCK = make_lock("kernels.binding._LAUNCH_LOCK")
_LAUNCHES: collections.Counter = collections.Counter()  # guarded-by: _LAUNCH_LOCK
_ABI_LOCK = make_lock("kernels.binding._ABI_LOCK")


def declare_once(lib, declare):
    """``lib`` after ``declare(lib)`` has set the ``argtypes`` and
    ``restype`` of each of its functions: once per library, to its end,
    under a lock.  A thread gets ``lib`` back only when every function is
    declared; an undeclared one would take 64-bit arguments as C ``int``.
    If ``declare`` raises, the next call runs it again."""
    if getattr(lib, "_abi_declared", False):
        return lib
    with _ABI_LOCK:
        if not getattr(lib, "_abi_declared", False):
            declare(lib)
            lib._abi_declared = True
    return lib


def count_launch(kernel: str) -> None:
    """Called by a wrapper once per launch of its kernel, and nowhere else."""
    with _LAUNCH_LOCK:
        _LAUNCHES[kernel] += 1


def launch_counts() -> collections.Counter:
    """Launches per kernel name since the last reset (0 for a kernel not
    launched)."""
    with _LAUNCH_LOCK:
        return collections.Counter(_LAUNCHES)


def reset_launch_counts() -> None:
    with _LAUNCH_LOCK:
        _LAUNCHES.clear()


# set while a caller runs the plain versions only (the dry-run's FakeTensors)
_PLAIN_ONLY: contextvars.ContextVar = contextvars.ContextVar("plain_only", default=None)


@contextlib.contextmanager
def plain_only(why: str):
    """Within the block a wrapper handed a CUDA tensor raises instead of
    launching its kernel (``why`` says who asked)."""
    token = _PLAIN_ONLY.set(why)
    try:
        yield
    finally:
        _PLAIN_ONLY.reset(token)


def on_cuda(what: str, *tensors) -> bool:
    """True for CUDA tensors, False for CPU tensors; raises on mixed or
    other devices, and on CUDA tensors inside ``plain_only``."""
    dev = tensors[0].device
    for t in tensors[1:]:
        if t.device != dev:
            raise ValueError(f"{what}: tensors on {dev} and {t.device}")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"{what}: unsupported device {dev}")
    if dev.type == "cuda" and _PLAIN_ONLY.get() is not None:
        raise RuntimeError(f"{what}: a CUDA tensor inside {_PLAIN_ONLY.get()}, which "
                           f"runs the plain versions on CPU tensors only")
    return dev.type == "cuda"


def refuse_grad(what: str, item: str, *tensors) -> None:
    """Raise ``NotImplementedError`` where grad is enabled and a CUDA tensor
    among ``tensors`` requires it: a ctypes launch into a new tensor would
    cut the autograd graph without a word, and the kernel of ``what`` has
    no backward yet (``item``: the ROADMAP.md item that brings one)."""
    if torch.is_grad_enabled() and any(
            isinstance(t, torch.Tensor) and t.requires_grad and t.device.type == "cuda"
            for t in tensors):
        raise NotImplementedError(
            f"{what}: the CUDA kernel has no backward, and a launch would cut the "
            f"autograd graph (ROADMAP.md, {item}); run it under torch.no_grad() or "
            f"torch.inference_mode(), or on CPU tensors")


def check_tensor(name: str, t, dtypes, ndim: int, device) -> None:
    """Raise unless ``t`` is a contiguous CUDA tensor on ``device`` with
    ``ndim`` dims and one of ``dtypes``."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a torch.Tensor, got {type(t).__name__}")
    if t.device.type != "cuda":
        raise ValueError(f"{name}: the kernel takes CUDA tensors, got {t.device}")
    if t.device != device:
        raise ValueError(f"{name}: expected a tensor on {device}, got {t.device}")
    if t.dtype not in dtypes:
        raise TypeError(f"{name}: expected {' or '.join(map(str, dtypes))}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name}: expected {ndim} dims, got shape {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")


def check_aligned(name: str, t, nbytes: int = 16) -> None:
    """Raise unless ``t``'s data starts on an ``nbytes`` boundary (the
    kernels copy rows in 16-byte vectors; a contiguous view that starts
    inside a row does not)."""
    if t.data_ptr() % nbytes:
        raise ValueError(f"{name}: the kernel reads {nbytes}-byte vectors; the "
                         f"data does not start on a {nbytes}-byte boundary")


def raise_on(rc: int, error_string, what: str) -> None:
    """Raise if a launcher returned a CUDA error code other than 0."""
    if rc != 0:
        raise RuntimeError(f"{what} launch failed: CUDA error {rc} "
                           f"({error_string(rc).decode()})")
