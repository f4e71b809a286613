"""What the ctypes-bound kernel wrappers share: dispatch by device, input
checks, the launch-error check, and the one registry of kernel launches."""
from __future__ import annotations

import collections
import ctypes

import torch

PTR, LL, INT, FLOAT = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_float

_LAUNCHES: collections.Counter = collections.Counter()


def count_launch(kernel: str) -> None:
    """Called by a wrapper once per launch of its kernel, and nowhere else."""
    _LAUNCHES[kernel] += 1


def launch_counts() -> collections.Counter:
    """Launches per kernel name since the last reset (0 for a kernel not
    launched)."""
    return collections.Counter(_LAUNCHES)


def reset_launch_counts() -> None:
    _LAUNCHES.clear()


def on_cuda(what: str, *tensors) -> bool:
    """True for CUDA tensors, False for CPU tensors; raises on mixed or
    other devices."""
    dev = tensors[0].device
    for t in tensors[1:]:
        if t.device != dev:
            raise ValueError(f"{what}: tensors on {dev} and {t.device}")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"{what}: unsupported device {dev}")
    return dev.type == "cuda"


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
