"""The kernel wrappers' one-time C ABI declaration under threads, on the CPU.

The service's shard threads reach a kernel wrapper's ``_lib()`` at once.
Each wrapper declares its library's functions (``argtypes``, ``restype``)
once, completely, under a lock: every thread that gets the library back
finds every function declared.  Here the library is a stub whose
attribute writes are slow, so a thread that took a half-declared library
would see it.
"""
import threading
import time

import pytest

from repro_torch.kernels import binding
from repro_torch.kernels.decode_attn import kernel as decode_kernel
from repro_torch.kernels.flash_attn import kernel as flash_kernel
from repro_torch.kernels.seg_agg import kernel as seg_kernel
from repro_torch.kernels.ssd_scan import kernel as ssd_kernel

FUNCTIONS = {
    seg_kernel: ("seg_agg_launch", "seg_agg_plan", "seg_agg_fused_launch",
                 "seg_agg_fused_plan", "seg_agg_error_string"),
    flash_kernel: ("flash_attn_launch", "flash_attn_error_string"),
    decode_kernel: ("decode_attn_chunk", "decode_attn_launch", "decode_attn_error_string"),
    ssd_kernel: ("ssd_scan_launch", "ssd_scan_error_string"),
}
THREADS = 8


class _StubFunction:
    """A C function of the stub library: slow to declare; returns
    ``value`` when called."""

    def __init__(self, value=0):
        object.__setattr__(self, "argtypes", None)
        object.__setattr__(self, "restype", None)
        object.__setattr__(self, "value", value)

    def __setattr__(self, name, v):
        time.sleep(0.002)
        object.__setattr__(self, name, v)

    def __call__(self, *args):
        return self.value


class _StubLibrary:
    def __init__(self, names):
        for name in names:
            setattr(self, name, _StubFunction(decode_kernel.CHUNK if name.endswith("_chunk")
                                              else 0))
        self.declarations = 0


@pytest.mark.parametrize("module", list(FUNCTIONS), ids=lambda m: m.__name__.split(".")[-2])
def test_lib_declares_every_function_once_under_threads(module, monkeypatch):
    names = FUNCTIONS[module]
    lib = _StubLibrary(names)
    declare = module._declare

    def counting(target):
        target.declarations += 1
        declare(target)

    monkeypatch.setattr(module, "load", lambda name: lib)
    monkeypatch.setattr(module, "_declare", counting)
    start = threading.Barrier(THREADS)
    seen, errors = [], []

    def worker():
        try:
            start.wait(timeout=10)
            got = module._lib()
            seen.append([(getattr(got, n).argtypes is not None,
                          getattr(got, n).restype is not None) for n in names])
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(e)

    threads = [threading.Thread(target=worker) for _ in range(THREADS)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads) and not errors
    assert len(seen) == THREADS
    assert all(all(a and r for a, r in s) for s in seen)
    assert lib.declarations == 1
    assert module._lib() is lib and lib.declarations == 1


def test_declare_once_runs_again_after_a_failed_declaration():
    lib = _StubLibrary(["f"])
    calls = []

    def failing(target):
        calls.append(1)
        if len(calls) == 1:
            raise RuntimeError("wrong library")
        target.f.argtypes = []

    with pytest.raises(RuntimeError, match="wrong library"):
        binding.declare_once(lib, failing)
    assert binding.declare_once(lib, failing) is lib
    assert binding.declare_once(lib, failing) is lib
    assert len(calls) == 2 and lib.f.argtypes == []


def test_launch_counts_survive_concurrent_launches():
    binding.reset_launch_counts()
    start = threading.Barrier(THREADS)

    def worker():
        start.wait(timeout=10)
        for _ in range(2000):
            binding.count_launch("seg_agg_fused")

    threads = [threading.Thread(target=worker) for _ in range(THREADS)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    assert binding.launch_counts()["seg_agg_fused"] == THREADS * 2000
    binding.reset_launch_counts()
