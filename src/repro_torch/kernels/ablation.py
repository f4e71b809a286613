"""What the kernels' ablations share: rebuild one kernel library with parts
of its source taken out, and time calls on the card.

A part is a list of (text in the source, its replacement); a part whose
text is no longer in the source fails loudly, so the parts are kept with
the kernel.  The sources include the shared headers of ``kernels/csrc/``
by a relative path, which the variant copies name by their absolute path.
The ablated builds compute wrong outputs by design: only their device
times are read.  A diagnostic for work on the kernels; nothing on the
serving path imports it.
"""
from __future__ import annotations

import ctypes
import subprocess
from pathlib import Path

import torch

from . import build

HEADERS = Path(__file__).resolve().parent / "csrc"


def variant_source(src: Path, edits: list[tuple[str, str]]) -> str:
    """``src``'s text with every edit applied and the shared headers
    included by their absolute path."""
    text = src.read_text().replace('#include "../../csrc/', f'#include "{HEADERS}/')
    for old, new in edits:
        if old not in text:
            raise RuntimeError(f"ablation of {src.name}: the source no longer has {old!r}")
        text = text.replace(old, new)
    return text


def build_variants(src: Path, parts: dict[str, list[tuple[str, str]]],
                   names) -> dict[str, ctypes.CDLL]:
    """One library per name (None: the full kernel), built in parallel into
    ``build/kernels/ablation/<source>/<name>/``."""
    jobs = {}
    for part in names:
        name = part or "full"
        out = build.BUILD_DIR / "ablation" / src.stem / name
        out.mkdir(parents=True, exist_ok=True)
        (out / src.name).write_text(variant_source(src, parts.get(part, [])))
        so = out / f"lib{src.stem}.so"
        jobs[name] = (subprocess.Popen(
            [build.nvcc(), *build.NVCC_FLAGS, "-o", str(so), str(out / src.name)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), so)
    libs = {}
    for name, (proc, so) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for ablation {name}:\n{log}")
        libs[name] = ctypes.CDLL(str(so))
    return libs


def device_ms(fn, iters: int) -> float:
    """Mean device milliseconds per call under ``torch.profiler``."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    total = sum(e.time_range.elapsed_us() for e in prof.events()
                if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3
    if total <= 0.0:
        raise RuntimeError("the profiler traced no device time")
    return total / iters


def card() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
