"""Build and load the port's CUDA kernels.

Each kernel library under ``kernels/<name>/csrc/`` is compiled by ``nvcc``
for Hopper (``sm_90a``) into a shared library with a plain C interface and
loaded with ``ctypes``.  Libraries go to ``build/kernels/`` at the root of
the checkout (listed in ``.gitignore``), named by a digest of the sources,
their units and the flags, so an edited source is rebuilt and an unchanged
one is not.  The headers under ``kernels/csrc/`` that the sources include
are hashed into every library's name, so an edited header rebuilds them
all.

A library is linked from compilation units, each a source compiled with
its own ``-D`` flags.  The attention libraries compile their source once
per head dim (``-DHEAD_DIM=<dh>``: that dim's f32 and bf16 instances) and
once without, for the dispatcher, so their many instances build side by
side.  Nothing is built when a module is imported: the first launch builds
what it needs, and ``build_all`` starts one ``nvcc`` per unit of every
library, all at once.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

from ..analysis.sanitizer import make_lock

_PKG = Path(__file__).resolve().parent
BUILD_DIR = _PKG.parents[2] / "build" / "kernels"  # <checkout>/build/kernels

# the head dims the attention kernels are built for: those of the
# reference's registry (16 in every reduced config, 64, 112, 128, 192, 256)
# and of its kernel tests (32); HEAD_DIMS in flash_attn.cu and decode_attn.cu
ATTN_HEAD_DIMS = (16, 32, 64, 112, 128, 192, 256)

# library name -> its CUDA sources
SOURCES: dict[str, tuple[Path, ...]] = {
    "seg_agg": (_PKG / "seg_agg" / "csrc" / "seg_agg.cu",),
    "flash_attn": (_PKG / "flash_attn" / "csrc" / "flash_attn.cu",),
    "decode_attn": (_PKG / "decode_attn" / "csrc" / "decode_attn.cu",),
    "ssd_scan": (_PKG / "ssd_scan" / "csrc" / "ssd_scan.cu",),
}

# library name -> the -D flags of each compilation unit of every source
# (absent: one unit without flags)
_PER_HEAD_DIM = ((), *((f"-DHEAD_DIM={dh}",) for dh in ATTN_HEAD_DIMS))
DEFINES: dict[str, tuple[tuple[str, ...], ...]] = {
    "flash_attn": _PER_HEAD_DIM,
    "decode_attn": _PER_HEAD_DIM,
}

# shared headers, included by the sources with a relative path
HEADERS: tuple[Path, ...] = tuple(sorted((_PKG / "csrc").glob("*.cuh")))

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOCK = make_lock("kernels.build._LOCK")
_LOADED: dict[str, ctypes.CDLL] = {}  # guarded-by: _LOCK


def nvcc() -> str:
    """Path of the CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on
    the PATH, else the toolkit's default install location."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and (Path(home) / "bin" / "nvcc").exists():
        return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on the PATH")


def units(name: str) -> list[tuple[Path, tuple[str, ...]]]:
    """The compilation units of library ``name``: (source, -D flags)."""
    return [(src, flags) for src in SOURCES[name] for flags in DEFINES.get(name, ((),))]


def library_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src, flags in units(name):
        h.update(" ".join(flags).encode())
        h.update(src.read_bytes())
    for src in HEADERS:
        h.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


class Job:
    """The build of one shared library from its units: every unit's
    ``nvcc -c`` started at construction, the link in ``finish``."""

    def __init__(self, unit_list, out: Path, what: str):
        self.out, self.what = out, what
        out.parent.mkdir(parents=True, exist_ok=True)
        self.tmp = out.with_suffix(f".{os.getpid()}.tmp")
        self.objs, self.procs = [], []
        for i, (src, flags) in enumerate(unit_list):
            obj = out.with_suffix(f".{os.getpid()}.{i}.o")
            self.objs.append(obj)
            self.procs.append(subprocess.Popen(
                [nvcc(), *NVCC_FLAGS, *flags, "-c", "-o", str(obj), str(src)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))

    def finish(self) -> None:
        """Wait for the units, link, and put the library in place (the
        build log, every unit's ptxas report, beside it)."""
        logs, failed = [], []
        for proc in self.procs:
            log, _ = proc.communicate()
            logs.append(log)
            if proc.returncode != 0:
                failed.append(proc.returncode)
        if not failed:
            link = subprocess.run([nvcc(), *NVCC_FLAGS[:2], "-shared", "-o", str(self.tmp),
                                   *map(str, self.objs)], capture_output=True, text=True)
            logs.append(link.stdout + link.stderr)
            if link.returncode != 0:
                failed.append(link.returncode)
        for obj in self.objs:
            obj.unlink(missing_ok=True)
        log = "".join(logs)
        self.out.with_suffix(".log").write_text(log)
        if failed:
            self.tmp.unlink(missing_ok=True)
            raise RuntimeError(f"nvcc failed for {self.what} (exit {failed[0]}):\n{log}")
        os.replace(self.tmp, self.out)  # atomic: a reader never sees a half-written library


def build_all(names=None) -> dict[str, float]:
    """Compile every library that is not built yet, one ``nvcc`` per unit,
    all started together.  Returns the seconds each build took (0.0 for a
    library that was already there)."""
    names = list(SOURCES) if names is None else list(names)
    t0 = time.perf_counter()
    started = {n: Job(units(n), library_path(n), n) for n in names
               if not library_path(n).exists()}
    secs = {n: 0.0 for n in names}
    failed = []
    for n, job in started.items():
        try:
            job.finish()
        except RuntimeError as e:  # the other builds still finish: one report for all
            failed.append(str(e))
        secs[n] = time.perf_counter() - t0
    if failed:
        raise RuntimeError("\n".join(failed))
    return secs


def load(name: str) -> ctypes.CDLL:
    """The loaded library, built first if needed."""
    with _LOCK:
        lib = _LOADED.get(name)
        if lib is None:
            if not library_path(name).exists():
                build_all([name])
            lib = _LOADED[name] = ctypes.CDLL(str(library_path(name)))
        return lib
