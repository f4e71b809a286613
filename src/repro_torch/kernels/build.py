"""Build and load the port's CUDA kernels.

Each kernel source under ``kernels/<name>/csrc/`` is compiled by ``nvcc``
for Hopper (``sm_90a``) into a shared library with a plain C interface and
loaded with ``ctypes``.  Libraries go to ``build/kernels/`` at the root of
the checkout (listed in ``.gitignore``), named by a digest of the source and
the flags, so an edited source is rebuilt and an unchanged one is not.  The
headers under ``kernels/csrc/`` that the sources include are hashed into
every library's name, so an edited header rebuilds them all.
Nothing is built when a module is imported: the first launch builds what it
needs, and ``build_all`` starts one ``nvcc`` per source, all at once.
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

# library name -> its CUDA sources
SOURCES: dict[str, tuple[Path, ...]] = {
    "seg_agg": (_PKG / "seg_agg" / "csrc" / "seg_agg.cu",),
    "flash_attn": (_PKG / "flash_attn" / "csrc" / "flash_attn.cu",),
    "decode_attn": (_PKG / "decode_attn" / "csrc" / "decode_attn.cu",),
    "ssd_scan": (_PKG / "ssd_scan" / "csrc" / "ssd_scan.cu",),
}

# shared headers, included by the sources with a relative path
HEADERS: tuple[Path, ...] = tuple(sorted((_PKG / "csrc").glob("*.cuh")))

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

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


def library_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in (*SOURCES[name], *HEADERS):
        h.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def _start(name: str) -> tuple[subprocess.Popen, Path, Path]:
    out = library_path(name)
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, SOURCES[name])]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish(name: str, proc: subprocess.Popen, tmp: Path, out: Path) -> None:
    log, _ = proc.communicate()
    out.with_suffix(".log").write_text(log)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for {name} (exit {proc.returncode}):\n{log}")
    os.replace(tmp, out)  # atomic: a reader never sees a half-written library


def build_all(names=None) -> dict[str, float]:
    """Compile every library that is not built yet, one ``nvcc`` per
    library, all started together.  Returns the seconds each build took
    (0.0 for a library that was already there)."""
    names = list(SOURCES) if names is None else list(names)
    t0 = time.perf_counter()
    started = {n: _start(n) for n in names if not library_path(n).exists()}
    secs = {n: 0.0 for n in names}
    for n, job in started.items():
        _finish(n, *job)
        secs[n] = time.perf_counter() - t0
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
