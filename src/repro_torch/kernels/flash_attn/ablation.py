"""Where the bf16 flash kernel's time goes, on the card.

Builds ``csrc/flash_attn.cu`` again with one part of its tile step
(``kernels/csrc/attn_tile.cuh``) taken out at a time, and times each build
beside the full kernel and SDPA at the serving engine's prefill shape (8
prompts of ``--plen`` tokens, 12 heads over 4 KV heads, head dim 64) and
at its ceiling (``--cache`` tokens).
A diagnostic for work on the kernel; nothing on the serving path imports
it.  The ablated builds compute wrong outputs by design: only their device
times are read.

    PYTHONPATH=src python -m repro_torch.kernels.flash_attn.ablation

Parts (each replaces lines of the sources; a part whose lines are no
longer there fails the run):

    no_qk     the Q K^T products (the logits stay 0)
    no_pv     the P V products
    no_lo     the second P V product of the hi/lo split of p
    no_exp    exp2 of the logits
    one_tile  every query tile stops after its first K tile
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
from pathlib import Path

import torch

from .. import build
from ..ablation import card, device_ms

_SRC = Path(__file__).resolve().parent / "csrc" / "flash_attn.cu"
_TILE = _SRC.parents[2] / "csrc" / "attn_tile.cuh"  # the tile step it shares

# part -> (text in the kernel source or its tile step, its replacement)
PARTS: dict[str, list[tuple[str, str]]] = {
    "no_qk": [("ptx::mma_bf16(s[2 * np], qf[ks], kf[0], kf[1]);",
               "s[2 * np][0] += __uint_as_float(kf[0] & 1u);"),
              ("ptx::mma_bf16(s[2 * np + 1], qf[ks], kf[2], kf[3]);",
               "s[2 * np + 1][0] += __uint_as_float(kf[2] & 1u);")],
    "no_pv": [(f"ptx::mma_bf16(r.o[n{j}], {p}, vf[{r}], vf[{r + 1}]);",
               f"r.o[n{j}][0] += __uint_as_float(({p}[0] ^ vf[{r}]) & 1u);")
              for j, r in (("", 0), (" + 1", 2)) for p in ("hi", "lo")],
    "no_lo": [(f"ptx::mma_bf16(r.o[n{j}], lo, vf[{r}], vf[{r + 1}]);", "")
              for j, r in (("", 0), (" + 1", 2))],
    "no_exp": [(f"s[j][{e}] = ptx::exp2_approx(s[j][{e}] - mn{e // 2});",
                f"s[j][{e}] = s[j][{e}] - mn{e // 2};") for e in range(4)],
    "one_tile": [("const int n_tiles = (k_end + kBK - 1) / kBK;", "const int n_tiles = 1;")],
}


def _sources(part: str | None) -> tuple[str, str]:
    """The kernel source and its tile step with ``part`` taken out, the
    source including the tile step beside it."""
    ptx = f'#include "{_TILE.parent}/hopper_ptx.cuh"'
    cu = _SRC.read_text().replace('#include "../../csrc/attn_tile.cuh"',
                                  '#include "attn_tile.cuh"')
    cu = cu.replace('#include "../../csrc/hopper_ptx.cuh"', ptx)
    tile = _TILE.read_text().replace('#include "hopper_ptx.cuh"', ptx)
    for old, new in PARTS.get(part, []):
        if old in cu:
            cu = cu.replace(old, new)
        elif old in tile:
            tile = tile.replace(old, new)
        else:
            raise RuntimeError(f"ablation {part}: the sources no longer have {old!r}")
    return cu, tile


def build_variants(parts) -> dict[str, ctypes.CDLL]:
    """One library per part (None: the full kernel), built in parallel."""
    jobs = {}
    for part in parts:
        name = part or "full"
        out_dir = build.BUILD_DIR / "ablation" / name
        out_dir.mkdir(parents=True, exist_ok=True)
        cu, tile = _sources(part)
        (out_dir / "attn_tile.cuh").write_text(tile)
        (out_dir / "flash_attn.cu").write_text(cu)
        so = out_dir / "libflash_attn.so"
        jobs[name] = (subprocess.Popen(
            [build.nvcc(), *build.NVCC_FLAGS, "-o", str(so), str(out_dir / "flash_attn.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), so)
    libs = {}
    for name, (proc, so) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for ablation {name}:\n{log}")
        lib = libs[name] = ctypes.CDLL(str(so))
        P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.flash_attn_launch.argtypes = [P, P, P, P, I, I, I, I, I, I, F, I, P]
        lib.flash_attn_launch.restype = I
    return libs


def main(argv=None) -> int:
    import torch.nn.functional as F

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--plen", type=int, default=77)
    ap.add_argument("--cache", type=int, default=512)
    ap.add_argument("--iters", type=int, default=200)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA GPU")
    libs = build_variants([None, *PARTS])
    b, h, hkv, dh = 8, 12, 4, 64
    dev = torch.device("cuda", torch.cuda.current_device())
    gen = torch.Generator(device=dev).manual_seed(0)
    for s in (args.plen, args.cache):
        q = torch.randn(b, h, s, dh, generator=gen, device=dev).to(torch.bfloat16)
        k, v = (torch.randn(b, hkv, s, dh, generator=gen, device=dev).to(torch.bfloat16)
                for _ in range(2))
        out = torch.empty_like(q)
        stream = torch.cuda.current_stream(dev).cuda_stream
        row = {}
        for name, lib in libs.items():
            def call(lib=lib):
                rc = lib.flash_attn_launch(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                           out.data_ptr(), b, h, hkv, s, dh, 1, dh ** -0.5,
                                           1, stream)
                if rc:
                    raise RuntimeError(f"launch failed: CUDA error {rc}")
            row[name] = device_ms(call, args.iters)
        row["sdpa"] = device_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True, enable_gqa=True), args.iters)
        print(json.dumps({"shape": f"q ({b},{h},{s},{dh}) k/v ({b},{hkv},{s},{dh}) bf16 causal",
                          "device_ms": row, "card": card()}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
