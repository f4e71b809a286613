"""Where the bf16 flash kernels' time goes, on the card.

Forward: builds ``csrc/flash_attn.cu`` again with one part of its tile
step (``kernels/csrc/attn_tile.cuh``) taken out at a time, and times each
build beside the full kernel and SDPA at the serving engine's prefill
shape (8 prompts of ``--plen`` tokens, 12 heads over 4 KV heads, head dim
64) and at its ceiling (``--cache`` tokens).

Backward: builds ``csrc/flash_attn_bwd.cu`` the same way (``BWD_PARTS``;
head dims 64, 112 and 128 only) and times each build beside the full
kernel and SDPA's backward at the training shapes (``BWD_SHAPES``: batch
16, S 192; canonicalizer-100m's 12/4 heads of 64, zamba2-7b's 32/32 of
112, qwen3-moe's 64/4 of 128).

A diagnostic for work on the kernels; nothing on the serving or training
path imports it.  The ablated builds compute wrong outputs by design:
only their device times are read.

    PYTHONPATH=src python -m repro_torch.kernels.flash_attn.ablation [--only forward|backward]

Parts (each replaces lines of the sources; a part whose lines are no
longer there fails the run).  Forward:

    no_qk     the Q K^T products (the logits stay 0)
    no_pv     the P V products
    no_lo     the second P V product of the hi/lo split of p
    no_exp    exp2 of the logits
    one_tile  every query tile stops after its first K tile

Backward:

    no_logits  the products of the logits and of dP (S, S^T, dP, dP^T)
    no_grads   the products into dQ, dK and dV (hi and lo)
    no_lo      the lo halves of those products
    no_exp     exp2 (the logsumexp pass and P)
    one_tile   the dQ kernel walks one K tile per pass, the dK/dV kernel
               one query tile
    dq_only    the dK/dV kernel is not launched
    dkdv_only  the dQ kernel is not launched
"""
from __future__ import annotations

import argparse
import ctypes
import json
from pathlib import Path

import torch

from .. import ablation, build
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


_BWD_SRC = _SRC.parent / "flash_attn_bwd.cu"
BWD_HEAD_DIMS = (64, 112, 128)
# (batch, heads, KV heads, S, head dim), causal
BWD_SHAPES = ((16, 12, 4, 192, 64), (16, 32, 32, 192, 112), (16, 64, 4, 192, 128))
# every backward variant is built for BWD_HEAD_DIMS alone
_BWD_COMMON = [("#define HEAD_DIMS(X) X(16) X(32) X(64) X(112) X(128) X(192) X(256)",
                "#define HEAD_DIMS(X) " + " ".join(f"X({d})" for d in BWD_HEAD_DIMS))]
_NO_MMA = "{acc}[0] += __uint_as_float(({a}[0] ^ {b}) & 1u);"  # keeps the fragments live
BWD_PARTS: dict[str, list[tuple[str, str]]] = {
    "no_logits": [(f"ptx::mma_bf16(acc[2 * np{j}], af, bf[{r}], bf[{r + 1}]);",
                   _NO_MMA.format(acc=f"acc[2 * np{j}]", a="af", b=f"bf[{r}]"))
                  for j, r in (("", 0), (" + 1", 2))],
    "no_grads": [(f"ptx::mma_bf16(acc[n{j}], {h}, mf[{r}], mf[{r + 1}]);",
                  _NO_MMA.format(acc=f"acc[n{j}]", a=h, b=f"mf[{r}]"))
                 for j, r in (("", 0), (" + 1", 2)) for h in ("hi", "lo")],
    "no_lo": [(f"ptx::mma_bf16(acc[n{j}], lo, mf[{r}], mf[{r + 1}]);", "")
              for j, r in (("", 0), (" + 1", 2))],
    "no_exp": [(f"rs{i} += ptx::exp2_approx(s[j][{2 * i}] - mn{i}) + "
                f"ptx::exp2_approx(s[j][{2 * i + 1}] - mn{i});",
                f"rs{i} += (s[j][{2 * i}] - mn{i}) + (s[j][{2 * i + 1}] - mn{i});")
               for i in (0, 1)]
              + [("const float p = ptx::exp2_approx(s[j][e] - (e < 2 ? m0 : m1));",
                  "const float p = s[j][e] - (e < 2 ? m0 : m1);"),
                 ("ptx::exp2_approx(fmaf(s[j][e], scale2, -tl[c]))",
                  "fmaf(s[j][e], scale2, -tl[c])")],
    "one_tile": [("const int n_tiles = (k_end + kBK - 1) / kBK;", "const int n_tiles = 1;"),
                 ("const int steps = group * nq;", "const int steps = 1;")],
    "dq_only": [(f"  {k}<<<", f"  if (false) {k}<<<") for k in ("flash_bwd_dkdv_bf16_kernel<DH>",)],
    "dkdv_only": [(f"  {k}<<<", f"  if (false) {k}<<<") for k in ("flash_bwd_dq_bf16_kernel<DH>",)],
}


def build_bwd_variants(parts) -> dict[str, ctypes.CDLL]:
    """One backward library per part (None: the full kernel), built in
    parallel for ``BWD_HEAD_DIMS``."""
    units = ((), *((f"-DHEAD_DIM={dh}",) for dh in BWD_HEAD_DIMS))
    libs = ablation.build_variants(_BWD_SRC, BWD_PARTS, parts, units, _BWD_COMMON)
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    for lib in libs.values():
        lib.flash_attn_bwd_launch.argtypes = [P] * 9 + [I] * 6 + [F, I, P]
        lib.flash_attn_bwd_launch.restype = I
    return libs


def backward_rows(iters: int) -> list[dict]:
    """Device ms per call of each backward variant and of SDPA's backward
    at each of ``BWD_SHAPES`` (bf16, causal)."""
    import torch.nn.functional as F

    libs = build_bwd_variants([None, *BWD_PARTS])
    dev = torch.device("cuda", torch.cuda.current_device())
    gen = torch.Generator(device=dev).manual_seed(0)
    rows = []
    for b, h, hkv, s, dh in BWD_SHAPES:
        q, o, do = (torch.randn(b, h, s, dh, generator=gen, device=dev).to(torch.bfloat16)
                    for _ in range(3))
        k, v = (torch.randn(b, hkv, s, dh, generator=gen, device=dev).to(torch.bfloat16)
                for _ in range(2))
        dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
        stats = torch.empty((2, b * h * s), dtype=torch.float32, device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        row = {}
        for name, lib in libs.items():
            def call(lib=lib):
                rc = lib.flash_attn_bwd_launch(
                    q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
                    dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), stats.data_ptr(), b, h, hkv,
                    s, dh, 1, dh ** -0.5, 1, stream)
                if rc:
                    raise RuntimeError(f"launch failed: CUDA error {rc}")
            row[name] = device_ms(call, iters)
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        out = F.scaled_dot_product_attention(*leaves, is_causal=True, enable_gqa=True)
        row["sdpa_bwd"] = device_ms(
            lambda: torch.autograd.grad(out, leaves, do, retain_graph=True), iters)
        rows.append({"shape": f"q ({b},{h},{s},{dh}) k/v ({b},{hkv},{s},{dh}) bf16 causal",
                     "device_ms": row, "card": card()})
    return rows


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
        jobs[name] = (build.Job([(out_dir / "flash_attn.cu", flags)
                                 for flags in build.DEFINES["flash_attn"]], so,
                                f"ablation {name}"), so)
    libs = {}
    for name, (job, so) in jobs.items():
        job.finish()
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
    ap.add_argument("--only", choices=("forward", "backward"), default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA GPU")
    if args.only != "forward":
        for row in backward_rows(args.iters):
            print(json.dumps({"backward": row}), flush=True)
    if args.only == "backward":
        return 0
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
