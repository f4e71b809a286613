"""Where the SSD-scan kernel's time goes, on the card.

Builds ``csrc/ssd_scan.cu`` again with one part taken out at a time and
times each build beside the full kernel, bf16 x with the final state, at
mamba2-780m's prefill of 8 prompts of ``--plen`` tokens (48 heads, P 64, N
128) and at the engine's ceiling of ``--cache`` tokens.  A diagnostic for
work on the kernel (``kernels/ablation.py`` has the mechanism); nothing on
the serving path imports it.

    PYTHONPATH=src python -m repro_torch.kernels.ssd_scan.ablation

Parts:

    no_lo        the two small products of every split product (hi hi only)
    no_cb        G = C Bᵀ (shared by the heads; G stays what it was)
    no_inter     the carried state's part of y, S Cᵀ
    no_intra     the masked product M x (M is still formed)
    no_update    the state update (x w)ᵀ B
    no_prefetch  each chunk waits for its own copies (no overlap)
"""
from __future__ import annotations

import argparse
import ctypes
import json
from pathlib import Path

import torch

from ..ablation import build_variants, card, device_ms

SRC = Path(__file__).resolve().parent / "csrc" / "ssd_scan.cu"

PARTS: dict[str, list[tuple[str, str]]] = {
    "no_lo": [("if constexpr (!kAExact) ptx::mma_bf16(d, a.lo, h0, h1);", ""),
              ("ptx::mma_bf16(d, a.hi, l0, l1);", ""),
              ("if constexpr (!kAExact) ptx::mma_tf32(d, a.lo[h], c0.hi, c1.hi);", ""),
              ("ptx::mma_tf32(d, a.hi[h], c0.lo, c1.lo);", "")],
    "no_cb": [("if (tr < len) {", "if (false) {")],
    "no_inter": [("if (c > 0) {", "if (false) {")],
    "no_intra": [("Ops::template mma<kXExact>(accY[nt], af, bb);", "accY[nt][0] += bb[0];")],
    "no_update": [("Ops::template mma<false>(accS[nn], af, bb);", "accS[nn][0] += bb[0];")],
    "no_prefetch": [("ptx::cp_async_commit();  // the next chunk's copies run under",
                     "ptx::cp_async_commit(); ptx::cp_async_wait<0>(); __syncthreads(); //")],
}


def main(argv=None) -> int:
    from . import ref

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--plen", type=int, default=77)
    ap.add_argument("--cache", type=int, default=512)
    ap.add_argument("--iters", type=int, default=100)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA GPU")
    libs = build_variants(SRC, PARTS, [None, *PARTS])
    P, I = ctypes.c_void_p, ctypes.c_int
    for lib in libs.values():
        lib.ssd_scan_launch.argtypes = [P, P, P, P, P, P, P, I, I, I, I, I, I, P]
        lib.ssd_scan_launch.restype = I
    b, h, p, n = 8, 48, 64, 128
    dev = torch.device("cuda", torch.cuda.current_device())
    gen = torch.Generator(device=dev).manual_seed(0)
    for s in (args.plen, args.cache):
        x = torch.randn(b, s, h, p, generator=gen, device=dev).to(torch.bfloat16)
        dt = 0.001 + 2.0 * torch.rand(b, s, h, generator=gen, device=dev)
        A = -1.0 - 7.0 * torch.rand(h, generator=gen, device=dev)
        Bm, Cm = (torch.randn(b, s, n, generator=gen, device=dev) for _ in range(2))
        y, state = torch.empty_like(x), torch.empty(b, h, p, n, device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        row = {}
        for name, lib in libs.items():
            def call(lib=lib):
                rc = lib.ssd_scan_launch(x.data_ptr(), dt.data_ptr(), A.data_ptr(),
                                         Bm.data_ptr(), Cm.data_ptr(), y.data_ptr(),
                                         state.data_ptr(), b, h, s, p, n, 1, stream)
                if rc:
                    raise RuntimeError(f"launch failed: CUDA error {rc}")
            row[name] = device_ms(call, args.iters)
        row["plain"] = device_ms(lambda: (ref.ssd_chunked(x, dt, A, Bm, Cm),
                                          ref.ssd_final_state(x, dt, A, Bm)),
                                 max(3, args.iters // 10))
        print(json.dumps({"shape": f"x ({b},{s},{h},{p}) bf16 B/C ({b},{s},{n}), state out",
                          "device_ms": row, "card": card()}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
