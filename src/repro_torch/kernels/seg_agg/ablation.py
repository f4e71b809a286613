"""Where the filter-fused aggregation kernel's (kernel B's) time goes, on
the card.

Builds ``csrc/seg_agg.cu`` again with one part taken out at a time and
times kernel B in each build beside the full kernel at the serve phase's
shapes over ``--rows`` rows: the dashboard refresh's shared scan (M 3, P 1,
6 signatures, G 5) and single-signature misses of 5, 250 and 6250 groups
(per-warp, per-thread, per-block and per-block slots).  A diagnostic for work on the
kernel (``kernels/ablation.py`` has the mechanism); nothing on the serving
path imports it.

    PYTHONPATH=src python -m repro_torch.kernels.seg_agg.ablation

Parts:

    no_prefetch    each row tile waits for its own copies (no overlap)
    one_row        each thread tests (and a warp hands off) one row at a time, not 4
    no_accumulate  no row reaches a slot (the tests and staging alone)
    warp_slots     per-warp slots wherever they fit two blocks per SM
    block_slots    per-block slots with shared atomics at every slot count
"""
from __future__ import annotations

import argparse
import ctypes
import json
from pathlib import Path

import torch

from ..ablation import build_variants, card, device_ms

SRC = Path(__file__).resolve().parent / "csrc" / "seg_agg.cu"

PARTS: dict[str, list[tuple[str, str]]] = {
    "no_prefetch": [("ptx::cp_async_commit();  // the next tile's copies run under",
                     "ptx::cp_async_commit(); ptx::cp_async_wait<0>(); __syncthreads(); //")],
    "one_row": [("constexpr int kRowsPerThread = 4;", "constexpr int kRowsPerThread = 1;")],
    "no_accumulate": [("add_warp<OP, kRowsPerThread>(wslots, key, v, m);", ""),
                      ("        while (any) {", "        while (false) {")],
    "warp_slots": [("if (2 * (fixed + bytes * kFusedThreads) <= kSmemLimit) {", "if (false) {"),
                   ("} else if (s_count > 1 && 2 * (fixed + bytes * kFusedWarps)",
                    "} else if (2 * (fixed + bytes * kFusedWarps)")],
    "block_slots": [("if (2 * (fixed + bytes * kFusedThreads) <= kSmemLimit) {", "if (false) {"),
                    ("} else if (s_count > 1 && 2 * (fixed + bytes * kFusedWarps)",
                     "} else if (false && 2 * (fixed + bytes * kFusedWarps)")],
}

# (M, G, P, S): the dashboard's shared scan, then single-signature misses
SHAPES = ((3, 5, 1, 6), (2, 5, 1, 1), (2, 250, 1, 1), (2, 6250, 1, 1))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", type=int, default=6_000_000)
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA GPU")
    libs = build_variants(SRC, PARTS, [None, *PARTS])
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    for lib in libs.values():
        lib.seg_agg_fused_launch.argtypes = [P, P, P, P, P, L, I, I, I, I, I, I, P, P, P]
        lib.seg_agg_fused_launch.restype = I
        lib.seg_agg_fused_plan.argtypes = [L, I, I, I, I, I, I, ctypes.POINTER(L)]
        lib.seg_agg_fused_plan.restype = I
    dev = torch.device("cuda", torch.cuda.current_device())
    gen = torch.Generator(device=dev).manual_seed(0)
    n = args.rows
    bar = torch.zeros(2, dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    for m, g, p, s in SHAPES:
        v = torch.rand(n, m, generator=gen, device=dev)
        ids = torch.randint(0, g, (n,), generator=gen, device=dev, dtype=torch.int32)
        pred = torch.randint(8000, 10600, (n, p), generator=gen, device=dev).float()
        b = torch.tensor([[[[8035.0 + 365 * i, 8035.0 + 365 * i + 364]]] * p
                          for i in range(s)], device=dev)
        out = torch.empty(s, g, m, device=dev)
        row = {}
        for name, lib in libs.items():
            work = L(0)
            tier = lib.seg_agg_fused_plan(n, m, p, 1, s, g, 0, ctypes.byref(work))
            ws = torch.empty(max(work.value, 1), device=dev)

            def call(lib=lib, ws=ws):
                rc = lib.seg_agg_fused_launch(v.data_ptr(), ids.data_ptr(), pred.data_ptr(),
                                              b.data_ptr(), out.data_ptr(), n, m, p, 1, s, g,
                                              0, stream, ws.data_ptr(), bar.data_ptr())
                if rc:
                    raise RuntimeError(f"launch failed: CUDA error {rc}")
            row[f"{name} (tier {tier})"] = device_ms(call, args.iters)
        print(json.dumps({"shape": f"values ({n},{m}) pred ({n},{p}) S={s} G={g} sum",
                          "device_ms": row, "card": card()}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
