"""How far each float32 form of the SSD scan's final state lies from a
float64 sequential scan, at long sequences and large dt.

``ssd_final_state`` (the plain version the JAX package also has) weighs
step t by exp(cum_S - cum_t), with cum the cumulative sum of A dt over the
whole sequence: at S = 4096 and dt up to 2 the sum reaches about -2e4,
where float32 resolves only ~2e-3, so the weights of the last steps carry
relative errors of that size.  The sequential ``ssd_ref`` multiplies one
step's decay at a time and stays near float32 rounding.  On a CUDA device
(``--device cuda``) the SSD-scan kernel (chunks of 32, the state carried)
is read too.  Inputs are drawn as ``chip_smoke.py``'s SSD sweep draws them
(x, B normal; dt in [0.001, 0.001 + dt_hi); A in (-8, -1)).  Prints one
JSON line per trial: the max abs error of each form against float64, and
that error over chip_smoke's float32 tolerance (1e-3 + 1e-3 |want|; above 1
fails the check).

    PYTHONPATH=src python benchmarks/bench_torch_ssd_precision.py [--device cuda]
"""
from __future__ import annotations

import argparse
import json

import torch

from repro_torch.kernels.ssd_scan import ref as SR


def sequential_f64(x, dt, A, Bm):
    """The final state by the recurrence, in float64."""
    b, s, h, p = x.shape
    x, dt, A, Bm = (t.double() for t in (x, dt, A, Bm))
    state = torch.zeros((b, h, p, Bm.shape[-1]), dtype=torch.float64, device=x.device)
    for t in range(s):
        decay = torch.exp(A[None] * dt[:, t])[..., None, None]
        state = state * decay + dt[:, t, :, None, None] * x[:, t, :, :, None] \
            * Bm[:, t, None, None, :]
    return state


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--seq", type=int, default=4096)
    ap.add_argument("--heads", type=int, default=8)
    ap.add_argument("--dt-hi", type=float, default=2.0)
    ap.add_argument("--trials", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    dev = torch.device(args.device)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    b, s, h, p, n = 1, args.seq, args.heads, 64, 128
    for trial in range(args.trials):
        x = torch.randn(b, s, h, p, generator=gen, device=dev)
        dt = 0.001 + torch.rand(b, s, h, generator=gen, device=dev) * args.dt_hi
        A = -1.0 - 7.0 * torch.rand(h, generator=gen, device=dev)
        Bm = torch.randn(b, s, n, generator=gen, device=dev)
        want = sequential_f64(x, dt, A, Bm)
        forms = {"ssd_final_state": SR.ssd_final_state(x, dt, A, Bm),
                 "ssd_ref": SR.ssd_ref(x, dt, A, Bm, Bm)[1]}
        if dev.type == "cuda":
            from repro_torch.kernels.ssd_scan import kernel as SK

            forms["kernel"] = SK.ssd_scan_cuda(x, dt, A, Bm, Bm, return_state=True)[1]
        row = {"trial": trial, "S": s, "H": h, "dt_hi": args.dt_hi,
               "state_absmax": float(want.abs().max())}
        for name, got in forms.items():
            err = (got.double() - want).abs()
            row[name] = {"max_abs_err": float(err.max()),
                         "over_tol": float((err / (1e-3 + 1e-3 * want.abs())).max())}
        print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
