"""Roofline terms of the port's dry-run records on H100s: the counterpart of
the JAX package's ``benchmarks/roofline.py``, with the same functions and
output keys, over ``results/dryrun_torch.json``
(``python -m repro_torch.launch.dryrun``).

Terms per record (arch x shape x mesh [x variant]):
  compute    = flops_global / (cards x 989 TFLOP/s)
  memory     = bytes_global / (cards x 3.35 TB/s)
  collective = sum over mesh axes of rank 0's collective bytes on the axis
               / the axis's link rate

The rates are NVIDIA's datasheet figures for one H100 SXM at its 700 W
limit, not measurements: dense bf16 989 TFLOP/s, HBM3 3.35 TB/s; NVLink 4
at 450 GB/s per direction per GPU among the 8 GPUs of a node (HGX H100),
and 400 Gb/s NDR InfiniBand, 50 GB/s per GPU, across nodes.  A mesh axis
whose process groups span more than one node of 8 takes the InfiniBand
rate.  Ranks are the mesh's indices in row-major order, 8 consecutive
ranks to a node, so on the production meshes (16 x 16 and 2 x 16 x 16)
every axis does: the 16 ranks of a ``model`` group span two nodes, and the
``data`` and ``pod`` groups stride across nodes.  Every production
collective term is therefore at 50 GB/s; NVLink's rate applies only to an
axis of at most 8 ranks that varies fastest.

FLOPs and bytes are the dry-run's host counts on FakeTensors: FLOPs by
formula, bytes before any fusion (an upper bound on HBM traffic, as the
reference's are); collective bytes are each collective's output on rank 0,
DTensor's choice of collectives.  MODEL_FLOPS is the reference's: 6 N D for
training (N active for MoE), 2 N D for prefill, 2 N B for decode.

Usage:
    python -m repro_torch.launch.roofline [results/dryrun_torch.json]
"""
from __future__ import annotations

import json
import math
import sys

import numpy as np

PEAK_FLOPS = 989e12  # FLOP/s: H100 SXM, dense bf16, datasheet
HBM_BW = 3.35e12  # B/s: H100 SXM HBM3, datasheet
NVLINK_BW = 450e9  # B/s per direction per GPU: NVLink 4 inside an 8-GPU node
IB_BW = 50e9  # B/s per GPU: 400 Gb/s NDR InfiniBand across nodes
NODE = 8  # GPUs per node

CHIPS = {"single": 256, "multi": 512}
TOKENS = {"train_4k": 256 * 4096, "prefill_32k": 32 * 32768,
          "decode_32k": 128, "long_500k": 1}


def model_flops(rec: dict) -> float:
    n = rec["params_active"]
    d = TOKENS[rec["shape"]]
    if rec["shape"] == "train_4k":
        return 6.0 * n * d
    return 2.0 * n * d  # prefill: per prompt token; decode: per new token


def axis_rates(mesh_shape: dict) -> dict:
    """{axis: link rate}: NVLink's where every process group of the axis
    lies inside one node of ``NODE`` ranks, InfiniBand's otherwise."""
    sizes = tuple(mesh_shape.values())
    node = np.arange(math.prod(sizes)).reshape(sizes) // NODE
    out = {}
    for i, axis in enumerate(mesh_shape):
        groups = np.moveaxis(node, i, -1).reshape(-1, sizes[i])
        out[axis] = NVLINK_BW if (groups == groups[:, :1]).all() else IB_BW
    return out


def analyze(rec: dict) -> dict:
    cards = math.prod(rec["mesh_shape"].values())
    fg = rec.get("flops_global") or 0.0
    bg = rec.get("bytes_global") or 0.0
    rates = axis_rates(rec["mesh_shape"])
    by_axis = {a: b / rates.get(a, IB_BW)  # a group of no mesh axis: across nodes
               for a, b in rec["collectives"]["bytes_by_axis"].items()}
    compute_s = fg / (cards * PEAK_FLOPS)
    memory_s = bg / (cards * HBM_BW)
    collective_s = sum(by_axis.values())
    terms = {"compute": compute_s, "memory": memory_s, "collective": collective_s}
    dominant = max(terms, key=terms.get)
    mf = model_flops(rec)
    bound = max(terms.values())
    useful_frac = mf / fg if fg else 0.0
    # roofline fraction: useful-model-compute time over the bound term
    ideal_s = mf / (cards * PEAK_FLOPS)
    frac = ideal_s / bound if bound > 0 else 0.0
    return {
        **{f"{k}_s": v for k, v in terms.items()},
        "collective_s_by_axis": by_axis,
        "dominant": dominant,
        "model_flops": mf,
        "useful_flops_ratio": useful_frac,
        "roofline_fraction": frac,
        "step_bound_s": bound,
    }


_MOVES = {
    "compute": "reduce non-useful FLOPs (plain attention's recompute, MoE capacity "
               "slack) or grow per-card batch to amortize",
    "memory": "cut HBM traffic: the card's fused kernels in place of the plain "
              "versions, KV/state in bf16",
    "collective": "reshard to shrink collective volume: model axis inside a node "
                  "(NVLink), sequence-sharded residual, ZeRO-3 in place of the "
                  "gradients' all-reduce, overlap with compute",
}


def _axes_text(a: dict) -> str:
    return " ".join(f"{k} {v:.2e}" for k, v in sorted(a["collective_s_by_axis"].items()))


def rows(results: dict, mesh: str = "single"):
    out = []
    for key, rec in sorted(results.items()):
        if rec.get("status") != "ok" or rec["mesh"] != mesh:
            continue
        if len(key.split("|")) > 3:  # variants live in their own table
            continue
        out.append((rec, analyze(rec)))
    return out


def variants_table(results: dict):
    """Each variant's record beside its baseline cell's."""
    lines = ["| cell | variant | argument GB | collective GB | collective(s) | compute(s) "
             "| memory(s) | dominant |",
             "|---|---|---|---|---|---|---|---|"]
    for key, rec in sorted(results.items()):
        parts = key.split("|")
        if rec.get("status") != "ok" or len(parts) < 4:
            continue
        for variant, r in (("baseline", results.get("|".join(parts[:3]))), (parts[3], rec)):
            if not r or r.get("status") != "ok":
                continue
            a = analyze(r)
            lines.append(
                f"| {parts[0]} {parts[1]} {parts[2]} | {variant} "
                f"| {r['memory']['argument_bytes'] / 1e9:.3g} "
                f"| {r['collectives']['total_bytes'] / 1e9:.3g} | {a['collective_s']:.2e} "
                f"| {a['compute_s']:.2e} | {a['memory_s']:.2e} | {a['dominant']} |")
    return lines


def report(path: str = "results/dryrun_torch.json", mesh: str = "single"):
    with open(path) as f:
        results = json.load(f)
    lines = [f"## Roofline ({mesh} = {CHIPS[mesh]} H100s; datasheet: 989 TF/s bf16, "
             "3.35 TB/s HBM3, 450 GB/s NVLink 4 in a node of 8, 50 GB/s NDR IB across)",
             "| arch | shape | compute(s) | memory(s) | collective(s) | collective(s) by axis "
             "| dominant | MODEL_FLOPS/counted | roofline frac |",
             "|---|---|---|---|---|---|---|---|---|"]
    csv = []
    for rec, a in rows(results, mesh):
        lines.append(
            f"| {rec['arch']} | {rec['shape']} | {a['compute_s']:.2e} "
            f"| {a['memory_s']:.2e} | {a['collective_s']:.2e} | {_axes_text(a)} "
            f"| {a['dominant']} | {a['useful_flops_ratio']:.2f} "
            f"| {a['roofline_fraction']:.2g} |")
        csv.append((f"roofline_{rec['arch']}_{rec['shape']}_{mesh}",
                    a["step_bound_s"] * 1e6,
                    f"dom={a['dominant']},frac={a['roofline_fraction']:.2g}"))
    lines.append("")
    lines.append("Moves per dominant term: " + "; ".join(
        f"**{k}** -> {v}" for k, v in _MOVES.items()))
    return lines, csv


def cells_table(results: dict):
    """One row per (arch, shape): argument GB and each term, single / multi
    pod, the baseline's first, then each variant's after its name."""
    by_cell: dict = {}
    for key, rec in sorted(results.items()):
        if rec.get("status") == "ok":
            parts = key.split("|")
            variant = parts[3] if len(parts) > 3 else "baseline"
            by_cell.setdefault((rec["arch"], rec["shape"]), {}).setdefault(
                variant, {})[rec["mesh"]] = rec
    lines = ["| arch | shape | argument GB | compute s | memory s | collective s | dominant |",
             "|---|---|---|---|---|---|---|"]
    for (arch, shape), by_variant in by_cell.items():
        cols: list = [[] for _ in range(5)]
        for variant in sorted(by_variant, key=lambda v: v != "baseline"):
            vals: list = [[] for _ in range(5)]
            for mesh in ("single", "multi"):
                r = by_variant[variant].get(mesh)
                a = analyze(r) if r else None
                vals[0].append(f"{r['memory']['argument_bytes'] / 1e9:.3g}" if r else "—")
                for i, k in enumerate(("compute_s", "memory_s", "collective_s"), 1):
                    vals[i].append(f"{a[k]:.3g}" if a else "—")
                vals[4].append(a["dominant"] if a else "—")
            name = "" if variant == "baseline" else f"{variant}: "
            for col, v in zip(cols, vals):
                col.append(name + " / ".join(v))
        lines.append(f"| {arch} | {shape} | " + " | ".join("; ".join(c) for c in cols) + " |")
    return lines


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    path = argv[0] if argv else "results/dryrun_torch.json"
    out = []
    for mesh in ("single", "multi"):
        out += report(path, mesh)[0] + [""]
    with open(path) as f:
        results = json.load(f)
    out += ["## Variants"] + variants_table(results) + [""]
    out += ["## Every cell, single / multi pod"] + cells_table(results)
    print("\n".join(out))
    return out


if __name__ == "__main__":
    main()
