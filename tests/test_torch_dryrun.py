"""The port's dry-run (``repro_torch.launch.dryrun``) on the CPU.

Reduced configs of every family (dense qwen3-32b, MoE kimi-k2, SSM
mamba2, hybrid zamba2) trace the train step, prefill and decode on a fake
(data 2, model 2) and (pod 2, data 2, model 2) process group, each cell
``ok``, its ``argument_bytes`` equal to the spec arithmetic of
``dryrun.argument_bytes``.  The cell list is JAX's 64; the fake group is
refused beside a live one; the launcher writes its records; an unknown
variant is refused and ``no_zero1`` and ``zero3_params`` run; a kernel
wrapper handed a CUDA tensor inside the dry-run raises.
"""
import json

import pytest
import torch

from repro_torch.configs.registry import ASSIGNED, SUBQUADRATIC, reduced
from repro_torch.configs.shapes import SHAPES
from repro_torch.launch import dryrun

FAMILIES = ("qwen3-32b", "kimi-k2-1t-a32b", "mamba2-780m", "zamba2-7b")
SMALL_MESHES = {"2x2": {"data": 2, "model": 2}, "2x2x2": {"pod": 2, "data": 2, "model": 2}}
BATCH, SEQ = 8, 64


@pytest.mark.parametrize("mesh", sorted(SMALL_MESHES))
@pytest.mark.parametrize("shape", ("train_4k", "prefill_32k", "decode_32k"))
@pytest.mark.parametrize("arch", FAMILIES)
def test_reduced_cells_are_ok(arch, shape, mesh):
    cfg = reduced(arch)
    ms = SMALL_MESHES[mesh]
    r = dryrun.run_cell(arch, shape, mesh, cfg=cfg, mesh_shape=ms, global_batch=BATCH,
                        seq_len=SEQ)
    assert r["status"] == "ok" and r["mesh_shape"] == ms
    mem = r["memory"]
    assert mem["peak_bytes"] >= mem["argument_bytes"] > 0 and mem["output_bytes"] > 0
    assert r["flops_global"] >= r["flops_per_device"] > 0
    assert mem["argument_bytes"] == dryrun.argument_bytes(cfg, shape, ms, global_batch=BATCH,
                                                          seq_len=SEQ)
    if shape == "train_4k":
        # the moments' reduce-scatter and the gradients' all-reduce
        assert r["collectives"]["count_by_kind"].get("all-reduce", 0) > 0
        assert r["collectives"]["total_bytes"] > 0


@pytest.mark.parametrize("arch", ("mamba2-780m", "zamba2-7b"))
def test_reduced_long_context_cells_are_ok(arch):
    """long_500k: one sequence, its caches split along their slots over the
    whole mesh, the token and positions whole."""
    cfg, ms = reduced(arch), SMALL_MESHES["2x2"]
    r = dryrun.run_cell(arch, "long_500k", "2x2", cfg=cfg, mesh_shape=ms, global_batch=1,
                        seq_len=SEQ)
    assert r["status"] == "ok"
    assert r["memory"]["argument_bytes"] == dryrun.argument_bytes(
        cfg, "long_500k", ms, global_batch=1, seq_len=SEQ)


def test_moe_train_cell_with_tokens_on_every_rank():
    """Batch 4 over (pod 2, data 2, model 2): DTensor reduces the MoE
    tokens' gradient to a split over all 8 ranks unless it is pinned to the
    tokens' layout, and the view back to (B, S, D) then fails (kimi-k2's
    full-size train_4k cell on the 2 x 16 x 16 mesh did)."""
    cfg, ms = reduced("kimi-k2-1t-a32b"), SMALL_MESHES["2x2x2"]
    r = dryrun.run_cell("kimi-k2-1t-a32b", "train_4k", "2x2x2", cfg=cfg, mesh_shape=ms,
                        global_batch=4, seq_len=16)
    assert r["status"] == "ok"


def test_cells_are_jaxs_sixty_four():
    got = list(dryrun.cells())
    assert len(got) == len(set(got)) == 64
    want = {(a, s, m) for a in ASSIGNED for s in SHAPES for m in ("single", "multi")
            if s != "long_500k" or a in SUBQUADRATIC}
    assert set(got) == want


def test_a_live_process_group_is_refused(tmp_path):
    import torch.distributed as dist

    dist.init_process_group("gloo", store=dist.FileStore(str(tmp_path / "s"), 1), rank=0,
                            world_size=1)
    try:
        with pytest.raises(RuntimeError, match="process group"):
            dryrun.run_cell("mamba2-780m", "decode_32k", "single", cfg=reduced("mamba2-780m"),
                            mesh_shape={"data": 2, "model": 2}, global_batch=4, seq_len=16)
    finally:
        dist.destroy_process_group()


def test_launcher_writes_a_record_per_cell(tmp_path, capsys):
    out = tmp_path / "dry.json"
    res = dryrun.main(["--arch", "canonicalizer-100m", "--shape", "decode_32k",
                       "--mesh", "single", "--out", str(out)])
    rec = json.loads(out.read_text())["canonicalizer-100m|decode_32k|single"]
    assert rec == res["canonicalizer-100m|decode_32k|single"] and rec["status"] == "ok"
    assert rec["mesh_shape"] == {"data": 16, "model": 16}
    assert "1/1 cells ok" in capsys.readouterr().out


def test_variants_are_refused_or_run():
    with pytest.raises(ValueError, match="variant"):
        dryrun.run_cell("gemma-2b", "train_4k", "single", variant="zero2")
    cfg, ms = reduced("qwen3-32b"), {"data": 2, "model": 2}
    base = dryrun.run_cell("qwen3-32b", "train_4k", "x", cfg=cfg, mesh_shape=ms,
                           global_batch=BATCH, seq_len=SEQ)
    no_z = dryrun.run_cell("qwen3-32b", "train_4k", "x", cfg=cfg, mesh_shape=ms,
                           global_batch=BATCH, seq_len=SEQ, variant="no_zero1")
    # ZeRO-1 halves the moments over the data axis
    assert no_z["memory"]["argument_bytes"] > base["memory"]["argument_bytes"]
    assert no_z["memory"]["argument_bytes"] == dryrun.argument_bytes(
        cfg, "train_4k", ms, "no_zero1", global_batch=BATCH, seq_len=SEQ)
    # ZeRO-3 halves the parameters too
    z3 = dryrun.run_cell("qwen3-32b", "train_4k", "x", cfg=cfg, mesh_shape=ms,
                         global_batch=BATCH, seq_len=SEQ, variant="zero3_params")
    assert z3["status"] == "ok"
    assert z3["memory"]["argument_bytes"] < base["memory"]["argument_bytes"]
    assert z3["memory"]["argument_bytes"] == dryrun.argument_bytes(
        cfg, "train_4k", ms, "zero3_params", global_batch=BATCH, seq_len=SEQ)


def test_a_cuda_tensor_in_the_dry_run_raises():
    from repro_torch.kernels.binding import on_cuda, plain_only

    class FakeCuda:
        device = torch.device("cuda", 0)

    with plain_only("the dry-run"), pytest.raises(RuntimeError, match="dry-run"):
        on_cuda("flash_attention", FakeCuda())
    assert on_cuda("flash_attention", torch.zeros(1)) is False
