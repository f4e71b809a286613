"""The ``zero3_params`` variant (stacked DTensor parameters laid out by their
ZeRO-1 moment specs) against the JAX package, on the CPU.

* Bytes: ``dryrun.argument_bytes`` of every assigned config's train_4k,
  prefill_32k and decode_32k cell under the variant, on both production
  meshes, equals the reference's spec arithmetic (parameters and moments
  both under ``opt_state_specs(...)["m"]``; its ``cache_specs`` for the
  decode caches).
* Reduced cells of every family trace on fake (data 2, model 2) and (pod
  2, data 2, model 2) groups: ``ok``, their arguments as the arithmetic,
  one all-gather of each data-split parameter per step (not one per
  layer) and, for train, the gradients' reduce-scatter.
* One gloo rank: the ZeRO-3 step equals the per-layer plain step bit for
  bit (bf16, microbatches 1 and 2, with and without compression).
* Four gloo ranks (data 2, model 2) train reduced kimi-k2 (the
  ``dense_layers`` and ``layers`` stacks) and zamba2 (``mamba`` and
  ``shared_attn``) under ``zero3=True`` as JAX's ``make_train_step`` does.
"""
import dataclasses
import math
import os

import numpy as np
import pytest
import torch
from test_torch_distributed import (MESHES, STACKED, _entries, _jax_named_specs, _jax_shapes,
                                    _jax_train_bytes, _assigned, four_ranks_against_jax)

from repro_torch.configs.registry import reduced
from repro_torch.distributed.sharding import batch_axes, local_shape
from repro_torch.launch import dryrun

FAMILIES = ("qwen3-32b", "kimi-k2-1t-a32b", "mamba2-780m", "zamba2-7b")
SMALL_MESHES = {"2x2": {"data": 2, "model": 2}, "2x2x2": {"pod": 2, "data": 2, "model": 2}}
BATCH, SEQ = 8, 64


class _JaxMesh:
    """What the reference's ``cache_specs`` reads of a mesh, without devices."""

    def __init__(self, mesh_shape: dict):
        self.shape = dict(mesh_shape)
        self.axis_names = tuple(mesh_shape)


def _reference_cache_specs():
    """The reference dry-run's ``cache_specs``.  Its module sets XLA_FLAGS
    to 512 host devices when imported; that is undone at once, before any
    backend reads it."""
    before = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch.dryrun import cache_specs
    finally:
        if before is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = before
    return cache_specs


def _jax_serve_bytes(arch, mesh, shape_name) -> int:
    """Rank 0's argument bytes of the reference's prefill or decode cell
    under ``zero3_params``, by its specs: the parameters under their ZeRO-1
    moment specs; the batch, or the token, positions and caches."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec

    from repro.configs.registry import get as jget
    from repro.configs.shapes import SHAPES as JSHAPES
    from repro.configs.shapes import input_specs
    from repro.distributed.sharding import tree_param_specs as jtree_param_specs
    from repro.models.model import shapes_to_struct as jstruct
    from repro.training.optimizer import opt_state_specs as jopt_state_specs

    ms = MESHES[mesh]
    jcfg = jget(arch)
    baxes = batch_axes(tuple(ms))
    b_ax = baxes if len(baxes) > 1 else baxes[0]
    data = math.prod(ms[a] for a in baxes)
    spec_tree = jtree_param_specs(jcfg.param_shapes(), ms["model"], STACKED)
    mom = _jax_named_specs(jopt_state_specs(
        spec_tree, jstruct(jcfg.param_shapes(), jcfg.dtype), baxes, data)["m"])

    def nbytes(shape, dtype, spec):
        return math.prod(local_shape(tuple(shape), _entries(spec), ms)) * \
            jnp.dtype(dtype).itemsize

    total = sum(nbytes(leaf.shape, leaf.dtype or jcfg.dtype, mom[name])
                for name, leaf in _jax_shapes(jcfg).items())
    shape = JSHAPES[shape_name]
    ins = input_specs(jcfg, shape)
    if shape.kind == "prefill":
        return total + sum(nbytes(v.shape, v.dtype, (b_ax,)) for v in ins.values())
    tok = (b_ax,) if shape.global_batch >= 32 else (None,)
    total += nbytes(ins["token"].shape, jnp.int32, tok) + nbytes(ins["pos"].shape, jnp.int32, tok)
    specs = _reference_cache_specs()(jcfg, ins["caches"], b_ax, _JaxMesh(ms), False)
    leaves = jax.tree.leaves(ins["caches"])
    spec_leaves = jax.tree.leaves(specs, is_leaf=lambda x: isinstance(x, PartitionSpec))
    assert len(leaves) == len(spec_leaves)
    return total + sum(nbytes(t.shape, t.dtype, s) for t, s in zip(leaves, spec_leaves))


@pytest.mark.parametrize("shape", ("train_4k", "prefill_32k", "decode_32k"))
@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", _assigned())
def test_zero3_argument_bytes_equal_jax_spec_arithmetic(arch, mesh, shape):
    from repro_torch.configs.registry import get

    got = dryrun.argument_bytes(get(arch), shape, MESHES[mesh], "zero3_params")
    want = (_jax_train_bytes(arch, mesh, zero3=True) if shape == "train_4k"
            else _jax_serve_bytes(arch, mesh, shape))
    assert got == want


def _param_bytes(arch: str, variant: str) -> int:
    """Rank 0's parameter bytes, single pod, by the port's layout."""
    from repro_torch.configs.registry import get
    from repro_torch.training.optimizer import stacked_specs

    cfg, ms = get(arch), MESHES["single"]
    pshapes, pspecs, ospecs = dryrun._cell_layout(cfg, ms, variant)
    f32 = cfg.build().FLOAT32_LEAVES
    total = 0
    for name, (shape, spec) in stacked_specs(pspecs, pshapes).items():
        dtype = torch.float32 if name.rsplit("/", 1)[-1] in f32 else cfg.dtype
        total += dryrun._shard_bytes(shape, dtype, ospecs[name] if variant == "zero3_params"
                                     else spec, ms)
    return total


@pytest.mark.parametrize("arch, baseline_gb, zero3_gb", [
    ("nemotron-4-340b", "532", "33.2"), ("qwen3-32b", "51.3", "3.21"),
    ("gemma-2b", "3.71", "0.232")])
def test_zero3_splits_the_parameters_over_the_data_axis(arch, baseline_gb, zero3_gb):
    assert f"{_param_bytes(arch, 'baseline') / 1e9:.3g}" == baseline_gb
    assert f"{_param_bytes(arch, 'zero3_params') / 1e9:.3g}" == zero3_gb


def _data_split_leaves(cfg, ms) -> int:
    """Stacked leaves whose ZeRO-3 spec splits a dim over a batch axis."""
    baxes = set(batch_axes(tuple(ms)))
    _, _, ospecs = dryrun._cell_layout(cfg, ms, "zero3_params")
    return sum(any(set(_entries_of(e)) & baxes for e in spec) for spec in ospecs.values())


def _entries_of(entry) -> tuple:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def _batch_axis_count(rec, ms) -> int:
    by_axis = rec["collectives"]["count_by_axis"]
    return sum(by_axis.get(a, 0) for a in batch_axes(tuple(ms)))


@pytest.mark.parametrize("mesh", sorted(SMALL_MESHES))
@pytest.mark.parametrize("shape", ("train_4k", "prefill_32k", "decode_32k"))
@pytest.mark.parametrize("arch", FAMILIES)
def test_reduced_zero3_cells_are_ok(arch, shape, mesh):
    cfg, ms = reduced(arch), SMALL_MESHES[mesh]
    kw = dict(cfg=cfg, mesh_shape=ms, global_batch=BATCH, seq_len=SEQ)
    r = dryrun.run_cell(arch, shape, mesh, variant="zero3_params", **kw)
    assert r["status"] == "ok" and r["variant"] == "zero3_params"
    mem = r["memory"]
    assert mem["peak_bytes"] >= mem["argument_bytes"] > 0
    assert mem["argument_bytes"] == dryrun.argument_bytes(
        cfg, shape, ms, "zero3_params", global_batch=BATCH, seq_len=SEQ)
    assert mem["argument_bytes"] < dryrun.argument_bytes(cfg, shape, ms, global_batch=BATCH,
                                                         seq_len=SEQ)
    coll = r["collectives"]
    assert coll["count_by_kind"].get("all-gather", 0) > 0
    assert sum(coll["count_by_axis"].values()) == sum(coll["count_by_kind"].values())
    if shape == "train_4k":
        assert coll["count_by_kind"].get("reduce-scatter", 0) > 0
    else:
        # each data-split stacked leaf is gathered once per step, not once
        # per layer: one all-gather per batch axis splitting it at most
        base = dryrun.run_cell(arch, shape, mesh, **kw)
        n, k = _data_split_leaves(cfg, ms), len(batch_axes(tuple(ms)))
        extra = _batch_axis_count(r, ms) - _batch_axis_count(base, ms)
        assert 0 < n <= extra <= n * k, (n, extra)


# ------------------------------------------------------------- one rank


@pytest.fixture
def one_rank_mesh(tmp_path):
    import torch.distributed as dist

    from repro_torch.distributed.elastic import build_mesh, plan_remesh

    dist.init_process_group("gloo", store=dist.FileStore(str(tmp_path / "store"), 1),
                            rank=0, world_size=1)
    yield build_mesh(plan_remesh(1, 1), device_type="cpu")
    dist.destroy_process_group()


@pytest.mark.parametrize("microbatches, compression", [(1, False), (1, True), (2, False),
                                                       (2, True)])
def test_zero3_step_on_one_rank_is_the_plain_step_bit_for_bit(one_rank_mesh, microbatches,
                                                              compression):
    """One rank runs the plain step's ops on the same values: the layer by
    layer norm, the elementwise update in the stacked layout and the
    stacked compression give its bits."""
    from repro_torch.models import transformer as tt
    from repro_torch.training.optimizer import init_opt_state, stacked_leaves
    from repro_torch.training.train_lib import (TrainConfig, gather_train_state,
                                                make_train_step, shard_train_state)

    cfg = dataclasses.replace(reduced("canonicalizer-100m"), dtype=torch.bfloat16)
    gen = torch.Generator().manual_seed(0)
    params = tt.init_params(cfg, 0, device="cpu")
    for lp in params["layers"]:  # per-layer vectors start at zero: make them differ
        for k in lp:
            lp[k] = lp[k] + (0.01 * torch.randn(lp[k].shape, generator=gen)).to(lp[k].dtype)
    rng = np.random.default_rng(0)
    batches = [{k: rng.integers(0, cfg.vocab, (4, 16)).astype(np.int32)
                for k in ("tokens", "labels")} for _ in range(3)]
    tcfg = TrainConfig(microbatches=microbatches, grad_compression=compression)

    plain, p, o, r = make_train_step(cfg, tcfg), params, init_opt_state(params), None
    want = []
    for b in batches:
        loss, gnorm, p, o, r = plain(p, o, {k: torch.as_tensor(v) for k, v in b.items()}, r)
        want.append((loss, gnorm))
    step, r = make_train_step(cfg, tcfg, mesh=one_rank_mesh), None
    q, s = shard_train_state(cfg, params, one_rank_mesh, zero3=True)
    assert set(q) == {name for name, _ in stacked_leaves(params)}
    assert q["layers/wq"].shape == (cfg.n_layers, *params["layers"][0]["wq"].shape)
    got = []
    for b in batches:
        loss, gnorm, q, s, r = step(q, s, b, r)
        got.append((loss.full_tensor(), gnorm))
    for (gl, gn), (wl, wn) in zip(got, want):
        assert torch.equal(gl, wl) and torch.equal(gn, wn)
    gp, go = gather_train_state(q, s)
    for tree, ref in ((gp, p), (go["m"], o["m"]), (go["v"], o["v"])):
        for (name, xs), (_, ys) in zip(stacked_leaves(tree), stacked_leaves(ref)):
            assert all(torch.equal(x, y) for x, y in zip(xs, ys)), name


# ------------------------------------------------------ four gloo ranks


@pytest.mark.parametrize("arch", ("kimi-k2-1t-a32b", "zamba2-7b"))
def test_four_rank_zero3_train_steps_equal_jax(arch, tmp_path, monkeypatch):
    four_ranks_against_jax(arch, tmp_path, monkeypatch, zero3=True)
