"""The port's distribution layer against the JAX package's, on the CPU.

* Spec parity: for every leaf of every assigned config, on both production
  meshes, the port's placements give the local shard shape of JAX's
  ``tree_param_specs``, and the ZeRO-1 moments that of ``opt_state_specs``
  (arithmetic on the mesh's shape: no devices).
* Offsets: on a 2 x 4 mesh, every rank's shard starts where JAX's
  ``NamedSharding.devices_indices_map`` starts it (JAX in a subprocess on 8
  host devices, the port on a fake process group, rank by rank).
* Bytes: ``dryrun.argument_bytes`` of every ``train_4k`` cell equals JAX's
  spec arithmetic.
* JAX's own cases: ``zero1_spec``, ``plan_remesh``, ``StragglerPolicy`` and
  the restart controller (``tests/test_training_distributed.py``).
* ``hint`` is a no-op without a context.
* Four gloo ranks on a (data 2, model 2) mesh train 2 steps of reduced
  qwen3-32b, gemma-2b (one KV head), kimi-k2 (experts split) and zamba2
  (the ``mamba`` stack and ``shared_attn``) from JAX's converted init, and
  equal JAX's ``make_train_step`` at ``test_train_matches_jax``'s
  tolerances: losses rtol 1e-5, parameters atol 1e-3 (f32, lr 1e-3).  The
  ranks run this file as a script (``--worker``), which imports no JAX.
"""
import dataclasses
import json
import math
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.distributed.elastic import (DeviceLossError, ElasticController,
                                             StragglerPolicy, plan_remesh)
from repro_torch.distributed.sharding import (P, batch_axes, hint, local_shape,
                                              sharding_hints, tree_param_specs)
from repro_torch.training.optimizer import opt_state_specs, stacked_specs, zero1_spec

ROOT = Path(__file__).resolve().parents[1]
STACKED = ("layers", "dense_layers", "mamba")
MESHES = {"single": {"data": 16, "model": 16}, "multi": {"pod": 2, "data": 16, "model": 16}}
GLOO_ARCHS = ("qwen3-32b", "gemma-2b", "kimi-k2-1t-a32b", "zamba2-7b")
GLOO_LR, GLOO_STEPS, GLOO_BATCH, GLOO_SEQ = 1e-3, 2, 4, 32


def _jax_named_specs(tree) -> dict:
    import jax
    from jax.sharding import PartitionSpec as JP

    flat = jax.tree_util.tree_flatten_with_path(tree, is_leaf=lambda x: isinstance(x, JP))[0]
    return {"/".join(str(p.key) for p in path): leaf for path, leaf in flat}


def _jax_shapes(jcfg) -> dict:
    import jax

    from repro.models.model import ShapeLeaf

    flat = jax.tree_util.tree_flatten_with_path(
        jcfg.param_shapes(), is_leaf=lambda x: isinstance(x, ShapeLeaf))[0]
    return {"/".join(str(p.key) for p in path): leaf for path, leaf in flat}


def _entries(spec) -> tuple:
    return tuple(spec)


def _assigned():
    from repro_torch.configs.registry import ASSIGNED

    return ASSIGNED


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", _assigned())
def test_param_and_moment_shards_equal_jax(arch, mesh):
    """Every stacked leaf: the port's spec is JAX's (a stack's per-layer
    spec with JAX's leading None), the same local shard shape, and the same
    ZeRO-1 moment spec and shard."""
    from repro.configs.registry import get as jget
    from repro.distributed.sharding import tree_param_specs as jtree_param_specs
    from repro.models.model import shapes_to_struct as jstruct
    from repro.training.optimizer import opt_state_specs as jopt_state_specs
    from repro_torch.configs.registry import get

    ms = MESHES[mesh]
    jcfg, cfg = jget(arch), get(arch)
    baxes = batch_axes(tuple(ms))
    data = math.prod(ms[a] for a in baxes)
    jshapes = _jax_shapes(jcfg)
    jspecs_tree = jtree_param_specs(jcfg.param_shapes(), ms["model"], STACKED)
    jspecs = _jax_named_specs(jspecs_tree)
    jmom = _jax_named_specs(jopt_state_specs(
        jspecs_tree, jstruct(jcfg.param_shapes(), jcfg.dtype), baxes, data)["m"])

    pshapes = cfg.param_shapes()
    specs = tree_param_specs(pshapes, ms["model"], STACKED)
    by_name = stacked_specs(specs, pshapes)
    mom = opt_state_specs(specs, pshapes, baxes, data)["m"]
    assert sorted(by_name) == sorted(jspecs)
    for name, (shape, spec) in by_name.items():
        assert shape == tuple(jshapes[name].shape), name
        assert _entries(spec) == _entries(jspecs[name]), name
        assert local_shape(shape, spec, ms) == local_shape(shape, _entries(jspecs[name]), ms)
        assert _entries(mom[name]) == _entries(jmom[name]), name
        assert local_shape(shape, mom[name], ms) == \
            local_shape(shape, _entries(jmom[name]), ms), name


def _jax_train_bytes(arch, mesh, zero3: bool = False) -> int:
    """Rank 0's argument bytes of JAX's train_4k cell by its specs: params
    in their dtypes, f32 moments, the int32 step, the batch.  ``zero3``:
    the reference's ``zero3_params`` variant, whose parameters and moments
    both take ``opt_state_specs(...)["m"]``."""
    import jax.numpy as jnp

    from repro.configs.registry import get as jget
    from repro.configs.shapes import SHAPES as JSHAPES
    from repro.distributed.sharding import tree_param_specs as jtree_param_specs
    from repro.models.model import shapes_to_struct as jstruct
    from repro.training.optimizer import opt_state_specs as jopt_state_specs

    ms = MESHES[mesh]
    jcfg = jget(arch)
    baxes = batch_axes(tuple(ms))
    data = math.prod(ms[a] for a in baxes)
    spec_tree = jtree_param_specs(jcfg.param_shapes(), ms["model"], STACKED)
    struct = jstruct(jcfg.param_shapes(), jcfg.dtype)
    specs, shapes = _jax_named_specs(spec_tree), _jax_shapes(jcfg)
    mom = _jax_named_specs(jopt_state_specs(spec_tree, struct, baxes, data)["m"])

    def nbytes(shape, dtype, spec):
        return math.prod(local_shape(tuple(shape), _entries(spec), ms)) * \
            jnp.dtype(dtype).itemsize

    total = 4  # step
    for name, leaf in shapes.items():
        total += nbytes(leaf.shape, leaf.dtype or jcfg.dtype, (mom if zero3 else specs)[name])
        total += 2 * nbytes(leaf.shape, jnp.float32, mom[name])
    shape = JSHAPES["train_4k"]
    b, s = shape.global_batch, shape.seq_len
    bspec = (baxes if len(baxes) > 1 else baxes[0],)
    total += nbytes((b, s), jnp.int32, bspec)  # labels
    if jcfg.embed_inputs:
        total += nbytes((b, s, jcfg.d_model), jcfg.dtype, bspec)
    else:
        total += nbytes((b, s), jnp.int32, bspec)
    return total


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", _assigned())
def test_train_argument_bytes_equal_jax_spec_arithmetic(arch, mesh):
    from repro_torch.configs.registry import get
    from repro_torch.launch.dryrun import argument_bytes

    assert argument_bytes(get(arch), "train_4k", MESHES[mesh]) == _jax_train_bytes(arch, mesh)


# ------------------------------------------------------------------ offsets

OFFSET_CASES = [
    ((64, 48), P("model", None)),
    ((48, 64), P(None, "model")),
    ((8, 48, 64), P(None, "data", "model")),
    ((3, 8, 4, 16, 8), P(None, None, None, ("data", "model"), None)),
    ((16, 12), P("data", None)),
    ((6, 10), P(None, None)),
]


def _port_offsets(shape, spec, mesh_shape) -> dict:
    """{rank: (start per dim)} of the port's DTensor layout, on a fake
    process group of the mesh's size, rank by rank."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from repro_torch.distributed.sharding import global_offset, to_placements

    world = math.prod(mesh_shape.values())
    out = {}
    for rank in range(world):
        dist.init_process_group("fake", store=FakeStore(), rank=rank, world_size=world)
        try:
            mesh = init_device_mesh("cpu", tuple(mesh_shape.values()),
                                    mesh_dim_names=tuple(mesh_shape))
            pls = to_placements(spec, mesh)
            size, off = compute_local_shape_and_global_offset(shape, mesh, pls)
            assert tuple(off) == global_offset(shape, pls, mesh)
            assert tuple(size) == local_shape(shape, spec, mesh_shape,
                                              dict(zip(mesh_shape, mesh.get_coordinate())))
            out[rank] = [[o, o + n] for o, n in zip(off, size)]
        finally:
            dist.destroy_process_group()
    return out


def test_shard_offsets_equal_jax_devices_indices_map():
    """JAX's ``devices_indices_map`` on a 2 x 4 (data, model) mesh of 8 host
    devices, device (i, j) = rank 4 i + j, against the port's shards."""
    mesh_shape = {"data": 2, "model": 4}
    code = textwrap.dedent(f"""
        import json, os
        os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
        import jax, numpy as np
        from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
        mesh = Mesh(np.asarray(jax.devices()[:8]).reshape(2, 4), ("data", "model"))
        out = []
        for shape, spec in {[(s, tuple(p)) for s, p in OFFSET_CASES]!r}:
            idx = NamedSharding(mesh, P(*spec)).devices_indices_map(tuple(shape))
            by_rank = {{}}
            for (i, j), d in np.ndenumerate(mesh.devices):
                by_rank[4 * i + j] = [[s.start or 0, shape[k] if s.stop is None else s.stop]
                                      for k, s in enumerate(idx[d])]
            out.append(by_rank)
        print(json.dumps(out))
    """)
    env = {**os.environ, "JAX_PLATFORMS": "cpu", "PYTHONPATH": str(ROOT / "src")}
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, env=env)
    assert res.returncode == 0, res.stderr[-2000:]
    want = json.loads(res.stdout.strip().splitlines()[-1])
    for (shape, spec), jax_map in zip(OFFSET_CASES, want):
        got = _port_offsets(shape, spec, mesh_shape)
        assert {int(k): v for k, v in jax_map.items()} == got, (shape, spec)


# ---------------------------------------------------------- JAX's own cases


def test_zero1_spec_adds_data_axis():
    assert zero1_spec(P(None, "model"), (1024, 64), ("data",), 16) == P("data", "model")
    assert zero1_spec(P(None,), (7,), ("data",), 16) == P(None)
    assert zero1_spec(P(None, "model"), (64, 32), ("pod", "data"), 32) == \
        P(("pod", "data"), "model")


def test_plan_remesh():
    p = plan_remesh(512, 16)
    assert p.shape == (2, 16, 16) and p.axis_names == ("pod", "data", "model")
    p = plan_remesh(496, 16)  # lost a node: 31 data rows, no pod split
    assert p.shape == (31, 16)
    with pytest.raises(ValueError):
        plan_remesh(8, 16)


def test_plan_remesh_agrees_with_jax_over_device_counts():
    from repro.distributed.elastic import plan_remesh as jplan_remesh

    for n in (1, 2, 3, 4, 8, 16, 31, 64, 256, 496, 512):
        for mp in (1, 2, 4, 16):
            if n < mp:
                continue
            assert dataclasses.astuple(plan_remesh(n, mp)) == \
                dataclasses.astuple(jplan_remesh(n, mp))


@pytest.fixture
def one_rank_group(tmp_path):
    import torch.distributed as dist

    dist.init_process_group("gloo", store=dist.FileStore(str(tmp_path / "store"), 1),
                            rank=0, world_size=1)
    yield
    dist.destroy_process_group()


def test_elastic_restart_controller(one_rank_group):
    calls = []

    def run_fn(mesh):
        calls.append((tuple(mesh.shape), mesh.mesh_dim_names))
        return {"ok": True}

    def injector(restart):
        if restart == 0:
            raise DeviceLossError([])  # lose nothing, just force restart

    ctl = ElasticController(run_fn, model_parallel=1, device_type="cpu")
    out = ctl.run(fail_injector=injector)
    assert out["ok"] and ctl.restarts == 1
    assert calls == [((1, 1), ("data", "model"))]


def test_straggler_policy():
    pol = StragglerPolicy(deadline_factor=2.0, strikes_to_exclude=3)
    for _ in range(10):
        pol.observe(0, 1.0)
    for _ in range(3):
        pol.observe(7, 10.0)  # persistent straggler
    assert pol.excluded_hosts() == [7]


def test_hint_is_a_no_op_without_a_context():
    x = torch.randn(2, 3, 4)
    assert hint(x, "residual") is x
    with sharding_hints({"residual": P("data", None, None)}):
        assert hint(x, "residual") is x  # a plain tensor: nothing to lay out


# ------------------------------------------------------ four gloo ranks


def _worker(rank: int, world: int, workdir: str, arch: str, zero3: bool) -> None:
    """One rank of the parity run: the port's sharded train step on a
    (data 2, model 2) mesh from ``init.pt`` (``zero3``: the parameters
    stacked in their moments' layout); rank 0 writes ``out.pt``."""
    import torch.distributed as dist

    from repro_torch.configs.registry import reduced
    from repro_torch.distributed.elastic import build_mesh
    from repro_torch.kernels.ssd_scan import ref as ssd
    from repro_torch.training.optimizer import AdamWConfig
    from repro_torch.training.train_lib import (TrainConfig, gather_train_state,
                                                make_train_step, shard_train_state)

    # JAX's Mamba2 gradient runs on its sequential scan (the chunked one is
    # NaN there): the port's plain scan, under its kernel wrapper, does too
    ssd.ssd_chunked = lambda x, dt, A, Bm, Cm, chunk=128: ssd.ssd_ref(x, dt, A, Bm, Cm)[0]
    dist.init_process_group("gloo", store=dist.FileStore(os.path.join(workdir, "store"),
                                                         world), rank=rank, world_size=world)
    try:
        data = torch.load(os.path.join(workdir, "init.pt"), weights_only=False)
        cfg = dataclasses.replace(reduced(arch), vocab=4096, dtype=torch.float32)
        mesh = build_mesh(plan_remesh(world, 2, prefer_pods=False), device_type="cpu")
        params, opt = shard_train_state(cfg, data["params"], mesh, zero3=zero3)
        step = make_train_step(cfg, TrainConfig(opt=AdamWConfig(lr=GLOO_LR, warmup_steps=2)),
                               mesh=mesh)
        losses = []
        for batch in data["batches"]:
            loss, _, params, opt, _ = step(params, opt, batch)
            losses.append(float(loss.full_tensor()))
        whole, _ = gather_train_state(params, opt)
        if rank == 0:
            torch.save({"losses": losses, "params": whole}, os.path.join(workdir, "out.pt"))
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("arch", GLOO_ARCHS)
def test_four_rank_train_steps_equal_jax(arch, tmp_path, monkeypatch):
    four_ranks_against_jax(arch, tmp_path, monkeypatch)


def four_ranks_against_jax(arch, tmp_path, monkeypatch, zero3: bool = False) -> None:
    """Four gloo ranks' ``GLOO_STEPS`` steps of reduced ``arch`` against
    JAX's ``make_train_step``: losses rtol 1e-5, parameters atol 1e-3."""
    import jax
    import jax.numpy as jnp

    import repro.models.mamba2 as jmamba2
    from repro.configs.registry import reduced as jreduced
    from repro.kernels.ssd_scan.ref import ssd_ref as jssd_ref
    from repro.training.optimizer import AdamWConfig as JAdamWConfig
    from repro.training.optimizer import init_opt_state as jinit_opt_state
    from repro.training.train_lib import TrainConfig as JTrainConfig
    from repro.training.train_lib import make_train_step as jmake_train_step
    from repro_torch.configs.registry import reduced
    from repro_torch.models.convert import params_from_jax, params_to_jax

    monkeypatch.setattr(jmamba2, "ssd_scan",
                        lambda x, dt, A, Bm, Cm, chunk=128: jssd_ref(x, dt, A, Bm, Cm)[0])
    jcfg = dataclasses.replace(jreduced(arch), vocab=4096, dtype=jnp.float32)
    cfg = dataclasses.replace(reduced(arch), vocab=4096, dtype=torch.float32)
    jparams = jcfg.build().init_params(jcfg, jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    batches = []
    for _ in range(GLOO_STEPS):
        toks = rng.integers(0, cfg.vocab, (GLOO_BATCH, GLOO_SEQ)).astype(np.int32)
        labels = np.where(rng.random(toks.shape) < 0.2, -1, np.roll(toks, -1, 1))
        batches.append({"tokens": toks, "labels": labels.astype(np.int32)})
    torch.save({"params": params_from_jax(cfg, jax.tree.map(np.asarray, jparams), device="cpu"),
                "batches": batches}, tmp_path / "init.pt")

    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    procs = [subprocess.Popen([sys.executable, __file__, "--worker", str(r), "4",
                               str(tmp_path), arch, str(int(zero3))], env=env,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for r in range(4)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=240)[0])
    finally:
        for p in procs:
            p.kill()
    assert all(p.returncode == 0 for p in procs), "\n".join(x[-3000:] for x in logs)
    got = torch.load(tmp_path / "out.pt", weights_only=False)

    step = jax.jit(jmake_train_step(jcfg, JTrainConfig(
        opt=JAdamWConfig(lr=GLOO_LR, warmup_steps=2))))
    p, o, jlosses = jparams, jinit_opt_state(jparams), []
    for batch in batches:
        loss, _, p, o, _ = step(p, o, {k: jnp.asarray(v) for k, v in batch.items()})
        jlosses.append(float(loss))
    np.testing.assert_allclose(got["losses"], jlosses, rtol=1e-5)
    want = {"/".join(str(k.key) for k in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(p)[0]}
    mine = {"/".join(str(k.key) for k in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(
                params_to_jax(cfg, got["params"]))[0]}
    assert sorted(mine) == sorted(want)
    for name in want:
        np.testing.assert_allclose(mine[name], want[name], atol=1e-3, err_msg=name)


if __name__ == "__main__" and sys.argv[1:2] == ["--worker"]:
    _worker(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5], sys.argv[6] == "1")
