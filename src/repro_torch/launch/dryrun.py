"""Multi-pod dry-run: trace every (arch x shape x mesh) cell of the
distribution config without hardware, the JAX package's
``repro/launch/dryrun.py`` on ``torch.distributed``.

A fake process group of 256 (single pod, 16x16 data x model) or 512 ranks
(multi-pod, 2x16x16) stands in for the fleet; this process is rank 0 of it.
The parameters, optimizer moments, caches and inputs are DTensors of
FakeTensors (nothing is allocated) laid out by the sharding rules
(``distributed.sharding.tree_param_specs`` over every stack, ZeRO-1
``training.optimizer.opt_state_specs``, ``cache_specs``), and the real step
runs on them: the train step (loss, backward, ``adamw_update``),
``prefill`` or ``decode_step``, under the activation hints.  The
``zero3_params`` variant stores the parameters stacked and laid out as
their moments (``sharding.zero3_params``); its step, of every kind, begins
with their gather (``sharding.gather_params``), so the gather's collectives
and its gathered stacks are counted.  Recorded per cell, under the JAX
package's keys where the meaning is the same:

  * ``memory.argument_bytes``: rank 0's shards of every argument (params,
    moments, batch; caches for decode), summed exactly; JAX's int32 step
    counter is 4 bytes of it (the port's counter is a Python int);
    ``memory.peak_bytes``: the peak of live tensors on rank 0 during the
    step (``torch.distributed._tools.mem_tracker.MemTracker``),
    ``output_bytes`` rank 0's outputs, ``temp_bytes`` the peak less the
    arguments;
  * ``flops_per_device``: rank 0's own ops (``torch.utils.flop_counter``'s
    formulas); ``flops_global``: the same formulas on the global shapes of
    every DTensor op, plus each ``local_map`` body (the attention and SSD
    wrappers, the MoE experts) once per shard of the work it splits;
  * ``bytes_accessed_per_device``: the input plus output bytes of each of
    rank 0's ops, views, allocations and collectives left out, before any
    fusion (an upper bound, as XLA's "bytes accessed" is);
    ``bytes_global``: the same on the global shapes of every DTensor op
    (its output's shape from the op run on meta tensors), plus each
    ``local_map`` body's once per shard, as the FLOPs;
  * ``collectives``: bytes (each op's output on rank 0) and counts by kind
    and by mesh axis (``bytes_by_axis``, ``count_by_axis``) of every
    ``torch.ops._c10d_functional`` op the step issues.  The collectives are
    DTensor's choices, not GSPMD's: no parity with the JAX dry-run's counts
    is implied.  ``launch/roofline.py`` turns a record into time terms.

Why the CPU: the JAX dry-run lowers on 512 host CPU devices, where its
kernels take their ``xla`` versions; this one likewise runs the plain
versions on fake CPU tensors, and a kernel wrapper handed a CUDA tensor
raises (``kernels.binding.plain_only``).  The fake process group lives only
inside ``run_cell``; a process group already initialised in this process
is refused.

Usage:
    python -m repro_torch.launch.dryrun --arch qwen3-32b --shape train_4k --mesh single
    python -m repro_torch.launch.dryrun --all --out results/dryrun_torch.json
    python -m repro_torch.launch.dryrun --all --shape train_4k --variant zero3_params
"""
from __future__ import annotations

import argparse
import contextlib
import contextvars
import dataclasses
import json
import math
import os
import time
import traceback

import torch

from ..configs.registry import ASSIGNED, SUBQUADRATIC, get
from ..configs.shapes import SHAPES, input_specs
from ..distributed import local
from ..distributed.sharding import (P, batch_axes, gather_params, local_shape, on_mesh,
                                    to_placements, tree_map_specs, tree_param_specs)
from ..kernels.binding import plain_only
from ..models.model import STACKS, ModelConfig, shapes_to_struct
from ..training.optimizer import (AdamWConfig, adamw_update, opt_state_specs, stack,
                                  stacked_leaves)
from .mesh import make_production_mesh

MESH_SHAPES = {"single": {"data": 16, "model": 16},
               "multi": {"pod": 2, "data": 16, "model": 16}}
VARIANTS = ("baseline", "no_zero1", "kv_seq_shard", "zero1_bf16_gather", "zero3_params")

# ---------------------------------------------------------- the fake group


@contextlib.contextmanager
def fake_process_group(world: int):
    """A fake process group of ``world`` ranks, this process rank 0, for the
    block's length."""
    import torch.distributed as dist

    if dist.is_initialized():
        raise RuntimeError(
            "the dry-run runs on a fake process group of its own, and this process "
            "already has a process group; run it in a process of its own")
    try:
        from torch.testing._internal.distributed.fake_pg import FakeStore
    except ImportError as e:  # an internal module of torch
        raise RuntimeError(
            "the dry-run needs torch.testing._internal.distributed.fake_pg "
            "(the fake process group), which this torch build lacks") from e
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


# ----------------------------------------------------------- the recorder

# set while DTensor runs an op on FakeTensors of the global shapes to learn
# its output's shape (sharding propagation): those ops are no rank's work
_PROPAGATING: contextvars.ContextVar[bool] = contextvars.ContextVar(
    "dtensor_propagating", default=False)


@contextlib.contextmanager
def _marking_propagation():
    """Mark DTensor's shape propagation (``_PROPAGATING``) for the block's
    length.  Under the dry-run's own fake mode its ops look like any other;
    outside a fake mode DTensor runs them in a fake mode of its own, which
    is how ``MemTracker`` tells them apart on real tensors."""
    from torch.distributed.tensor._sharding_prop import ShardingPropagator

    orig = ShardingPropagator._propagate_tensor_meta_non_cached

    def marked(self, *args, **kwargs):
        token = _PROPAGATING.set(True)
        try:
            return orig(self, *args, **kwargs)
        finally:
            _PROPAGATING.reset(token)

    ShardingPropagator._propagate_tensor_meta_non_cached = marked
    try:
        yield
    finally:
        ShardingPropagator._propagate_tensor_meta_non_cached = orig


def _mem_tracker():
    """A ``MemTracker`` that leaves DTensor's shape propagation out."""
    from torch.distributed._tools.mem_tracker import MemTracker

    class Tracker(MemTracker):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if _PROPAGATING.get():
                return func(*args, **(kwargs or {}))
            return super().__torch_dispatch__(func, types, args, kwargs)

    return Tracker()

_KINDS = {"all_reduce": "all-reduce", "all_reduce_coalesced": "all-reduce",
          "all_gather_into_tensor": "all-gather",
          "all_gather_into_tensor_coalesced": "all-gather",
          "reduce_scatter_tensor": "reduce-scatter",
          "reduce_scatter_tensor_coalesced": "reduce-scatter",
          "all_to_all_single": "all-to-all", "broadcast": "broadcast"}


# ops that move no bytes of their own: views, allocations
_NO_BYTES = frozenset({"_unsafe_view", "empty", "empty_like", "empty_strided", "new_empty",
                       "new_empty_strided"})


def _moves_bytes(func) -> bool:
    return not (func.is_view or func.namespace == "_c10d_functional"
                or func._overloadpacket.__name__ in _NO_BYTES)


def _tensor_bytes(tree) -> int:
    """Bytes of the tensors in a pytree, each at its own (for a DTensor:
    global) shape."""
    from torch.utils._pytree import tree_leaves

    return sum(t.numel() * t.element_size() for t in tree_leaves(tree)
               if isinstance(t, torch.Tensor))


def _global_out_bytes(func, args, kwargs) -> int:
    """Output bytes of a DTensor op on its global shapes: the op run on meta
    tensors of those shapes, with every mode of the trace set aside; 0 for
    an op whose output a meta tensor cannot tell (a value read back)."""
    from torch.utils._python_dispatch import _disable_current_modes
    from torch.utils._pytree import tree_map

    def meta(x):
        if isinstance(x, torch.Tensor):
            return torch.empty_strided(tuple(x.shape), tuple(x.stride()), dtype=x.dtype,
                                       device="meta")
        return torch.device("meta") if isinstance(x, torch.device) else x

    with _disable_current_modes():
        margs, mkwargs = tree_map(meta, (args, kwargs))
        try:
            return _tensor_bytes(func(*margs, **mkwargs))
        except (RuntimeError, NotImplementedError):
            return 0


def _recorder_class():
    from torch._guards import active_fake_mode
    from torch.distributed.tensor import DTensor
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils.flop_counter import flop_registry

    class Recorder(TorchDispatchMode):
        """FLOPs and bytes on global and local shapes and the collectives of
        a step.  A DTensor op is counted on its global shapes and handed on
        (``NotImplemented``) to DTensor, whose local ops and collectives
        then come back here; ops of DTensor's own sharding propagation
        (run under a fake mode of its own) are not counted.  ``axes`` maps
        a process group's name to its mesh axis."""

        def __init__(self, axes: dict):
            super().__init__()
            self.axes = axes
            self.flops_global = 0
            self.flops_device = 0
            self.bytes_global = 0
            self.bytes_device = 0
            self.bytes_by_kind: dict[str, int] = {}
            self.count_by_kind: dict[str, int] = {}
            self.bytes_by_axis: dict[str, int] = {}
            self.count_by_axis: dict[str, int] = {}

        def __enter__(self):
            self._fake = active_fake_mode()
            return super().__enter__()

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            pkt = getattr(func, "_overloadpacket", None)
            if any(issubclass(t, DTensor) for t in types):
                if pkt in flop_registry:
                    self.flops_global += flop_registry[pkt](*args, **kwargs, out_val=None)
                if pkt is not None and _moves_bytes(func):
                    self.bytes_global += _tensor_bytes((args, kwargs)) + \
                        _global_out_bytes(func, args, kwargs)
                return NotImplemented
            out = func(*args, **kwargs)
            if pkt is None or _PROPAGATING.get() or active_fake_mode() is not self._fake:
                return out
            if pkt in flop_registry:
                n = flop_registry[pkt](*args, **kwargs, out_val=out)
                self.flops_device += n
                self.flops_global += n * local.split_factor()
            if _moves_bytes(func):
                n = _tensor_bytes((args, kwargs, out))
                self.bytes_device += n
                self.bytes_global += n * local.split_factor()
            if func.namespace == "_c10d_functional" and pkt.__name__ in _KINDS:
                kind = _KINDS[pkt.__name__]
                axis = next((self.axes[a] for a in args if isinstance(a, str) and a in self.axes),
                            "other")
                nbytes = _tensor_bytes(out)
                for by, key in ((self.bytes_by_kind, kind), (self.bytes_by_axis, axis)):
                    by[key] = by.get(key, 0) + nbytes
                for by, key in ((self.count_by_kind, kind), (self.count_by_axis, axis)):
                    by[key] = by.get(key, 0) + 1
            return out

    return Recorder


# ------------------------------------------------------------- the layout


def _axis(mesh, name: str) -> int:
    return mesh.size(mesh.mesh_dim_names.index(name))


def _axes_size(mesh, axes) -> int:
    if isinstance(axes, str):
        return _axis(mesh, axes)
    return math.prod(_axis(mesh, a) for a in axes)


def activation_hints(cfg: ModelConfig, mesh, baxes) -> dict:
    """Baseline activation-sharding hints (the perf pass iterates on these)."""
    model_size = _axis(mesh, "model")
    hints = {"residual": P(baxes, None, None)}
    if cfg.n_heads % model_size == 0 and cfg.kind in ("dense", "moe", "hybrid"):
        hints["attn_heads"] = P(baxes, "model", None, None)
    if cfg.d_ff and cfg.d_ff % model_size == 0:
        hints["mlp_hidden"] = P(baxes, None, "model")
    return hints


def cache_spec_fn(cfg: ModelConfig, baxes, mesh, long_context: bool,
                  kv_seq_shard: bool = False):
    """The spec of a decode cache buffer from its path and shape.  KV caches
    shard batch normally; the long_500k (batch=1) shape shards the sequence
    axis across the whole mesh.  ``kv_seq_shard`` (perf variant):
    additionally shard the KV sequence axis over 'model' — flash-decode
    style — so the model axis reads its own cache slice instead of
    all-gathering the cache when kv_heads < model shards."""
    model_size = _axis(mesh, "model")
    all_axes = tuple(mesh.mesh_dim_names)

    def spec_for(path: str, shape) -> P:
        batch_ok = shape[1] % _axes_size(mesh, baxes) == 0
        b_ax = baxes if batch_ok else None
        if "state" in path:  # (L, B, H, P, N)
            if cfg.ssm_heads % model_size == 0:
                return P(None, b_ax, "model", None, None)
            return P(None, b_ax, None, None, None)
        if "conv" in path:  # (L, B, K-1, di)
            if cfg.d_inner % model_size == 0:
                return P(None, b_ax, None, "model")
            return P(None, b_ax, None, None)
        # KV caches: (L, B, Hkv, S, Dh)
        if long_context:
            return P(None, None, None, all_axes, None)
        if kv_seq_shard:
            return P(None, b_ax, None, "model", None)
        return P(None, b_ax, None, None, None)

    return spec_for


def cache_specs(cfg: ModelConfig, caches_shape, baxes, mesh, long_context: bool,
                kv_seq_shard: bool = False):
    """Specs of a family's decode caches (a tree of tensors or shapes)."""
    spec_for = cache_spec_fn(cfg, baxes, mesh, long_context, kv_seq_shard)

    def walk(tree, path=""):
        if isinstance(tree, dict):
            return {k: walk(v, path + "/" + k) for k, v in tree.items()}
        if isinstance(tree, tuple) and not isinstance(tree[0], int):
            return tuple(walk(v, path) for v in tree)
        return spec_for(path, tuple(getattr(tree, "shape", tree)))

    return walk(caches_shape)


def _cell_layout(cfg: ModelConfig, mesh_shape: dict, variant: str):
    """(param shapes, param specs, moment specs or None) of a cell, by the
    rules alone: what the traced step lays out and ``argument_bytes``
    counts."""
    pshapes = cfg.param_shapes()
    pspecs = tree_param_specs(pshapes, mesh_shape["model"], stacked_prefixes=STACKS)
    baxes = batch_axes(tuple(mesh_shape))
    data = math.prod(mesh_shape[a] for a in baxes)
    ospecs = opt_state_specs(pspecs, pshapes, baxes, data, zero1=(variant != "no_zero1"))["m"]
    return pshapes, pspecs, ospecs


def _shard_bytes(shape, dtype, spec, mesh_shape) -> int:
    return math.prod(local_shape(tuple(shape), spec, mesh_shape)) * \
        torch.empty((), dtype=dtype).element_size()


class _MeshShape:
    """A mesh's axis names and sizes, for the spec functions, without a
    process group."""

    def __init__(self, mesh_shape: dict):
        self.mesh_dim_names = tuple(mesh_shape)
        self._sizes = tuple(mesh_shape.values())

    def size(self, dim: int) -> int:
        return self._sizes[dim]


def argument_bytes(cfg: ModelConfig, shape_name: str, mesh_shape: dict,
                   variant: str = "baseline", global_batch: int | None = None,
                   seq_len: int | None = None) -> int:
    """Rank 0's bytes of a cell's arguments, from the specs alone:
    parameters (under ``zero3_params`` laid out as their moments); for
    train, the ZeRO-1 moments (float32), JAX's int32 step counter and the
    batch split over the batch axes; for prefill the batch; for decode the
    token, the positions and the caches (``cache_specs``)."""
    shape = SHAPES[shape_name]
    base = variant[:-3] if variant.endswith("_sp") else variant
    pshapes, pspecs, ospecs = _cell_layout(cfg, mesh_shape, base)
    f32 = cfg.build().FLOAT32_LEAVES
    from ..training.optimizer import stacked_specs

    total = 0
    for name, (s, spec) in stacked_specs(pspecs, pshapes).items():
        dtype = torch.float32 if name.rsplit("/", 1)[-1] in f32 else cfg.dtype
        stored = ospecs[name] if base == "zero3_params" else spec
        total += _shard_bytes(s, dtype, stored, mesh_shape)
        if shape.kind == "train":
            total += 2 * _shard_bytes(s, torch.float32, ospecs[name], mesh_shape)
    baxes = batch_axes(tuple(mesh_shape))
    b = global_batch or shape.global_batch
    s = seq_len or shape.seq_len
    if shape.kind == "decode":
        from torch._subclasses.fake_tensor import FakeTensorMode

        tok = P(baxes if b >= 32 else None)
        total += 2 * _shard_bytes((b,), torch.int32, tok, mesh_shape)
        with FakeTensorMode():
            caches = cfg.build().make_cache(cfg, b, s, "cpu")
        specs = cache_specs(cfg, caches, baxes if len(baxes) > 1 else baxes[0],
                            _MeshShape(mesh_shape), shape_name == "long_500k",
                            kv_seq_shard=(base == "kv_seq_shard"))
        for t, spec in zip(_tensors(caches), _tensors_like(specs)):
            total += _shard_bytes(t.shape, t.dtype, spec, mesh_shape)
        return total
    bspec = P(baxes, None)
    if cfg.embed_inputs:
        total += _shard_bytes((b, s, cfg.d_model), cfg.dtype, P(baxes, None, None), mesh_shape)
    else:
        total += _shard_bytes((b, s), torch.int32, bspec, mesh_shape)
    if shape.kind == "train":
        total += 4 + _shard_bytes((b, s), torch.int32, bspec, mesh_shape)  # step, labels
    return total


def _tensors_like(specs):
    """The specs of a cache spec tree, in ``_tensors``' order."""
    if isinstance(specs, dict):
        for v in specs.values():
            yield from _tensors_like(v)
    elif isinstance(specs, tuple) and not isinstance(specs, P):
        for v in specs:
            yield from _tensors_like(v)
    else:
        yield specs


def _local_bytes(tree) -> int:
    from torch.distributed.tensor import DTensor

    total = 0
    for t in _tensors(tree):
        t = t.to_local() if isinstance(t, DTensor) else t
        total += t.numel() * t.element_size()
    return total


def _tensors(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)
    elif isinstance(tree, torch.Tensor):
        yield tree


def _sharded_empty(t, spec, mesh, requires_grad=False):
    from torch.distributed.tensor import empty

    return empty(tuple(t.shape), dtype=t.dtype, device_mesh=mesh,
                 placements=to_placements(spec, mesh), requires_grad=requires_grad)


# ----------------------------------------------------------- cell execution


def run_cell(arch: str, shape_name: str, mesh_kind: str, with_opt: bool = True,
             hint_overrides: dict | None = None, variant: str = "baseline", *,
             cfg: ModelConfig | None = None, mesh_shape: dict | None = None,
             global_batch: int | None = None, seq_len: int | None = None) -> dict:
    """Trace one cell and return its record.  ``cfg``, ``mesh_shape``
    (axis -> size, in the mesh's order), ``global_batch`` and ``seq_len``
    replace the arch's config, the production mesh and the shape's sizes
    (small cells for tests)."""
    base = variant[:-3] if variant.endswith("_sp") else variant
    if base not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r}: {VARIANTS} or *_sp")
    cfg = cfg or get(arch)
    shape = SHAPES[shape_name]
    shape = dataclasses.replace(shape, global_batch=global_batch or shape.global_batch,
                                seq_len=seq_len or shape.seq_len)
    mesh_shape = dict(mesh_shape or MESH_SHAPES[mesh_kind])
    world = math.prod(mesh_shape.values())
    t0 = time.time()
    with fake_process_group(world):
        from torch._subclasses.fake_tensor import FakeTensorMode
        from torch.distributed.device_mesh import init_device_mesh

        if mesh_shape == MESH_SHAPES.get(mesh_kind):
            mesh = make_production_mesh(multi_pod=(mesh_kind == "multi"), device_type="cpu")
        else:
            mesh = init_device_mesh("cpu", tuple(mesh_shape.values()),
                                    mesh_dim_names=tuple(mesh_shape))
        baxes = batch_axes(mesh.mesh_dim_names)
        baxes = baxes if len(baxes) > 1 else baxes[0]
        mod = cfg.build()
        hints = activation_hints(cfg, mesh, baxes)
        if variant.endswith("_sp") and shape.kind != "decode":
            # Megatron-style sequence parallelism: residual stream sharded over
            # 'model' on the sequence axis between blocks
            hints["residual"] = P(baxes, "model", None)
        if hint_overrides:
            hints.update(hint_overrides)
        if shape.kind != "train":  # where prefill seeds, and decode reads, its caches
            hints["cache"] = cache_spec_fn(cfg, baxes, mesh, shape_name == "long_500k",
                                           kv_seq_shard=(base == "kv_seq_shard"))
        pshapes, pspecs, ospecs = _cell_layout(cfg, mesh_shape, base)
        zero3 = base == "zero3_params"
        opt_cfg = AdamWConfig()
        axes = {mesh.get_group(i).group_name: a for i, a in enumerate(mesh.mesh_dim_names)}
        with FakeTensorMode(), plain_only("the dry-run"), on_mesh(mesh, hints):
            struct = shapes_to_struct(pshapes, cfg.dtype, mod.FLOAT32_LEAVES)
            train = shape.kind == "train"
            if zero3:
                params = {name: _sharded_empty(stack(name, ts), ospecs[name], mesh)
                          for name, ts in stacked_leaves(struct)}
            else:
                params = tree_map_specs(lambda t, s: _sharded_empty(t, s, mesh, train),
                                        struct, pspecs)

            def layers():  # the parameters as the models read them
                return gather_params(params) if zero3 else params
            ins = input_specs(cfg, shape)
            bspec = P(baxes)

            def batch_of(t):
                spec = P(baxes, *([None] * (t.dim() - 1)))
                return _sharded_empty(t, spec, mesh)

            if shape.kind == "train":
                from ..training.optimizer import init_stacked_opt_state
                from ..training.train_lib import loss_and_grads

                opt = init_stacked_opt_state(struct, ospecs, mesh)
                batch = {k: batch_of(v) for k, v in ins.items()}
                args = (params, opt, batch)
                extra = 4  # JAX's int32 step counter

                def step():
                    loss, grads = loss_and_grads(cfg, params, batch)
                    if not with_opt:
                        return loss, grads
                    new_p, new_o, gnorm = adamw_update(
                        opt_cfg, params, grads, opt,
                        moment_specs=(base == "zero1_bf16_gather"))
                    return loss, gnorm, new_p, new_o
            elif shape.kind == "prefill":
                batch = {k: batch_of(v) for k, v in ins.items()}
                args, extra = (params, batch), 0

                def step():
                    with torch.no_grad():
                        return mod.prefill(cfg, layers(), cache_len=shape.seq_len, **batch)
            else:
                tok_spec = bspec if shape.global_batch >= 32 else P(None)
                token = _sharded_empty(ins["token"], tok_spec, mesh)
                pos = _sharded_empty(ins["pos"], tok_spec, mesh)
                caches = ins["caches"]
                args, extra = (params, token, caches, pos), 0

                def step():
                    with torch.no_grad():
                        return mod.decode_step(cfg, layers(), token, caches, pos)

            arg_bytes = _local_bytes(args) + extra
            setup_s = time.time() - t0
            t1 = time.time()
            rec = _recorder_class()(axes)
            mt = _mem_tracker()
            mt.track_external(*_locals(args))
            with _marking_propagation(), mt, rec:
                out = step()
            trace_s = time.time() - t1
            peak = sum(v.get("Total", 0) for v in mt.get_tracker_snapshot("peak").values())
            out_bytes = _local_bytes(out)
    coll = {"bytes_by_kind": rec.bytes_by_kind, "count_by_kind": rec.count_by_kind,
            "bytes_by_axis": rec.bytes_by_axis, "count_by_axis": rec.count_by_axis,
            "total_bytes": sum(rec.bytes_by_kind.values())}
    return {
        "arch": arch, "shape": shape_name, "mesh": mesh_kind, "variant": variant,
        "status": "ok", "setup_s": round(setup_s, 2), "trace_s": round(trace_s, 2),
        "mesh_shape": mesh_shape,
        "flops_global": rec.flops_global,
        "flops_per_device": rec.flops_device,
        "bytes_global": rec.bytes_global,
        "bytes_accessed_per_device": rec.bytes_device,
        "memory": {
            "argument_bytes": arg_bytes,
            "output_bytes": out_bytes,
            "peak_bytes": peak,
            "temp_bytes": max(0, peak - arg_bytes),
        },
        "collectives": coll,
        "params_total": cfg.param_count(),
        "params_active": cfg.active_param_count(),
    }


def _locals(tree) -> list:
    from torch.distributed.tensor import DTensor

    return [t.to_local() if isinstance(t, DTensor) else t for t in _tensors(tree)]


def cells(include_long: bool = True):
    for arch in ASSIGNED:
        for shape_name in SHAPES:
            if shape_name == "long_500k" and arch not in SUBQUADRATIC:
                continue  # full attention @524k context: skipped per DESIGN.md
            if shape_name == "long_500k" and not include_long:
                continue
            for mesh_kind in ("single", "multi"):
                yield arch, shape_name, mesh_kind


def _recorded(arch: str, shape_name: str, mesh_kind: str, variant: str) -> dict:
    """``run_cell``'s record, or a record of its failure."""
    try:
        return run_cell(arch, shape_name, mesh_kind, variant=variant)
    except Exception as e:  # record failures; they are bugs to fix
        return {"arch": arch, "shape": shape_name, "mesh": mesh_kind, "variant": variant,
                "status": "error", "error": f"{type(e).__name__}: {e}",
                "trace": traceback.format_exc()[-2000:]}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--mesh", default="single", choices=["single", "multi"])
    ap.add_argument("--all", action="store_true",
                    help="every cell (of --arch and --shape where given), both meshes")
    ap.add_argument("--out", default="results/dryrun_torch.json")
    ap.add_argument("--variant", default="baseline",
                    help="baseline | kv_seq_shard | no_zero1 | zero1_bf16_gather | "
                         "zero3_params | *_sp")
    ap.add_argument("--jobs", type=int, default=1,
                    help="cells traced at once, each in a fresh process")
    ap.add_argument("--force", action="store_true")
    args = ap.parse_args(argv)

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    results = {}
    if os.path.exists(args.out):
        with open(args.out) as f:
            results = json.load(f)

    todo = ([c for c in cells() if args.arch in (None, c[0]) and args.shape in (None, c[1])]
            if args.all else [(args.arch, args.shape, args.mesh)])
    suffix = "" if args.variant == "baseline" else f"|{args.variant}"
    keys = {f"{a}|{s}|{m}{suffix}": (a, s, m, args.variant) for a, s, m in todo}
    for key in list(keys):
        if key in results and results[key].get("status") == "ok" and not args.force:
            print(f"SKIP {key}")
            del keys[key]

    def done(key: str, res: dict) -> None:
        results[key] = res
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
        status = res["status"]
        extra = (f"trace={res.get('trace_s')}s flops/dev={res.get('flops_per_device'):.3e}"
                 if status == "ok" else res.get("error", "")[:200])
        print(f"DONE {key}: {status} {extra}", flush=True)
        if not args.all:
            print(json.dumps(res))

    if args.jobs > 1:
        import concurrent.futures as cf
        import multiprocessing as mp

        # the train cells first: they take longest
        order = sorted(keys, key=lambda k: keys[k][1] != "train_4k")
        with cf.ProcessPoolExecutor(args.jobs, mp_context=mp.get_context("spawn"),
                                    max_tasks_per_child=1) as pool:
            futs = {pool.submit(_recorded, *keys[k]): k for k in order}
            for fut in cf.as_completed(futs):
                done(futs[fut], fut.result())
    else:
        for key, cell in keys.items():
            print(f"RUN  {key} ...", flush=True)
            done(key, _recorded(*cell))

    ok = sum(1 for r in results.values() if r.get("status") == "ok")
    print(f"\n{ok}/{len(results)} cells ok")
    return results


if __name__ == "__main__":
    main()
