"""Kernel wrappers on DTensors: each rank runs the wrapper on its own shard
through ``torch.distributed.tensor.experimental.local_map``.

A wrapper names, per input, its batch dimension and its head dimension.
The layout follows the leading input (the queries, or the SSD scan's x):
each mesh dimension that splits its batch splits every input's batch the
same way; the mesh dimension that splits its heads evenly splits each
input's heads where they divide, and leaves the others whole
(``Replicate``), with a gradient that is the sum over that dimension
(``Partial``), since each rank uses them for its own heads only.  Any other
layout of the leading input (a split sequence, a pending sum) is
redistributed to whole first.  An input without a batch dimension is
whole on every rank of a batch split, and its gradient is likewise the sum
over those ranks.  Inside, the wrapper sees plain tensors, so
its dispatch stays by device: a CUDA shard launches the kernel, a CPU shard
takes the plain version.
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
from typing import Callable, Optional

from .sharding import global_offset, is_dtensor

# how many shards of its work a ``local_map`` body computes one of, while
# it runs (the dry-run scales the body's FLOPs by it)
_SPLIT: contextvars.ContextVar[int] = contextvars.ContextVar("local_split", default=0)


def split_factor() -> int:
    """Inside a ``local_map`` body, the number of shards its work is split
    into; 0 outside one."""
    return _SPLIT.get()


@contextlib.contextmanager
def split_work(n: int):
    """Mark the block as one of ``n`` shards of a ``local_map`` body's work."""
    token = _SPLIT.set(n)
    try:
        yield
    finally:
        _SPLIT.reset(token)


@dataclasses.dataclass(frozen=True)
class Arg:
    tensor: object
    batch: Optional[int] = None  # the batch dimension, if any
    heads: Optional[int] = None  # the head dimension, if any


def any_dtensor(*xs) -> bool:
    return any(is_dtensor(x) for x in xs)


def _roles(lead: Arg) -> list:
    """'batch', 'heads' or None per mesh dimension of the leading input."""
    from torch.distributed.tensor import Shard

    t = lead.tensor
    roles = []
    for d, pl in enumerate(t.placements):
        size = t.device_mesh.size(d)
        if isinstance(pl, Shard) and pl.dim % t.dim() == lead.batch:
            roles.append("batch")
        elif (isinstance(pl, Shard) and pl.dim % t.dim() == lead.heads
              and t.shape[lead.heads] % size == 0 and "heads" not in roles):
            roles.append("heads")
        else:
            roles.append(None)
    return roles


def _placements(arg: Arg, roles: list, mesh, grad: bool) -> Optional[tuple]:
    from torch.distributed.tensor import Partial, Replicate, Shard

    if not is_dtensor(arg.tensor):
        return None
    out = []
    for d, role in enumerate(roles):
        if role == "batch" and arg.batch is not None:
            out.append(Shard(arg.batch))
        elif role == "batch" and grad:
            out.append(Partial())
        elif role == "heads" and arg.heads is not None \
                and arg.tensor.shape[arg.heads] % mesh.size(d) == 0:
            out.append(Shard(arg.heads))
        elif role == "heads" and grad:
            out.append(Partial())
        else:
            out.append(Replicate())
    return tuple(out)


def head_offset(lead: Arg, roles: list) -> int:
    """The global index of the leading input's first local head."""
    from torch.distributed.tensor import Replicate, Shard

    t = lead.tensor
    pls = [Shard(lead.heads) if r == "heads" else Replicate() for r in roles]
    return global_offset(tuple(t.shape), pls, t.device_mesh)[lead.heads]


def on_mesh(t, mesh):
    """A plain tensor as a DTensor whole on every rank of ``mesh``; a
    DTensor or a non-tensor as it is."""
    import torch
    from torch.distributed.tensor import DTensor, Replicate

    if is_dtensor(t) or not isinstance(t, torch.Tensor):
        return t
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim, run_check=False)


def call(fn: Callable, args: list, outs: list, lead: int = 0):
    """``fn(start, *local tensors)`` on each rank's shard of ``args`` (a
    list of :class:`Arg`; plain values pass as they are), where ``start``
    is the global index of the leading input's first local head.  ``outs``
    gives (batch, heads) dims per output, laid out as the leading input's
    batch and heads.  Returns DTensors."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh = next(a.tensor for a in args if is_dtensor(a.tensor)).device_mesh
    args = [dataclasses.replace(a, tensor=on_mesh(a.tensor, mesh)) for a in args]
    lt = args[lead]
    roles = _roles(lt)
    start = head_offset(lt, roles) if "heads" in roles else 0
    in_pl = [_placements(a, roles, mesh, grad=False) for a in args]
    grad_pl = [_placements(a, roles, mesh, grad=True) for a in args]

    def out_pl(batch, heads):  # a list: local_map reads a tuple as one per output
        return [Shard(batch) if r == "batch" else
                Shard(heads) if r == "heads" else Replicate() for r in roles]

    out_pls = [out_pl(*o) for o in outs]
    split = 1
    for d, r in enumerate(roles):
        split *= mesh.size(d) if r else 1
    def body(*xs):
        with split_work(split):
            return fn(start, *xs)

    mapped = local_map(body,
                       out_placements=tuple(out_pls) if len(outs) > 1 else out_pls[0],
                       in_placements=tuple(in_pl), in_grad_placements=tuple(grad_pl),
                       device_mesh=mesh, redistribute_inputs=True)
    return mapped(*[a.tensor for a in args])


def gqa_slice(k, v, start: int, n_q: int, n_heads: int, n_kv: int):
    """The KV heads that query heads [start, start + n_q) of ``n_heads``
    read (query head h reads KV head h // (n_heads / n_kv)), for a kernel
    that maps local query head i to local KV head i // (n_q / local KV
    heads).  ``k``/``v`` (B, Hkv, ...) already split with the queries, or
    the queries all here, pass as they are.  Otherwise a group that lines
    up takes a slice of KV heads, and a query head that shares no group
    with its neighbours gets its own copy of its KV head (group 1)."""
    import torch

    if k.shape[1] != n_kv or n_q == n_heads:
        return k, v
    group = n_heads // n_kv
    if start % group == 0 and n_q % group == 0:
        a = start // group
        return k[:, a:a + n_q // group], v[:, a:a + n_q // group]
    if group % n_q == 0 and start // group == (start + n_q - 1) // group:
        a = start // group
        return k[:, a:a + 1], v[:, a:a + 1]
    idx = (start + torch.arange(n_q, device=k.device)) // group
    return k.index_select(1, idx), v.index_select(1, idx)
