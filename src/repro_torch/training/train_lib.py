"""The training loop: microbatched, checkpointed, restartable; the JAX
package's ``repro/training/train_lib.py``.

Model loss -> gradients summed over microbatches in float32 -> optional
error-feedback int8 compression -> AdamW -> atomic async checkpoints in
the JAX package's format -> deterministic skip-ahead resume
(``batches.batch_at(step)``).  PyTorch runs eagerly: nothing is jitted.
Every family's tree goes through the same loop (``optimizer.
stacked_leaves`` walks every stack and Zamba2's ``shared_attn``).  On the
card the attention of the dense and MoE transformers runs the forward and
the backward flash kernels (``kernels/flash_attn``); the Mamba2 and Zamba2
families train on the CPU only, since the SSD-scan kernel has no backward
yet.

A checkpoint holds {"p": params, "o": {"m", "v", "step"}} in the JAX
layout (stacked (L, ...) leaves), so one written here restores in
``repro.training.train_lib.train`` and the reverse.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

import numpy as np
import torch

from ..distributed.sharding import (batch_axes, batch_size_of, distribute_tree, gather_params,
                                    on_mesh, shard_batch, to_placements, tree_param_specs,
                                    zero3_grads, zero3_params)
from ..models.convert import params_from_jax, params_to_jax, stack_layers, unstack_layers
from ..models.model import STACKS, ModelConfig, tree_map
from ..olap.columnar import resolve_device
from .checkpoint import prune_old, restore_latest, save_checkpoint, wait_pending
from .optimizer import (AdamWConfig, adamw_update, compress_grads, decompress_grads,
                        from_stacked, in_stack, init_opt_state, init_stacked_opt_state,
                        is_stacked, is_stacked_state, opt_state_specs, stack, stacked_leaves,
                        unflatten)


@dataclasses.dataclass
class TrainConfig:
    steps: int = 300
    microbatches: int = 1
    ckpt_dir: Optional[str] = None
    ckpt_every: int = 50
    ckpt_keep: int = 3
    log_every: int = 10
    grad_compression: bool = False
    opt: AdamWConfig = dataclasses.field(default_factory=AdamWConfig)


def loss_and_grads(cfg: ModelConfig, params: dict, batch: dict, microbatches: int = 1):
    """(loss, grads) of ``cfg``'s loss over ``batch`` at ``params``: with
    microbatches, the batch rows are cut into ``microbatches`` equal
    slices, each slice's gradients added into float32 zeros, and loss and
    gradients divided by their count (as the reference's ``fori_loop``);
    without, the gradients keep the parameters' dtypes.  A leaf the loss
    does not read (``embed`` of an ``embed_inputs`` config) gets zeros, as
    from ``jax.value_and_grad``.

    ZeRO-3 parameters (the stacked form, ``shard_train_state(zero3=True)``)
    are gathered once (``gather_params``); the microbatches' gradients are
    summed per layer, and one pass of the gather's adjoint (``zero3_grads``)
    gives the stacked gradients in the parameters' layout, so the step's
    reduce-scatters do not grow with the microbatch count."""
    if is_stacked(params):
        with torch.no_grad():
            layers = gather_params(params)
        loss, grads = loss_and_grads(cfg, layers, batch, microbatches)
        return loss, zero3_grads(grads, params)
    mod = cfg.build()
    leaves = tree_map(lambda p: p.detach().requires_grad_(), params)
    flat = [t for _, ts in stacked_leaves(leaves) for t in ts]

    def grads_of(mb):
        loss = mod.loss_fn(cfg, leaves, mb)
        return loss, torch.autograd.grad(loss, flat, allow_unused=True, materialize_grads=True)

    if microbatches <= 1:
        loss, gs = grads_of(batch)
        return loss.detach(), _like(params, gs)
    rows = len(batch["labels"]) // microbatches
    loss_sum = torch.zeros((), dtype=torch.float32, device=flat[0].device)
    acc = [torch.zeros(t.shape, dtype=torch.float32, device=t.device) for t in flat]
    for i in range(microbatches):
        mb = {k: v[i * rows:(i + 1) * rows] for k, v in batch.items()}
        loss, gs = grads_of(mb)
        loss_sum = loss_sum + loss.detach()
        acc = [a + g.to(torch.float32) for a, g in zip(acc, gs)]
    return loss_sum / microbatches, _like(params, [a / microbatches for a in acc])


def _like(tree: dict, flat: list) -> dict:
    """A tree shaped as ``tree`` from its tensors in ``stacked_leaves`` order."""
    it = iter(flat)
    return from_stacked(tree, {name: [next(it) for _ in ts]
                               for name, ts in stacked_leaves(tree)})


def make_train_step(cfg: ModelConfig, tcfg: TrainConfig, mesh=None) -> Callable:
    """``train_step(params, opt_state, batch, compress_residual=None)`` ->
    (loss, gnorm, new params, new opt state, new residual).  With ``mesh``
    the parameters are DTensors on it (``shard_train_state``, either form):
    the batch is split over its batch axes and the step runs ``on_mesh``."""

    def train_step(params, opt_state, batch, compress_residual=None):
        loss, grads = loss_and_grads(cfg, params, batch, tcfg.microbatches)
        new_residual = compress_residual
        if tcfg.grad_compression:
            q, scales, new_residual = compress_grads(grads, compress_residual)
            grads = decompress_grads(q, scales)
        new_p, new_o, gnorm = adamw_update(tcfg.opt, params, grads, opt_state)
        return loss, gnorm, new_p, new_o, new_residual

    if mesh is None:
        return train_step

    def sharded_step(params, opt_state, batch, compress_residual=None):
        with on_mesh(mesh):
            return train_step(params, opt_state, shard_batch(batch, mesh), compress_residual)

    return sharded_step


def shard_train_state(cfg: ModelConfig, params: dict, mesh,
                      opt_state: dict | None = None,
                      zero3: bool = False) -> tuple[dict, dict]:
    """(params, opt state) as DTensors on ``mesh``: the parameters by the
    reference's rules (``tree_param_specs`` over every stack), the moments
    stacked and laid out by ``opt_state_specs`` (ZeRO-1 over the batch
    axes).  With ``zero3`` the parameters are stacked and laid out as their
    moments (``zero3_params``), the reference's ``zero3_params`` variant.
    ``opt_state`` (a per-layer tree, e.g. restored from a checkpoint) gives
    the moments' values; zeros by default."""
    specs = tree_param_specs(params, mesh["model"].size(), stacked_prefixes=STACKS)
    ospecs = opt_state_specs(specs, params, batch_axes(mesh.mesh_dim_names),
                             batch_size_of(mesh))["m"]
    d_params = (zero3_params(params, ospecs, mesh) if zero3
                else distribute_tree(params, specs, mesh))
    if opt_state is None:
        return d_params, init_stacked_opt_state(params, ospecs, mesh)
    from torch.distributed.tensor import distribute_tensor

    def stacked(tree):
        return {name: distribute_tensor(stack(name, ts), mesh, to_placements(ospecs[name], mesh))
                for name, ts in stacked_leaves(tree)}

    return d_params, {"m": stacked(opt_state["m"]), "v": stacked(opt_state["v"]),
                      "step": opt_state["step"]}


def gather_train_state(params: dict, opt_state: dict) -> tuple[dict, dict]:
    """The whole (per-layer params, per-layer opt state) of a sharded train
    state, either form, plain tensors on every rank: what
    ``checkpoint_tree`` and a comparison take."""
    def whole(t):
        return t.full_tensor() if hasattr(t, "full_tensor") else t

    if is_stacked(params):
        plain = unflatten({name: list(whole(t).unbind(0)) if in_stack(name) else [whole(t)]
                           for name, t in params.items()})
    else:
        plain = tree_map(whole, params)
    if not is_stacked_state(opt_state):
        return plain, {"m": tree_map(whole, opt_state["m"]),
                       "v": tree_map(whole, opt_state["v"]), "step": opt_state["step"]}

    def unstack(moments):
        by_name = {}
        for name, ps in stacked_leaves(plain):
            t = whole(moments[name])
            by_name[name] = [t[i] for i in range(len(ps))] if in_stack(name) else [t]
        return from_stacked(plain, by_name)

    return plain, {"m": unstack(opt_state["m"]), "v": unstack(opt_state["v"]),
                   "step": opt_state["step"]}


def checkpoint_tree(cfg: ModelConfig, params: dict, opt_state: dict) -> dict:
    """{"p", "o"} in the JAX layout, as a checkpoint holds them."""
    return {"p": params_to_jax(cfg, params),
            "o": {"m": stack_layers(opt_state["m"]), "v": stack_layers(opt_state["v"]),
                  "step": np.asarray(opt_state["step"], np.int32)}}


def restore_train_state(cfg: ModelConfig, ckpt_dir: str, params: dict, opt_state: dict,
                        device=None):
    """The newest valid checkpoint in ``ckpt_dir`` whose leaves fit
    ``params`` and ``opt_state``: (params, opt_state, step, extra) on
    ``device`` (default: the parameters' device), or None where there is
    none."""
    dev = params["embed"].device if device is None else resolve_device(device)
    restored, step, extra = restore_latest(ckpt_dir, checkpoint_tree(cfg, params, opt_state))
    if restored is None:
        return None
    o = restored["o"]
    return (params_from_jax(cfg, restored["p"], device=dev),
            {"m": unstack_layers(o["m"], dev), "v": unstack_layers(o["v"], dev),
             "step": int(o["step"])},
            step, extra)


def train(cfg: ModelConfig, tcfg: TrainConfig, batches, params=None, generator=None,
          device=None, log: Callable[[str], None] = print,
          extra: Optional[dict] = None) -> dict:
    """Run the loop with restart support.  ``batches`` must expose
    ``batch_at(step)`` (deterministic skip-ahead).  ``params`` default to
    the family's ``init_params`` from ``generator`` (or seed 0) on
    ``device`` (default ``cuda``); ``extra`` goes into every checkpoint's
    manifest.  Returns {"params", "opt_state", "history", "start_step"}."""
    mod = cfg.build()
    if params is None:
        params = mod.init_params(cfg, 0 if generator is None else generator,
                                 device="cuda" if device is None else device)
    opt_state = init_opt_state(params)
    start_step = 0
    if tcfg.ckpt_dir:
        wait_pending()  # a prior in-process run may still be flushing
        restored = restore_train_state(cfg, tcfg.ckpt_dir, params, opt_state)
        if restored is not None:
            params, opt_state, step, _ = restored
            start_step = step + 1
            log(f"[train] resumed from step {step}")

    step_fn = make_train_step(cfg, tcfg)
    residual = None
    if tcfg.grad_compression:
        residual = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                                  device=p.device), params)

    history = []
    last_saved = -1
    t0 = time.time()
    for step in range(start_step, tcfg.steps):
        loss, gnorm, params, opt_state, residual = step_fn(
            params, opt_state, batches.batch_at(step), residual)
        if step % tcfg.log_every == 0 or step == tcfg.steps - 1:
            log(f"[train] step {step} loss {float(loss):.4f} "
                f"gnorm {float(gnorm):.3f} ({time.time() - t0:.1f}s)")
            history.append({"step": step, "loss": float(loss)})
        if tcfg.ckpt_dir and (step + 1) % tcfg.ckpt_every == 0:
            save_checkpoint(tcfg.ckpt_dir, step, checkpoint_tree(cfg, params, opt_state),
                            extra=extra, async_save=True)
            last_saved = step
            prune_old(tcfg.ckpt_dir, tcfg.ckpt_keep)
    if tcfg.ckpt_dir and last_saved != tcfg.steps - 1:
        save_checkpoint(tcfg.ckpt_dir, tcfg.steps - 1,
                        checkpoint_tree(cfg, params, opt_state), extra=extra)
    if tcfg.ckpt_dir:
        wait_pending()
    return {"params": params, "opt_state": opt_state, "history": history,
            "start_step": start_step}
