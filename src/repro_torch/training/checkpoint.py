"""Fault-tolerant checkpoints in the JAX package's on-disk format
(``repro/training/checkpoint.py``), so a checkpoint written by either
package restores in the other.

* One ``.npy`` file per leaf under ``step_NNNNNNNN/``, named by the first
  16 hex digits of the md5 of the leaf's path name (``p/layers/wq``), and a
  ``manifest.json`` with each leaf's name, file, shape, dtype name and the
  md5 of its file, the step and ``extra``.
* Atomic commit: written to a ``.tmp`` directory unique to the writer,
  then renamed; ``restore_latest`` never reads a ``.tmp`` directory.
* ``restore_latest`` takes the newest checkpoint whose manifest is there,
  whose files match their md5s and whose leaf names are those asked for,
  and falls back to older ones.
* Async save: the leaves are copied to host memory first, then a
  background thread writes them; ``wait_pending`` joins the writers.

Leaves are torch tensors (any device) or numpy arrays; a tree is a nested
dict, in the JAX layout (``models.convert.params_to_jax`` and
``stack_layers``).  bfloat16 is stored as the JAX package stores it: the
raw bytes as a ``uint8`` array (last axis doubled), dtype name
``"bfloat16"``; the port reads and writes those bytes through
``Tensor.view``, without ``ml_dtypes``.  Restored leaves are CPU tensors.
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import threading
from typing import Optional

import numpy as np
import torch

from ..analysis.sanitizer import make_lock

_BYTE_DTYPES = {"bfloat16": torch.bfloat16}  # numpy has no such dtype: raw bytes

_PENDING_LOCK = make_lock("training.checkpoint._PENDING_LOCK")
_PENDING: list[threading.Thread] = []  # guarded-by: _PENDING_LOCK


def _host(leaf) -> tuple[np.ndarray, str]:
    """A host copy of ``leaf`` as ``np.save`` writes it, and its dtype name."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu", copy=True).contiguous()
        for name, dtype in _BYTE_DTYPES.items():
            if t.dtype == dtype:
                return t.view(torch.uint8).numpy(), name
        arr = t.numpy()
    else:
        arr = np.array(leaf)
    return arr, arr.dtype.name


def _decode(arr: np.ndarray, dtype_name: str, shape) -> torch.Tensor:
    if dtype_name in _BYTE_DTYPES:
        return torch.from_numpy(np.ascontiguousarray(arr).reshape(-1)).view(
            _BYTE_DTYPES[dtype_name]).reshape(shape)
    return torch.from_numpy(arr)


def flatten_with_paths(tree, prefix: str = "") -> list[tuple[str, object]]:
    """(path name, leaf) of a nested dict in JAX's order: keys sorted, names
    joined with ``/``."""
    if not isinstance(tree, dict):
        return [(prefix, tree)]
    out = []
    for k in sorted(tree):
        out += flatten_with_paths(tree[k], f"{prefix}/{k}" if prefix else str(k))
    return out


def _unflatten(like, values: dict, prefix: str = ""):
    if not isinstance(like, dict):
        return values[prefix]
    return {k: _unflatten(v, values, f"{prefix}/{k}" if prefix else str(k))
            for k, v in like.items()}


def save_checkpoint(ckpt_dir: str, step: int, tree, extra: Optional[dict] = None,
                    async_save: bool = False) -> str:
    """Write a checkpoint atomically; returns the final directory path."""
    os.makedirs(ckpt_dir, exist_ok=True)
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    # unique per writer: an async and a sync save of one step never share it
    tmp = final + f".tmp.{os.getpid()}.{threading.get_ident()}"
    leaves = [(name, *_host(leaf)) for name, leaf in flatten_with_paths(tree)]

    def write():
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        manifest = {"step": step, "extra": extra or {}, "leaves": []}
        for name, arr, dtype_name in leaves:
            fname = hashlib.md5(name.encode()).hexdigest()[:16] + ".npy"
            fpath = os.path.join(tmp, fname)
            np.save(fpath, arr)
            with open(fpath, "rb") as f:
                digest = hashlib.md5(f.read()).hexdigest()
            shape = list(arr.shape)
            if dtype_name in _BYTE_DTYPES:  # the element count of the raw bytes
                shape[-1] //= torch.finfo(_BYTE_DTYPES[dtype_name]).bits // 8
            manifest["leaves"].append({"name": name, "file": fname, "shape": shape,
                                       "dtype": dtype_name, "md5": digest})
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)  # atomic commit

    if async_save:
        t = threading.Thread(target=write, name="ckpt-writer", daemon=True)
        t.start()
        with _PENDING_LOCK:
            _PENDING.append(t)
        return final
    write()
    return final


def wait_pending() -> None:
    """Join outstanding async checkpoint writers (call before exit/restore)."""
    while True:
        with _PENDING_LOCK:
            if not _PENDING:
                return
            t = _PENDING.pop()
        t.join()


def _verify(path: str) -> Optional[dict]:
    mpath = os.path.join(path, "manifest.json")
    if not os.path.exists(mpath):
        return None
    try:
        with open(mpath) as f:
            manifest = json.load(f)
        for leaf in manifest["leaves"]:
            with open(os.path.join(path, leaf["file"]), "rb") as f:
                if hashlib.md5(f.read()).hexdigest() != leaf["md5"]:
                    return None
        return manifest
    except (OSError, json.JSONDecodeError, KeyError):
        return None


def _candidates(ckpt_dir: str) -> list[str]:
    if not os.path.isdir(ckpt_dir):
        return []
    return sorted((d for d in os.listdir(ckpt_dir)
                   if d.startswith("step_") and ".tmp" not in d), reverse=True)


def restore_latest(ckpt_dir: str, tree_like, subtree: Optional[str] = None):
    """Restore the newest valid checkpoint onto ``tree_like``'s structure.

    Returns (tree of CPU tensors, step, extra), or (None, -1, {}) where no
    valid checkpoint has exactly ``tree_like``'s leaf names, and, where
    ``tree_like``'s leaves have a shape, its shapes (the JAX package checks
    names only).  With ``subtree`` (e.g. ``"p"``) only the leaves under
    that key are read and matched against ``tree_like``, the checkpoint's
    other leaves (an optimizer state) ignored."""
    prefix = f"{subtree}/" if subtree else ""
    like = flatten_with_paths(tree_like)
    names = {prefix + name: leaf for name, leaf in like}
    for cand in _candidates(ckpt_dir):
        path = os.path.join(ckpt_dir, cand)
        manifest = _verify(path)
        if manifest is None:
            continue  # incomplete/corrupt: fall back to an older checkpoint
        by_name = {l["name"]: l for l in manifest["leaves"]
                   if l["name"].startswith(prefix)}
        if set(names) != set(by_name):
            continue  # structure mismatch (e.g. another arch): keep looking
        if any(hasattr(leaf, "shape") and
                           list(leaf.shape) != by_name[n]["shape"]
                           for n, leaf in names.items()):
            continue
        values = {n[len(prefix):]: _decode(np.load(os.path.join(path, by_name[n]["file"])),
                                           by_name[n]["dtype"], by_name[n]["shape"])
                  for n in names}
        return _unflatten(tree_like, values), manifest["step"], manifest.get("extra", {})
    return None, -1, {}


def prune_old(ckpt_dir: str, keep: int = 3) -> None:
    done = sorted(_candidates(ckpt_dir))
    for d in done[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, d), ignore_errors=True)
