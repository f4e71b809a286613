"""Assigned input shapes and FakeTensor stand-ins for the dry-run: the JAX
package's ``repro/configs/shapes.py``.

Shapes (per assignment):
  train_4k    — train_step,  seq 4,096,  global batch 256
  prefill_32k — serve prefill, seq 32,768, global batch 32
  decode_32k  — serve_step (1 new token, KV cache of 32,768), batch 128
  long_500k   — serve_step, cache 524,288, batch 1 (sub-quadratic archs only)

``input_specs`` returns FakeTensors (no allocation) under the caller's
``FakeTensorMode``; audio/vlm archs get precomputed frame/patch embeddings
for prefill/train (modality frontend stub) and token ids for decode.
"""
from __future__ import annotations

import dataclasses

import torch

from ..models.model import ModelConfig


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str  # 'train' | 'prefill' | 'decode'
    seq_len: int
    global_batch: int


SHAPES: dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524288, 1),
}


def sds(shape, dtype):
    """An uninitialised tensor of ``shape``: a FakeTensor under the active
    ``FakeTensorMode``."""
    return torch.empty(tuple(shape), dtype=dtype)


def input_specs(cfg: ModelConfig, shape: ShapeSpec, reduced_seq: int | None = None):
    """Stand-ins for every model input of this step, made under the active
    fake mode.  Token ids are int32, as JAX's.  A decode step's caches come
    from the family's ``make_cache``: laid out on a mesh when a sharding
    context with cache specs is active (``distributed.sharding.cache_zeros``)."""
    s = reduced_seq or shape.seq_len
    b = shape.global_batch
    if shape.kind == "train":
        if cfg.embed_inputs:
            return {"embeddings": sds((b, s, cfg.d_model), cfg.dtype),
                    "labels": sds((b, s), torch.int32)}
        return {"tokens": sds((b, s), torch.int32), "labels": sds((b, s), torch.int32)}
    if shape.kind == "prefill":
        if cfg.embed_inputs:
            return {"embeddings": sds((b, s, cfg.d_model), cfg.dtype)}
        return {"tokens": sds((b, s), torch.int32)}
    if shape.kind == "decode":
        caches = cfg.build().make_cache(cfg, b, s, "cpu")
        return {
            "token": sds((b,), torch.int32),
            "caches": caches,
            "pos": sds((b,), torch.int32),
        }
    raise ValueError(shape.kind)
