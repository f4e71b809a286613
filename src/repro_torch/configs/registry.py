"""Assigned architecture configs (10) + the trainable canonicalizer model.

The same entries, fields and values as the JAX package's
``repro/configs/registry.py``, over the port's own :class:`ModelConfig`
(``dtype`` a ``torch.dtype``).  Each entry is selectable via ``--arch <id>``
in the launchers.  Reduced same-family configs for CPU smoke tests come
from :func:`reduced`.
"""
from __future__ import annotations

import dataclasses

from ..models.model import ModelConfig

CONFIGS: dict[str, ModelConfig] = {}


def _reg(cfg: ModelConfig) -> ModelConfig:
    CONFIGS[cfg.name] = cfg
    return cfg


# --------------------------------------------------------------- dense LMs
_reg(ModelConfig(
    name="qwen3-32b", kind="dense", n_layers=64, d_model=5120, n_heads=64,
    kv_heads=8, head_dim=128, d_ff=25600, vocab=151936,
    activation="swiglu", qk_norm=True, rope_theta=1e6,
))
_reg(ModelConfig(
    name="nemotron-4-340b", kind="dense", n_layers=96, d_model=18432, n_heads=96,
    kv_heads=8, head_dim=192, d_ff=73728, vocab=256000,
    activation="squared_relu",
))
_reg(ModelConfig(
    name="gemma-2b", kind="dense", n_layers=18, d_model=2048, n_heads=8,
    kv_heads=1, head_dim=256, d_ff=16384, vocab=256000,
    activation="geglu", tie_embeddings=True,
))
_reg(ModelConfig(
    name="chatglm3-6b", kind="dense", n_layers=28, d_model=4096, n_heads=32,
    kv_heads=2, head_dim=128, d_ff=13696, vocab=65024,
    activation="swiglu", rope_fraction=0.5,  # 2D/partial rotary
))
# ------------------------------------------------------------------- audio
_reg(ModelConfig(
    name="musicgen-large", kind="dense", n_layers=48, d_model=2048, n_heads=32,
    kv_heads=32, head_dim=64, d_ff=8192, vocab=2048,
    activation="gelu", embed_inputs=True,  # EnCodec frame embeddings stub
))
# --------------------------------------------------------------------- MoE
_reg(ModelConfig(
    name="kimi-k2-1t-a32b", kind="moe", n_layers=61, d_model=7168, n_heads=64,
    kv_heads=8, head_dim=112, d_ff=2048, vocab=163840,
    activation="swiglu", n_experts=384, top_k=8, n_shared_experts=1,
    dense_layers=1,
))
_reg(ModelConfig(
    name="qwen3-moe-235b-a22b", kind="moe", n_layers=94, d_model=4096, n_heads=64,
    kv_heads=4, head_dim=128, d_ff=1536, vocab=151936,
    activation="swiglu", qk_norm=True, n_experts=128, top_k=8,
))
# --------------------------------------------------------------------- VLM
_reg(ModelConfig(
    name="pixtral-12b", kind="dense", n_layers=40, d_model=5120, n_heads=32,
    kv_heads=8, head_dim=128, d_ff=14336, vocab=131072,
    activation="swiglu", embed_inputs=True,  # ViT patch embeddings stub
))
# ------------------------------------------------------------------ hybrid
_reg(ModelConfig(
    name="zamba2-7b", kind="hybrid", n_layers=81, d_model=3584, n_heads=32,
    kv_heads=32, head_dim=112, d_ff=14336, vocab=32000,
    activation="geglu", ssm_state=64, ssm_heads=112, ssm_head_dim=64,
    d_inner=7168, attn_every=6,
))
# --------------------------------------------------------------------- SSM
_reg(ModelConfig(
    name="mamba2-780m", kind="ssm", n_layers=48, d_model=1536, n_heads=1,
    kv_heads=1, head_dim=64, d_ff=0, vocab=50280,
    activation="swiglu", ssm_state=128, ssm_heads=48, ssm_head_dim=64,
    d_inner=3072,
))
# ------------------------------------------- trainable canonicalizer (ours)
_reg(ModelConfig(
    name="canonicalizer-100m", kind="dense", n_layers=12, d_model=768, n_heads=12,
    kv_heads=4, head_dim=64, d_ff=2048, vocab=8192,
    activation="swiglu", qk_norm=True,
))

ASSIGNED = [n for n in CONFIGS if n != "canonicalizer-100m"]

# archs with sub-quadratic sequence mixing: the only ones eligible for the
# long_500k shape (full attention at 524k context is out of scope — DESIGN.md)
SUBQUADRATIC = ("zamba2-7b", "mamba2-780m")


def get(name: str) -> ModelConfig:
    return CONFIGS[name]


def reduced(name: str) -> ModelConfig:
    """Same-family tiny config for single-CPU smoke tests."""
    cfg = CONFIGS[name]
    kw = dict(
        name=cfg.name + "-smoke", n_layers=2, d_model=64, d_ff=128, vocab=256,
        n_heads=4, kv_heads=max(1, min(cfg.kv_heads, 2)), head_dim=16,
    )
    if cfg.kind == "moe":
        kw.update(n_experts=8, top_k=2, d_ff=64,
                  n_shared_experts=cfg.n_shared_experts,
                  dense_layers=min(cfg.dense_layers, 1))
    if cfg.kind in ("ssm", "hybrid"):
        kw.update(ssm_state=16, ssm_heads=4, ssm_head_dim=16, d_inner=64)
    if cfg.kind == "hybrid":
        kw.update(n_layers=5, attn_every=2)
    return dataclasses.replace(cfg, **kw)
