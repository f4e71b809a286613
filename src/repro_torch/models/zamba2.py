"""Zamba2 hybrid: a Mamba2 backbone with one *shared* attention block, the
port of the JAX package's ``repro/models/zamba2.py``.

One set of attention + MLP weights is applied again after every
``attn_every`` Mamba layers (``_segments``: at full depth 81 layers make
13 applications, and the last 3 layers have none after them).  Parameters:

  {"embed": (V, D), "mamba": [the Mamba2 layer dicts of
   ``mamba2.block_param_shapes``, ...], "shared_attn": {"wq", "wk", "wv",
   "wo", ["q_norm", "k_norm"], "mlp_w1", ["mlp_w3"], "mlp_w2", "ln1",
   "ln2"}, "final_norm": (D,), "lm_head": (D, V)}

``shared_attn`` has no layer axis, in JAX as here.  The serving cache is
hybrid: the per-layer (SSM state, conv buffer) pairs of Mamba2 and one KV
cache per *application* of the shared block (same weights, separate
caches), all preallocated and written in place.  ``prefill`` seeds each
Mamba layer's state from the same ``ssd_scan(..., return_state=True)``
call that computes its output (JAX runs ``ssd_final_state`` in a second
pass).  On the card a prefill launches the SSD-scan kernel once per Mamba
layer and the flash-attention kernel once per application, and a decode
step the decode-attention kernel once per application.
"""
from __future__ import annotations

import torch

from ..distributed.sharding import cache_zeros, hint
from . import mamba2
from .layers import attention, attn_param_shapes, mlp, mlp_param_shapes, rmsnorm
from .model import ModelConfig, init_by_rule
from .transformer import _inputs, batch_loss, embed_tokens, logits_fn
from .transformer import to_device  # noqa: F401  (the family interface the engine calls)

FLOAT32_LEAVES = mamba2.FLOAT32_LEAVES


def attn_apps(cfg: ModelConfig) -> int:
    """Applications of the shared block (one KV cache each)."""
    return cfg.n_layers // cfg.attn_every


def param_shapes(cfg: ModelConfig) -> dict:
    shared = attn_param_shapes(cfg.d_model, cfg.n_heads, cfg.kv_heads, cfg.hd, cfg.qk_norm)
    shared.update({f"mlp_{k}": v for k, v in
                   mlp_param_shapes(cfg.d_model, cfg.d_ff, cfg.activation).items()})
    shared["ln1"] = (cfg.d_model,)
    shared["ln2"] = (cfg.d_model,)
    return {"embed": (cfg.vocab, cfg.d_model),
            "mamba": [mamba2.block_param_shapes(cfg) for _ in range(cfg.n_layers)],
            "shared_attn": shared,
            "final_norm": (cfg.d_model,),
            "lm_head": (cfg.d_model, cfg.vocab)}


def init_params(cfg: ModelConfig, generator: "torch.Generator | int" = 0,
                device="cuda") -> dict:
    """The JAX package's init rule (``init_by_rule``) on this family's
    shapes, then JAX's SSD overrides on every Mamba layer
    (``mamba2.ssd_overrides``)."""
    params = init_by_rule(cfg, param_shapes(cfg), generator, device)
    mamba2.ssd_overrides(cfg, params["mamba"])
    return params


# ------------------------------------------------------------------ forward


def _segments(cfg: ModelConfig) -> list[tuple[int, int, bool]]:
    """[(start, length, apply_attn_after)] covering all Mamba layers."""
    segs = []
    start = 0
    while start < cfg.n_layers:
        ln = min(cfg.attn_every, cfg.n_layers - start)
        segs.append((start, ln, ln == cfg.attn_every))
        start += ln
    return segs


def _shared_block(cfg: ModelConfig, sp: dict, x, kv_cache=None, cache_pos=None):
    """Attention (RoPE over the whole head, as JAX's call passes no
    fraction) and the MLP, each with its residual.  The residuals take the
    "residual" hint, which JAX's block leaves to GSPMD: on DTensors the
    reduction of the block's pending sums would otherwise split the
    sequence, which the next Mamba layer's projections cannot take."""
    h, kv = attention(
        sp, rmsnorm(x, sp["ln1"]),
        n_heads=cfg.n_heads, kv_heads=cfg.kv_heads, head_dim=cfg.hd,
        qk_norm=cfg.qk_norm, rope_theta=cfg.rope_theta,
        kv_cache=kv_cache, cache_pos=cache_pos,
    )
    x = hint(x + h, "residual")
    h = mlp({k[4:]: v for k, v in sp.items() if k.startswith("mlp_")},
            rmsnorm(x, sp["ln2"]), cfg.activation)
    return hint(x + h, "residual"), kv


def forward(cfg: ModelConfig, params: dict, tokens=None, embeddings=None):
    """Scoring forward -> logits (B, S, V) in f32."""
    x = _inputs(cfg, params, tokens, embeddings)
    for start, ln, attn_after in _segments(cfg):
        for lp in params["mamba"][start:start + ln]:
            x, _, _ = mamba2._block(cfg, lp, x)
        if attn_after:
            x, _ = _shared_block(cfg, params["shared_attn"], x)
    return logits_fn(cfg, params, x)


def loss_fn(cfg: ModelConfig, params: dict, batch: dict):
    """batch: {"tokens" or "embeddings", "labels"} -> the mean cross-entropy
    over labels >= 0, a f32 scalar.  As for Mamba2, on the card the SSD-scan
    kernel has no backward yet; on the CPU it differentiates the plain
    scan."""
    return batch_loss(forward, cfg, params, batch)


# ------------------------------------------------------------------ serving


def make_cache(cfg: ModelConfig, batch: int, cache_len: int, device) -> dict:
    """Preallocated zero caches: Mamba2's "state" (L, B, H, P, N) float32
    and "conv" (L, B, K-1, d_inner), and "attn_k" / "attn_v" (apps, B, Hkv,
    cache_len, Dh), in ``cfg.dtype`` but the state, on ``device``."""
    out = mamba2.make_cache(cfg, batch, cache_len, device)
    shape = (attn_apps(cfg), batch, cfg.kv_heads, cache_len, cfg.hd)
    out["attn_k"] = cache_zeros("attn_k", shape, cfg.dtype, device)
    out["attn_v"] = cache_zeros("attn_v", shape, cfg.dtype, device)
    return out


def prefill(cfg: ModelConfig, params: dict, tokens=None, embeddings=None,
            cache_len: int = 0):
    """Seed the caches (KV length max(cache_len, S)).  Returns
    (last-position logits (B, V), caches, positions (B,) int32 all equal
    to S)."""
    x = _inputs(cfg, params, tokens, embeddings)
    b, s = x.shape[0], x.shape[1]
    caches = make_cache(cfg, b, max(cache_len, s), x.device)
    app = 0
    for start, ln, attn_after in _segments(cfg):
        for i in range(start, start + ln):
            x = mamba2.prefill_layer(cfg, params["mamba"][i], x, caches, i)
        if attn_after:
            x, (k, v) = _shared_block(cfg, params["shared_attn"], x)
            caches["attn_k"][app, :, :, :s] = k
            caches["attn_v"][app, :, :, :s] = v
            app += 1
    logits = logits_fn(cfg, params, x[:, -1:])
    return logits[:, 0], caches, torch.full((b,), s, dtype=torch.int32, device=x.device)


def decode_step(cfg: ModelConfig, params: dict, token, caches: dict, pos):
    """One decode step.  token: (B,) ids; pos: (B,) int32 cache lengths.
    Writes every layer's state and conv buffer and each application's K/V
    into ``caches`` in place and returns (logits (B, V), the same caches,
    pos + 1)."""
    x = embed_tokens(cfg, params, token[:, None])
    app = 0
    for start, ln, attn_after in _segments(cfg):
        for i in range(start, start + ln):
            x = mamba2.decode_layer(cfg, params["mamba"][i], x, caches, i)
        if attn_after:
            kv = (caches["attn_k"][app], caches["attn_v"][app])
            x, _ = _shared_block(cfg, params["shared_attn"], x, kv_cache=kv, cache_pos=pos)
            app += 1
    return logits_fn(cfg, params, x)[:, 0], caches, pos + 1
