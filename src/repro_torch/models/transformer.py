"""Decoder-only dense transformer: the port of the dense family of the JAX
package's ``repro/models/transformer.py``.

Parameters are a plain dict of tensors on one device, with JAX's names and
``x @ W`` layout; the JAX stacked (L, ...) layer axis becomes a list of
per-layer dicts, run in a Python loop:

  {"embed": (V, D), "layers": [{"wq", "wk", "wv", "wo", ["q_norm", "k_norm"],
   "mlp_w1", ["mlp_w3"], "mlp_w2", "ln1", "ln2"}, ...], "final_norm": (D,),
   ["lm_head": (D, V)]}

The device is the parameters' device: ``init_params`` puts them on
``device`` (``cuda`` unless the caller asks for the CPU), and every
function computes where its parameters live.  The same code serves:

  * ``forward``     — full-sequence logits (B, S, V),
  * ``loss_fn``     — the training loss over a batch of tokens and labels,
  * ``prefill``     — a forward that seeds preallocated KV caches,
  * ``decode_step`` — one token against those caches, written in place.

Audio/VLM archs (musicgen/pixtral) set ``embed_inputs=True``: prefill and
forward take precomputed frame/patch ``embeddings``; decode takes token ids.
"""
from __future__ import annotations

import torch

from .layers import attention, attn_param_shapes, mlp, mlp_param_shapes, rmsnorm
from .model import ModelConfig, init_by_rule


def param_shapes(cfg: ModelConfig) -> dict:
    if cfg.kind != "dense":
        raise NotImplementedError(f"{cfg.kind!r} is not ported yet (ROADMAP.md, "
                                  "Queue 1 item 5)")
    layer = {**attn_param_shapes(cfg.d_model, cfg.n_heads, cfg.kv_heads, cfg.hd,
                                 cfg.qk_norm),
             **{f"mlp_{k}": v for k, v in
                mlp_param_shapes(cfg.d_model, cfg.d_ff, cfg.activation).items()},
             "ln1": (cfg.d_model,), "ln2": (cfg.d_model,)}
    out = {"embed": (cfg.vocab, cfg.d_model),
           "layers": [dict(layer) for _ in range(cfg.n_layers)],
           "final_norm": (cfg.d_model,)}
    if not cfg.tie_embeddings:
        out["lm_head"] = (cfg.d_model, cfg.vocab)
    return out


# leaves that stay float32 whatever ``cfg.dtype`` is (none in this family)
FLOAT32_LEAVES: frozenset = frozenset()


def init_params(cfg: ModelConfig, generator: "torch.Generator | int" = 0,
                device="cuda") -> dict:
    """Random parameters by the JAX package's rule (``init_by_rule``)."""
    return init_by_rule(cfg, param_shapes(cfg), generator, device)


def to_device(params: dict, device) -> dict:
    """The same parameters on ``device``."""
    return {k: ([{n: t.to(device) for n, t in lp.items()} for lp in v]
                if k == "layers" else v.to(device))
            for k, v in params.items()}


# ------------------------------------------------------------------ forward


def _block(cfg: ModelConfig, lp: dict, x, kv_cache=None, cache_pos=None):
    h, kv = attention(
        lp, rmsnorm(x, lp["ln1"]),
        n_heads=cfg.n_heads, kv_heads=cfg.kv_heads, head_dim=cfg.hd,
        qk_norm=cfg.qk_norm, rope_theta=cfg.rope_theta,
        rope_fraction=cfg.rope_fraction, kv_cache=kv_cache, cache_pos=cache_pos,
    )
    x = x + h
    h = mlp({k[4:]: v for k, v in lp.items() if k.startswith("mlp_")},
            rmsnorm(x, lp["ln2"]), cfg.activation)
    return x + h, kv


def embed_tokens(cfg: ModelConfig, params: dict, tokens):
    x = params["embed"][tokens.long()].to(cfg.dtype)
    return x * (cfg.d_model ** 0.5) if cfg.name.startswith("gemma") else x


def logits_fn(cfg: ModelConfig, params: dict, x):
    x = rmsnorm(x, params["final_norm"])
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return (x @ head.to(x.dtype)).to(torch.float32)


def _inputs(cfg, params, tokens, embeddings):
    if embeddings is not None:
        return embeddings.to(cfg.dtype)
    return embed_tokens(cfg, params, tokens)


def forward(cfg: ModelConfig, params: dict, tokens=None, embeddings=None):
    """Scoring forward -> logits (B, S, V) in f32."""
    x = _inputs(cfg, params, tokens, embeddings)
    for lp in params["layers"]:
        x, _ = _block(cfg, lp, x)
    return logits_fn(cfg, params, x)


def masked_xent(logits, labels):
    """Mean next-token cross-entropy over the positions whose label is >= 0,
    from f32 logits (B, S, V) and int labels (B, S); 0 where none is."""
    labels = torch.as_tensor(labels, device=logits.device).long()
    logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
    nll = -logp.gather(-1, labels.clamp_min(0)[..., None])[..., 0]
    mask = (labels >= 0).to(torch.float32)
    return (nll * mask).sum() / mask.sum().clamp_min(1.0)


def loss_fn(cfg: ModelConfig, params: dict, batch: dict):
    """batch: {"tokens" or "embeddings", "labels"} (numpy arrays or
    tensors) -> the mean cross-entropy over labels >= 0, a f32 scalar."""
    dev = params["embed"].device
    tokens, emb = batch.get("tokens"), batch.get("embeddings")
    logits = forward(cfg, params,
                     tokens=None if tokens is None else torch.as_tensor(tokens, device=dev),
                     embeddings=None if emb is None else torch.as_tensor(emb, device=dev))
    return masked_xent(logits, batch["labels"])


# ------------------------------------------------------------------ serving


def make_cache(cfg: ModelConfig, batch: int, cache_len: int, device) -> dict:
    """Preallocated zero KV caches {"layers": (k, v)}, each
    (L, B, Hkv, cache_len, Dh) in ``cfg.dtype`` on ``device``."""
    shape = (cfg.n_layers, batch, cfg.kv_heads, cache_len, cfg.hd)
    return {"layers": (torch.zeros(shape, dtype=cfg.dtype, device=device),
                       torch.zeros(shape, dtype=cfg.dtype, device=device))}


def prefill(cfg: ModelConfig, params: dict, tokens=None, embeddings=None,
            cache_len: int = 0):
    """Seed KV caches of length max(cache_len, S).  Returns (last-position
    logits (B, V), caches, positions (B,) int32 all equal to S)."""
    x = _inputs(cfg, params, tokens, embeddings)
    b, s = x.shape[0], x.shape[1]
    caches = make_cache(cfg, b, max(cache_len, s), x.device)
    ks, vs = caches["layers"]
    for i, lp in enumerate(params["layers"]):
        x, (k, v) = _block(cfg, lp, x)
        ks[i, :, :, :s] = k
        vs[i, :, :, :s] = v
    logits = logits_fn(cfg, params, x[:, -1:])
    return logits[:, 0], caches, torch.full((b,), s, dtype=torch.int32, device=x.device)


def decode_step(cfg: ModelConfig, params: dict, token, caches: dict, pos):
    """One decode step.  token: (B,) ids; pos: (B,) int32 cache lengths.
    Writes the step's K/V into ``caches`` in place and returns
    (logits (B, V), the same caches, pos + 1)."""
    x = embed_tokens(cfg, params, token[:, None])
    ks, vs = caches["layers"]
    for i, lp in enumerate(params["layers"]):
        x, _ = _block(cfg, lp, x, kv_cache=(ks[i], vs[i]), cache_pos=pos)
    return logits_fn(cfg, params, x)[:, 0], caches, pos + 1
