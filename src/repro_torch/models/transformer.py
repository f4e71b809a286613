"""Decoder-only transformer (dense and MoE families): the port of the JAX
package's ``repro/models/transformer.py``.

Parameters are a plain dict of tensors on one device, with JAX's names and
``x @ W`` layout; each JAX stacked (L, ...) layer subtree becomes a list of
per-layer dicts, run in a Python loop:

  {"embed": (V, D), ["dense_layers": [...],] "layers": [{"wq", "wk", "wv",
   "wo", ["q_norm", "k_norm"], "mlp_w1", ["mlp_w3"], "mlp_w2" | the MoE
   leaves of ``moe.moe_param_shapes``, "ln1", "ln2"}, ...],
   "final_norm": (D,), ["lm_head": (D, V)]}

An MoE config's ``layers`` hold the experts (``moe_w1`` (E_shards, E_local,
D, F), ``router`` (D, E) float32, ...) and its first ``dense_layers``
layers, a stack of their own, a dense FFN of width max(d_ff, 4 d_model),
as in JAX.  A block whose dict has ``moe_w1`` runs ``moe.moe_ffn``.

The device is the parameters' device: ``init_params`` puts them on
``device`` (``cuda`` unless the caller asks for the CPU), and every
function computes where its parameters live.  The same code serves:

  * ``forward``     — full-sequence logits (B, S, V),
  * ``loss_fn``     — the training loss over a batch of tokens and labels,
  * ``prefill``     — a forward that seeds preallocated KV caches (one
    (k, v) pair per stack: ``"dense_layers"`` beside ``"layers"``),
  * ``decode_step`` — one token against those caches, written in place.

Audio/VLM archs (musicgen/pixtral) set ``embed_inputs=True``: prefill and
forward take precomputed frame/patch ``embeddings``; decode takes token ids.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..distributed.sharding import cache_zeros, hint, settle
from .layers import attention, attn_param_shapes, mlp, mlp_param_shapes, rmsnorm
from .model import STACKS, ModelConfig, init_by_rule, tree_map
from .moe import expert_shards, moe_ffn, moe_param_shapes


def param_shapes(cfg: ModelConfig) -> dict:
    attn = attn_param_shapes(cfg.d_model, cfg.n_heads, cfg.kv_heads, cfg.hd, cfg.qk_norm)
    norms = {"ln1": (cfg.d_model,), "ln2": (cfg.d_model,)}

    def dense_block(d_ff):
        return {**attn, **{f"mlp_{k}": v for k, v in
                           mlp_param_shapes(cfg.d_model, d_ff, cfg.activation).items()},
                **norms}

    out: dict = {"embed": (cfg.vocab, cfg.d_model)}
    if cfg.kind == "moe":
        if cfg.dense_layers:
            # the leading dense layers take a wider FFN: 4 d_model where
            # d_ff is the per-expert width
            dense_ff = max(cfg.d_ff, 4 * cfg.d_model)
            out["dense_layers"] = [dense_block(dense_ff) for _ in range(cfg.dense_layers)]
        mblock = {**attn, **moe_param_shapes(cfg, expert_shards(cfg)), **norms}
        out["layers"] = [dict(mblock) for _ in range(cfg.n_layers - cfg.dense_layers)]
    else:
        out["layers"] = [dense_block(cfg.d_ff) for _ in range(cfg.n_layers)]
    out["final_norm"] = (cfg.d_model,)
    if not cfg.tie_embeddings:
        out["lm_head"] = (cfg.d_model, cfg.vocab)
    return out


# leaves that stay float32 whatever ``cfg.dtype`` is: the MoE router
FLOAT32_LEAVES: frozenset = frozenset({"router"})


def init_params(cfg: ModelConfig, generator: "torch.Generator | int" = 0,
                device="cuda") -> dict:
    """Random parameters by the JAX package's rule (``init_by_rule``)."""
    return init_by_rule(cfg, param_shapes(cfg), generator, device)


def to_device(params: dict, device) -> dict:
    """The same parameters on ``device``."""
    return tree_map(lambda t: t.to(device), params)


def _stacks(params: dict) -> list[str]:
    """The layer stacks that hold a layer, in the order they run."""
    return [k for k in STACKS if params.get(k)]


# ------------------------------------------------------------------ forward


def _block(cfg: ModelConfig, lp: dict, x, kv_cache=None, cache_pos=None):
    h, kv = attention(
        lp, rmsnorm(x, lp["ln1"]),
        n_heads=cfg.n_heads, kv_heads=cfg.kv_heads, head_dim=cfg.hd,
        qk_norm=cfg.qk_norm, rope_theta=cfg.rope_theta,
        rope_fraction=cfg.rope_fraction, kv_cache=kv_cache, cache_pos=cache_pos,
    )
    x = hint(x + h, "residual")
    hin = rmsnorm(x, lp["ln2"])
    if "moe_w1" in lp:
        h = moe_ffn(lp, hin, cfg)
    else:
        h = mlp({k[4:]: v for k, v in lp.items() if k.startswith("mlp_")},
                hin, cfg.activation)
    return hint(x + h, "residual"), kv


def embed_tokens(cfg: ModelConfig, params: dict, tokens):
    x = settle(F.embedding(tokens.long(), params["embed"])).to(cfg.dtype)
    if cfg.kind in ("dense", "moe") and cfg.name.startswith("gemma"):
        x = x * (cfg.d_model ** 0.5)
    return x


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
    x = hint(_inputs(cfg, params, tokens, embeddings), "residual")
    for stack in _stacks(params):
        for lp in params[stack]:
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


def batch_loss(forward_fn, cfg: ModelConfig, params: dict, batch: dict):
    """``masked_xent`` of ``forward_fn``'s logits over ``batch``, whose
    numpy arrays or tensors are moved to the parameters' device."""
    dev = params["embed"].device
    tokens, emb = batch.get("tokens"), batch.get("embeddings")
    logits = forward_fn(cfg, params,
                        tokens=None if tokens is None else torch.as_tensor(tokens, device=dev),
                        embeddings=None if emb is None else torch.as_tensor(emb, device=dev))
    return masked_xent(logits, batch["labels"])


def loss_fn(cfg: ModelConfig, params: dict, batch: dict):
    """batch: {"tokens" or "embeddings", "labels"} (numpy arrays or
    tensors) -> the mean cross-entropy over labels >= 0, a f32 scalar."""
    return batch_loss(forward, cfg, params, batch)


# ------------------------------------------------------------------ serving


def make_cache(cfg: ModelConfig, batch: int, cache_len: int, device) -> dict:
    """Preallocated zero KV caches, one (k, v) pair per stack: {"layers":
    (k, v)} and, for an MoE config with leading dense layers,
    "dense_layers"; each (L_stack, B, Hkv, cache_len, Dh) in ``cfg.dtype``
    on ``device``."""
    n_dense = cfg.dense_layers if cfg.kind == "moe" else 0
    out = {}
    for stack, n in (("dense_layers", n_dense), ("layers", cfg.n_layers - n_dense)):
        if n:
            shape = (n, batch, cfg.kv_heads, cache_len, cfg.hd)
            out[stack] = (cache_zeros(stack, shape, cfg.dtype, device),
                          cache_zeros(stack, shape, cfg.dtype, device))
    return out


def prefill(cfg: ModelConfig, params: dict, tokens=None, embeddings=None,
            cache_len: int = 0):
    """Seed KV caches of length max(cache_len, S).  Returns (last-position
    logits (B, V), caches, positions (B,) int32 all equal to S)."""
    x = _inputs(cfg, params, tokens, embeddings)
    b, s = x.shape[0], x.shape[1]
    caches = make_cache(cfg, b, max(cache_len, s), x.device)
    for stack in _stacks(params):
        ks, vs = caches[stack]
        for i, lp in enumerate(params[stack]):
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
    for stack in _stacks(params):
        ks, vs = caches[stack]
        for i, lp in enumerate(params[stack]):
            x, _ = _block(cfg, lp, x, kv_cache=(ks[i], vs[i]), cache_pos=pos)
    return logits_fn(cfg, params, x)[:, 0], caches, pos + 1
