"""Mamba2 (SSD) attention-free LM: the port of the JAX package's
``repro/models/mamba2.py``.

Each block: RMSNorm -> {z, x, B, C, dt} projections -> short causal
depthwise conv on the x path -> chunked SSD scan -> D-skip -> silu(z)
gating -> output projection.  Parameters are a dict like the dense
transformer's, one dict per layer:

  {"embed": (V, D), "layers": [{"ln1", "wz", "wx", "wb", "wc", "wdt",
   "dt_bias", "a_log", "d_skip", "conv", "out_proj"}, ...],
   "final_norm": (D,), ["lm_head": (D, V)]}

``dt_bias``, ``a_log`` and ``d_skip`` stay float32 whatever ``cfg.dtype``
is, as in JAX.  The serving cache is the per-layer pair (SSM state, conv
buffer): preallocated (L, B, H, P, N) float32 and (L, B, K-1, d_inner) in
``cfg.dtype``, O(1) in sequence length.  ``prefill`` runs each layer once
and seeds the state from the same ``ssd_scan`` call that computes the
layer's output (JAX's prefill runs each layer's projections, conv and scan
a second time for ``ssd_final_state``); ``decode_step`` writes both caches
in place.  On the card every prefill and ``forward`` layer launches the
SSD-scan kernel; the decode step's single SSD step and conv stay plain
PyTorch, as they are plain jnp in JAX.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..distributed import local
from ..distributed.sharding import cache_zeros, hint
from ..kernels.ssd_scan.ops import ssd_scan, ssd_step
from .layers import rmsnorm
from .model import ModelConfig, init_by_rule
from .transformer import _inputs, batch_loss, embed_tokens, logits_fn
from .transformer import to_device  # noqa: F401  (the family interface the engine calls)

FLOAT32_LEAVES = frozenset({"dt_bias", "a_log", "d_skip"})


def block_param_shapes(cfg: ModelConfig) -> dict:
    di, n, h, d = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.d_model
    return {"ln1": (d,), "wz": (d, di), "wx": (d, di), "wb": (d, n), "wc": (d, n),
            "wdt": (d, h), "dt_bias": (h,), "a_log": (h,), "d_skip": (h,),
            "conv": (cfg.conv_kernel, di), "out_proj": (di, d)}


def param_shapes(cfg: ModelConfig) -> dict:
    out = {"embed": (cfg.vocab, cfg.d_model),
           "layers": [block_param_shapes(cfg) for _ in range(cfg.n_layers)],
           "final_norm": (cfg.d_model,)}
    if not cfg.tie_embeddings:
        out["lm_head"] = (cfg.d_model, cfg.vocab)
    return out


def init_params(cfg: ModelConfig, generator: "torch.Generator | int" = 0,
                device="cuda") -> dict:
    """The JAX package's init rule (``init_by_rule``) on this family's
    shapes, then JAX's SSD overrides: decay rates a_log = log(linspace(1, 8,
    H)) (A from -1 to -8), dt_bias -2, d_skip 1, all float32."""
    params = init_by_rule(cfg, param_shapes(cfg), generator, device)
    ssd_overrides(cfg, params["layers"])
    return params


def ssd_overrides(cfg: ModelConfig, layers: list) -> None:
    """JAX's SSD init of each layer dict in ``layers``, in place, float32 on
    the layer's device."""
    h, f32 = cfg.ssm_heads, torch.float32
    a_log = torch.log(torch.linspace(1.0, 8.0, h, dtype=f32))
    for lp in layers:
        dev = lp["wx"].device
        lp["a_log"] = a_log.to(dev)
        lp["dt_bias"] = torch.full((h,), -2.0, dtype=f32, device=dev)
        lp["d_skip"] = torch.ones(h, dtype=f32, device=dev)


# ------------------------------------------------------------------ forward


def _causal_conv(x, w):
    """x: (B, S, di); w: (K, di) depthwise causal conv, K taps unrolled.
    DTensors go through ``distributed.local.call``: each rank convolves its
    own batch rows and channels over the whole sequence (DTensor's padding
    of a split tensor fails in some torch versions)."""
    if local.any_dtensor(x, w):
        return local.call(lambda _, xl, wl: _causal_conv(xl, wl),
                          [local.Arg(x, 0, 2), local.Arg(w, None, 1)], [(0, 2)])
    k = w.shape[0]
    xp = F.pad(x, (0, 0, k - 1, 0))
    out = torch.zeros_like(x)
    for i in range(k):
        out = out + xp[:, i: i + x.shape[1]] * w[i]
    return out


def _block(cfg: ModelConfig, lp: dict, x, state=None, conv_buf=None,
           want_state: bool = False):
    """x: (B, S, D).  Prefill/forward when ``state`` is None: returns
    (x + out, the final SSM state if ``want_state`` else None, the pre-conv
    stream (B, S, di)).  Decode with ``state`` (B, H, P, N) and ``conv_buf``
    (B, K-1, di): returns (x + out, the new state, the new conv buffer)."""
    b, s, _ = x.shape
    h, p = cfg.ssm_heads, cfg.ssm_head_dim
    xin = rmsnorm(x, lp["ln1"])
    z = xin @ lp["wz"]
    x_raw = xin @ lp["wx"]  # pre-conv stream: what the decode conv buffer holds
    bm = (xin @ lp["wb"]).to(torch.float32)
    cm = (xin @ lp["wc"]).to(torch.float32)
    dt = F.softplus((xin @ lp["wdt"]).to(torch.float32) + lp["dt_bias"])
    a = -torch.exp(lp["a_log"].to(torch.float32))

    # the elementwise chains (conv + silu; skip + gate) run in f32 and round
    # once to x's dtype, as XLA's fusions of the JAX code do
    if state is None:
        xr = F.silu(_causal_conv(x_raw.float(), lp["conv"].float()))
        xr = xr.to(x.dtype).reshape(b, s, h, p)
        out = ssd_scan(xr, dt, a, bm, cm, chunk=128, return_state=want_state)
        y, new_state = out if want_state else (out, None)
        skip = lp["d_skip"][None, None, :, None]
        tail = x_raw
    else:
        window = torch.cat([conv_buf, x_raw], dim=1)  # (B, K, di)
        xr = F.silu((window.float() * lp["conv"].float()[None]).sum(dim=1, keepdim=True))
        xr = xr.to(x.dtype).reshape(b, h, p)
        y, new_state = ssd_step(state, xr, dt[:, 0], a, bm[:, 0], cm[:, 0])
        skip = lp["d_skip"][None, :, None]
        tail = window[:, 1:]
    y = y.float() + xr.float() * skip.to(xr.dtype).float()
    y = (y.reshape(b, s, -1) * F.silu(z.float())).to(x.dtype)
    return hint(x + y @ lp["out_proj"], "residual"), new_state, tail


def forward(cfg: ModelConfig, params: dict, tokens=None, embeddings=None):
    """Scoring forward -> logits (B, S, V) in f32."""
    x = _inputs(cfg, params, tokens, embeddings)
    for lp in params["layers"]:
        x, _, _ = _block(cfg, lp, x)
    return logits_fn(cfg, params, x)


def loss_fn(cfg: ModelConfig, params: dict, batch: dict):
    """batch: {"tokens" or "embeddings", "labels"} -> the mean cross-entropy
    over labels >= 0, a f32 scalar.  On the card the SSD-scan kernel has no
    backward yet, so a loss under grad raises there (ROADMAP.md Queue 1
    item 1); on the CPU it differentiates the plain scan."""
    return batch_loss(forward, cfg, params, batch)


# ------------------------------------------------------------------ serving


def make_cache(cfg: ModelConfig, batch: int, cache_len: int, device) -> dict:
    """Preallocated zero caches: "state" (L, B, H, P, N) float32 and "conv"
    (L, B, K-1, d_inner) in ``cfg.dtype``.  ``cache_len`` is moot (the
    state is O(1) in sequence length); kept for interface parity."""
    return {
        "state": cache_zeros("state", (cfg.n_layers, batch, cfg.ssm_heads,
                                       cfg.ssm_head_dim, cfg.ssm_state),
                             torch.float32, device),
        "conv": cache_zeros("conv", (cfg.n_layers, batch, cfg.conv_kernel - 1,
                                     cfg.d_inner), cfg.dtype, device),
    }


def prefill(cfg: ModelConfig, params: dict, tokens=None, embeddings=None,
            cache_len: int = 0):
    """Returns (last-position logits (B, V), caches, positions (B,) int32
    all equal to S).  A prompt shorter than K-1 leaves the conv buffer's
    leading slots zero, the causal conv's own padding."""
    x = _inputs(cfg, params, tokens, embeddings)
    b, s = x.shape[0], x.shape[1]
    caches = make_cache(cfg, b, cache_len, x.device)
    for i, lp in enumerate(params["layers"]):
        x = prefill_layer(cfg, lp, x, caches, i)
    logits = logits_fn(cfg, params, x[:, -1:])
    return logits[:, 0], caches, torch.full((b,), s, dtype=torch.int32, device=x.device)


def prefill_layer(cfg: ModelConfig, lp: dict, x, caches: dict, i: int):
    """Layer ``i`` over the prompt: seeds ``caches["state"][i]`` from the
    scan's final state and ``caches["conv"][i]`` from the last K-1 rows of
    the pre-conv stream; returns the layer's output."""
    k1 = cfg.conv_kernel - 1
    x, state, x_raw = _block(cfg, lp, x, want_state=True)
    caches["state"][i] = state
    tail = x_raw[:, -k1:]
    caches["conv"][i, :, k1 - tail.shape[1]:] = tail
    return x


def decode_layer(cfg: ModelConfig, lp: dict, x, caches: dict, i: int):
    """Layer ``i`` for one token: its state and conv buffer in ``caches``
    written in place; returns the layer's output."""
    x, state, buf = _block(cfg, lp, x, state=caches["state"][i], conv_buf=caches["conv"][i])
    caches["state"][i].copy_(state)
    caches["conv"][i].copy_(buf)
    return x


def decode_step(cfg: ModelConfig, params: dict, token, caches: dict, pos):
    """One decode step.  token: (B,) ids.  Writes each layer's new state and
    conv buffer into ``caches`` in place and returns (logits (B, V), the
    same caches, pos + 1)."""
    x = embed_tokens(cfg, params, token[:, None])
    for i, lp in enumerate(params["layers"]):
        x = decode_layer(cfg, lp, x, caches, i)
    return logits_fn(cfg, params, x)[:, 0], caches, pos + 1
