"""A generic LLM front end for a configuration's ``canonicalizer`` entry:
the port's NL canonicalizer over a registry architecture, and the check of
its logits against a plain model reference.

The entry, in the configuration's file::

    "canonicalizer": {"module": "yardstick/llm.py", "arch": "<registry name>",
                      "reduced": false, "dtype": "bfloat16",
                      "model_reference": "yardstick/dense_ref.py"}

with ``limits.logit_gap`` in the configuration's ``limits``.

* ``build``: the canonicalizer as ``repro_torch.launch.serve.
  llm_canonicalizer`` wires it (``served_model``'s tokenizer over the
  port's NL vocabulary of the schema that the configuration's
  ``generator`` gives, and its head widened to the tokenizer,
  ``ServingEngine``, ``CanonicalizerService``, ``MemoizedNL``), with
  weights that the benchmark draws itself from the run's seed
  (``draw_params``), so that the reference can draw the same.
  The engine batches that reach the model are logged by the host clock.
* ``replay``: after the window, ``REPLAY_BATCHES`` of the window's engine
  batches, drawn from the seed, and the one of the longest question, put
  through the same service and engine once more, at the same batch
  compositions, with the model's prefill and decode steps watched: each
  row's prompt tokens (the pads before it left out), the tokens it was
  fed, and the logits of the prefill's last position and of each decode
  step that fed it a token.
* ``judge``: the weights drawn again from the seed, the model reference's
  ``forward(cfg, params, tokens)`` over each row's prompt and fed tokens,
  one row at a time and unpadded, and ``logit_gap``: the largest
  |program - reference| over the compared positions and the whole head,
  over the largest |reference| there.  No record (nothing reached the
  model in the window) reads infinite.
* ``control``: ``judge``'s numbers over the same batches twice, for the
  program as ``build`` makes it and for the same program with its
  weights rounded through FP8 (``weights_fp8``: e4m3, one scale per
  tensor, the precision below the bfloat16 a configuration serves in):
  the control, which has to fail.
* ``counters``: the engine's own counters, which the harness reads at
  the window's two ends (``Run.counters``, keyed ``nl.<name>``).

The engine left-pads a batch and its attention sees the pads (ROADMAP
Queue A), so a batch of questions of different lengths departs from the
unpadded reference; ``logit_gap`` shows it and is not to be quieted.
"""
from __future__ import annotations

import dataclasses
import math
import random
import time
import types

import numpy as np

from . import modules

# faults that the tests plant in the program: the logits rounded to
# bfloat16 where the model produces them; one weight of the output head
# moved by 1e-2; every matrix of the weights rounded through FP8 (the
# control's fault)
FAULTS = ("logits_bf16", "weight", "weights_fp8")
REPLAY_BATCHES = 4  # engine batches of the window that replay draws
FP8_MAX = 448.0  # the largest finite float8_e4m3fn
FP8_BLOCK = 1 << 26  # elements rounded at a time: bounds the float32 temporaries


@dataclasses.dataclass
class Front:
    """What the benchmark keeps of the canonicalizer it built."""

    service: object  # CanonicalizerService
    canonicalize_batch: object  # the service's own entry, unlogged
    batches: list  # (host clock, texts) of each engine batch


def model_config(config: dict):
    """(the served ``ModelConfig``, the tokenizer) of a configuration's
    canonicalizer entry: the registry's architecture (reduced where asked)
    in the entry's dtype, its head widened to the tokenizer of the
    generator's schema as ``served_model`` widens it."""
    import torch

    from repro_torch.configs import registry
    from repro_torch.launch.serve import WORKLOADS, served_model

    entry = config["canonicalizer"]
    base = registry.reduced(entry["arch"]) if entry.get("reduced") else registry.get(entry["arch"])
    if "dtype" in entry:
        base = dataclasses.replace(base, dtype=getattr(torch, entry["dtype"]))
    name = modules.load(config["generator"]).port_schema().name
    words = types.SimpleNamespace(name=name, vocab=WORKLOADS[name].build_vocab())
    cfg, _, tok, _ = served_model(base, words, None, "cpu")
    return cfg, tok


def draw_params(cfg, seed: int, device):
    """The model's weights from ``seed``: one normal draw per dtype on
    ``device`` (a generator there), in the dtype they are served in (the
    family's float32 leaves in float32), cut into the family's leaves in
    the order of sorted keys; a matrix scaled by fan_in ** -0.5 (fan_in =
    shape[-2]), a vector by 0.1 (a norm's scale is ``1 + w``)."""
    import torch

    f32 = cfg.build().FLOAT32_LEAVES
    leaves = []  # (shape, dtype) in the order they are cut

    def plan(tree, name=None):
        if isinstance(tree, dict):
            return {k: plan(tree[k], k) for k in sorted(tree)}
        if isinstance(tree, list):
            return [plan(v, name) for v in tree]
        leaves.append((tuple(tree), torch.float32 if name in f32 else cfg.dtype))
        return len(leaves) - 1

    layout = plan(cfg.param_shapes())
    gen = torch.Generator(device=device).manual_seed(seed % 2**64)
    bufs, at = {}, {}
    for dtype in dict.fromkeys(dt for _, dt in leaves):
        n = sum(math.prod(s) for s, dt in leaves if dt == dtype)
        bufs[dtype] = torch.randn(n, generator=gen, dtype=dtype, device=device)
        at[dtype] = 0
    views = []
    for shape, dtype in leaves:
        n = math.prod(shape)
        v = bufs[dtype][at[dtype]:at[dtype] + n].view(shape)
        at[dtype] += n
        v.mul_(shape[-2] ** -0.5 if len(shape) >= 2 else 0.1)
        views.append(v)

    def fill(tree):
        if isinstance(tree, dict):
            return {k: fill(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [fill(v) for v in tree]
        return views[tree]

    return fill(layout)


def build(config: dict, data, seed: int, device: str):
    """The tenant's NL canonicalizer (``MemoizedNL``), with the engine's
    batches logged."""
    from repro_torch.core.nl_canon import MemoizedNL
    from repro_torch.serving.engine import CanonicalizerService, ServingEngine

    cfg, tok = model_config(config)
    engine = ServingEngine(cfg, draw_params(cfg, seed, device), tok, device=device)
    service = CanonicalizerService(engine, modules.load(config["generator"]).port_schema().name)
    front = Front(service, service.canonicalize_batch, [])

    def logged(texts, now=None):
        front.batches.append((time.perf_counter(), list(texts)))
        return front.canonicalize_batch(texts, now)

    service.canonicalize_batch = logged
    nl = MemoizedNL(service)
    nl.bench_front = front
    return nl


class _Watch:
    """The engine's model module, with the prefill's and decode steps'
    tokens and logits kept for the batch being generated."""

    def __init__(self, mod):
        self._mod = mod

    def __getattr__(self, name):
        return getattr(self._mod, name)

    def prefill(self, cfg, params, tokens=None, **kw):
        out = self._mod.prefill(cfg, params, tokens=tokens, **kw)
        self.tokens = tokens.cpu().numpy()
        self.fed, self.logits = [], [out[0].float().cpu().numpy()]
        return out

    def decode_step(self, cfg, params, token, caches, pos):
        self.fed.append(token.cpu().numpy())
        out = self._mod.decode_step(cfg, params, token, caches, pos)
        self.logits.append(out[0].float().cpu().numpy())
        return out

    def records(self, pad: int) -> list[dict]:
        out = []
        for i, row in enumerate(self.tokens):
            fed = []
            for step in self.fed:
                if step[i] == pad:
                    break
                fed.append(int(step[i]))
            out.append({"prompt": row[int(np.argmax(row != pad)):].tolist(), "fed": fed,
                        "logits": np.stack([lg[i] for lg in self.logits[:len(fed) + 1]])})
        return out


def capture(nl, batches: list[list[str]]) -> list[dict]:
    """Each batch of questions through the canonicalizer's service and
    engine once more, watched: one record per question."""
    front = nl.bench_front
    engine = front.service.engine
    real = engine.mod
    watch = engine.mod = _Watch(real)
    records = []
    try:
        for texts in batches:
            front.canonicalize_batch(texts)
            records += watch.records(engine.tok.pad)
    finally:
        engine.mod = real
    return records


def replay(nl, run, seed: int, log) -> list[dict]:
    """The records of a seeded sample of the window's engine batches."""
    window = [texts for t, texts in nl.bench_front.batches if t >= run.opened]
    picked = sorted(random.Random(f"{seed}|replay").sample(
        range(len(window)), min(REPLAY_BATCHES, len(window))))
    if window:
        longest = max(range(len(window)), key=lambda i: max(len(t) for t in window[i]))
        picked = sorted(set(picked) | {longest})
    t0 = time.perf_counter()
    records = capture(nl, [window[i] for i in picked])
    log(f"[replay] {len(picked)} of the window's {len(window)} engine batches "
        f"(sizes {[len(window[i]) for i in picked]}), {sum(len(r['fed']) + 1 for r in records)} "
        f"positions in {time.perf_counter() - t0:.3f} s")
    return records


def judge(records: list[dict], config: dict, seed: int, device: str) -> dict:
    """``logit_gap`` of the records against the model reference, with its
    limit."""
    import torch

    entry = config["canonicalizer"]
    limit = config["limits"]["logit_gap"]
    if not records:
        return {"logit_gap": {"value": float("inf"), "limit": limit}}
    cfg, _ = model_config(config)
    params = draw_params(cfg, seed, device)
    ref = modules.load(entry["model_reference"])
    sizes = {**dataclasses.asdict(cfg), "head_dim": cfg.hd, "dtype": str(cfg.dtype)}
    worst = scale = 0.0
    with torch.inference_mode():
        for r in records:
            tokens = torch.tensor([r["prompt"] + r["fed"]], device=device)
            p0 = len(r["prompt"]) - 1
            want = ref.forward(sizes, params, tokens)[0, p0:p0 + len(r["logits"])]
            want = want.cpu().numpy()
            worst = max(worst, float(np.abs(r["logits"] - want).max()))
            scale = max(scale, float(np.abs(want).max()))
    return {"logit_gap": {"value": worst / scale, "limit": limit}}


def counters(nl) -> dict:
    """The engine's counters: its own ``counters()`` where it has one,
    else its decode ``steps`` and the seconds of host work (``host_s``)
    and of model work (``model_s``) in its decode loop."""
    engine = nl.bench_front.service.engine
    if hasattr(engine, "counters"):
        return dict(engine.counters())
    return {"steps": engine.steps, "host_s": engine.host_s, "model_s": engine.model_s}


def round_fp8(cfg, params, keep: bool = False) -> list:
    """Every matrix leaf of ``params`` (the family's float32 leaves and
    the vectors left as they are) rounded in place through
    ``float8_e4m3fn`` and back to its dtype, with one scale per tensor,
    amax / 448: the usual recipe of FP8 inference.  With ``keep``, returns
    each rounded leaf with a copy of it from before, on the host (a second
    copy on the card would not fit beside a large model)."""
    import torch

    f32 = cfg.build().FLOAT32_LEAVES
    leaves = []

    def walk(tree, name=None):
        if isinstance(tree, dict):
            for k, v in tree.items():
                walk(v, k)
        elif isinstance(tree, list):
            for v in tree:
                walk(v, name)
        elif tree.dim() >= 2 and name not in f32:
            leaves.append(tree)

    walk(params)
    kept = []
    with torch.no_grad():
        for w in leaves:
            if keep:
                kept.append((w, w.to("cpu", copy=True)))
            lo, hi = torch.aminmax(w)
            amax = max(-float(lo), float(hi))
            scale = amax / FP8_MAX if amax > 0 else 1.0
            rows = max(1, FP8_BLOCK // max(1, w[0].numel()))
            for part in w.split(rows):
                q = (part.float() / scale).clamp_(-FP8_MAX, FP8_MAX).to(torch.float8_e4m3fn)
                part.copy_(q.float() * scale)
    return kept


def control(config: dict, data, seed: int, device: str,
            batches: list[list[str]]) -> tuple[dict, dict]:
    """(``judge``'s numbers for the program, the same for its control):
    ``batches`` (each one engine batch of questions) through the program
    as ``build`` makes it, then through the same program with its weights
    rounded through FP8; both judged once the program is gone, so that
    the reference may use the card."""
    import gc

    import torch

    nl = build(config, data, seed, device)
    sound = capture(nl, batches)
    engine = nl.bench_front.service.engine
    round_fp8(engine.cfg, engine.params)
    fp8 = capture(nl, batches)
    del nl, engine
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    return judge(sound, config, seed, device), judge(fp8, config, seed, device)


def plant(fault: str, nl):
    """One of ``FAULTS`` in the canonicalizer's model; returns the function
    that undoes it."""
    import torch

    engine = nl.bench_front.service.engine
    if fault == "weights_fp8":
        kept = round_fp8(engine.cfg, engine.params, keep=True)

        def undo():
            with torch.no_grad():
                for w, before in kept:
                    w.copy_(before)
        return undo
    if fault == "logits_bf16":
        real = engine.mod

        class Rounded(_Watch):
            def prefill(self, cfg, params, tokens=None, **kw):
                lg, caches, pos = self._mod.prefill(cfg, params, tokens=tokens, **kw)
                return lg.to(torch.bfloat16).float(), caches, pos

            def decode_step(self, cfg, params, token, caches, pos):
                lg, caches, pos = self._mod.decode_step(cfg, params, token, caches, pos)
                return lg.to(torch.bfloat16).float(), caches, pos

        engine.mod = Rounded(real)

        def undo():
            engine.mod = real
        return undo
    if fault == "weight":
        head = engine.params["lm_head"] if "lm_head" in engine.params else engine.params["embed"]
        with torch.no_grad():
            head.view(-1)[0] += 1e-2

        def undo():
            with torch.no_grad():
                head.view(-1)[0] -= 1e-2
        return undo
    raise ValueError(f"unknown fault {fault!r}: {FAULTS}")
