"""Batched serving engine + the LLM canonicalizer service.

The port of the JAX package's ``repro/serving/engine.py``, with its control
flow: prompts are left-padded into one batch and prefilled together, then a
greedy (optionally JSON-constrained) decode loop runs one ``decode_step``
per token for the whole batch.  The model runs on the engine's device
(``cuda`` unless the caller asks for the CPU): on the card prefill reaches
the flash-attention kernel and every decode step the decode-attention
kernel.  Each step copies the logits to the host, where the JSON automaton
masks them and the next ids are picked.

``CanonicalizerService`` plugs the engine behind the NLCanonicalizer
protocol: prompt = header + NL question, output = intent-signature JSON +
confidence (mean token log-probability through a squashing map, the
paper's uncalibrated heuristic score).
"""
from __future__ import annotations

import datetime as _dt
import json
import math
import time
from typing import Optional

import numpy as np
import torch

from ..core.nl_canon import NLResult
from ..core.signature import signature_from_json
from ..models.model import ModelConfig
from ..olap.columnar import resolve_device
from .json_decode import JsonSigAutomaton, constrained_sample


class ServingEngine:
    """``params`` are moved to ``device`` once.  Counters: ``steps`` decode
    steps run; ``host_s`` seconds of host work in the decode loop (logit
    masking, sampling, bookkeeping); ``model_s`` seconds spent in prefill,
    decode steps and the logits copies that wait for them."""

    def __init__(self, cfg: ModelConfig, params: dict, tokenizer,
                 max_len: int = 512, device="cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.mod = cfg.build()
        self.params = self.mod.to_device(params, self.device)
        self.tok = tokenizer
        self.max_len = max_len
        self.vocab = [tokenizer.id_to_str(i) for i in range(tokenizer.vocab_size)]
        self.steps = 0
        self.host_s = 0.0
        self.model_s = 0.0

    @torch.inference_mode()
    def generate(self, prompts: list[str], max_new_tokens: int = 128,
                 constrained: bool = False) -> list[dict]:
        """Batched generation; returns [{'text', 'logprob', 'tokens'}]."""
        t_model = time.perf_counter()
        b = len(prompts)
        enc = [self.tok.encode(p, add_bos=True)[-self.max_len // 2:] for p in prompts]
        plen = max(len(e) for e in enc)
        tokens = np.full((b, plen), self.tok.pad, np.int32)
        for i, e in enumerate(enc):
            tokens[i, plen - len(e):] = e  # left-pad so last position aligns
        logits, caches, pos = self.mod.prefill(
            self.cfg, self.params, tokens=torch.from_numpy(tokens).to(self.device),
            cache_len=self.max_len)
        automaton = JsonSigAutomaton()
        vocab = self.vocab
        outs = [[] for _ in range(b)]
        texts = [""] * b
        logprobs = [0.0] * b
        done = [False] * b
        for _ in range(max_new_tokens):
            # model head may be wider than the tokenizer: drop phantom ids
            np_logits = logits.to(torch.float32).cpu().numpy()[:, :len(vocab)]
            t_host = time.perf_counter()
            self.model_s += t_host - t_model
            next_ids = np.zeros(b, np.int32)
            for i in range(b):
                if done[i]:
                    next_ids[i] = self.tok.pad
                    continue
                if constrained:
                    nid = constrained_sample(np_logits[i], texts[i], vocab, automaton)
                    if nid < 0:
                        done[i] = True
                        next_ids[i] = self.tok.pad
                        continue
                else:
                    nid = int(np.argmax(np_logits[i]))
                lp = np_logits[i] - _logsumexp(np_logits[i])
                logprobs[i] += float(lp[nid])
                next_ids[i] = nid
                outs[i].append(nid)
                texts[i] += vocab[nid]
                if nid == self.tok.eos or (constrained and automaton.is_complete(texts[i])):
                    done[i] = True
            t_model = time.perf_counter()
            self.host_s += t_model - t_host
            if all(done):
                break
            logits, caches, pos = self.mod.decode_step(
                self.cfg, self.params, torch.from_numpy(next_ids).to(self.device),
                caches, pos)
            self.steps += 1
        return [
            {"text": texts[i], "tokens": outs[i],
             "logprob": logprobs[i] / max(len(outs[i]), 1)}
            for i in range(b)
        ]


def _logsumexp(x):
    m = x.max()
    return m + math.log(np.exp(x - m).sum())


class CanonicalizerService:
    """NL -> signature through the in-framework LLM (NLCanonicalizer protocol)."""

    def __init__(self, engine: ServingEngine, schema_name: str,
                 prompt_header: str = "", deadline_s: Optional[float] = None):
        self.engine = engine
        self.schema_name = schema_name
        self.prompt_header = prompt_header
        # soft per-call budget: the engine's decode loop is not preemptible,
        # so the deadline is checked after the pass — an overrun batch
        # reports structured timeout NLResults instead of burning the cache
        # path on answers nobody is waiting for anymore
        self.deadline_s = deadline_s
        self.deadline_overruns = 0

    def canonicalize(self, text: str, now: Optional[_dt.date] = None) -> NLResult:
        return self.canonicalize_batch([text], now)[0]

    def canonicalize_batch(self, texts: list[str],
                           now: Optional[_dt.date] = None) -> list[NLResult]:
        """Pipeline-stage entry point: the whole batch of NL requests is
        decoded by one batched prefill+decode pass of the engine."""
        prompts = [f"{self.prompt_header}question: {t}\nsignature: " for t in texts]
        t0 = time.perf_counter()
        outs = self.engine.generate(prompts, constrained=True)
        if self.deadline_s is not None \
                and (time.perf_counter() - t0) > self.deadline_s:
            self.deadline_overruns += 1
            return [NLResult(None, 0.0, "",
                             f"canonicalizer deadline exceeded "
                             f"({self.deadline_s:.3f}s)") for _ in texts]
        results = []
        for out in outs:
            raw = out["text"]
            confidence = 1.0 / (1.0 + math.exp(-(out["logprob"] + 1.0)))  # squashed heuristic
            try:
                obj = json.loads(raw)
                obj.setdefault("schema", self.schema_name)
                sig = signature_from_json(obj)
            except Exception as e:  # noqa: BLE001 — any malformed output is a safe failure
                results.append(NLResult(None, round(confidence, 3), raw,
                                        f"malformed JSON: {e}"))
                continue
            results.append(NLResult(sig, round(confidence, 3), raw, None))
        return results
