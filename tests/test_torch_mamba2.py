"""The port's Mamba2 against the JAX package's, on the CPU (the SSD scan
takes its plain chunked version there).

* ``params_from_jax`` on ``reduced("mamba2-780m")``: exact values, the
  float32 leaves (``dt_bias``, ``a_log``, ``d_skip``) kept float32;
* ``init_params``: the generic rule plus JAX's SSD overrides;
* ``forward`` / ``prefill`` / ``decode_step`` logits and caches from the
  same converted weights and tokens.  float32: rtol = atol = 1e-4 at
  S = 32.  bfloat16: 5e-2 at S = 8, as ``test_dense_logits_match_jax``
  and for the same reason (XLA keeps float32 inside fused elementwise
  chains, PyTorch rounds after each op);
* ``ServingEngine.generate`` at vocab 4096 and ``max_len`` 128 against the
  JAX engine: identical tokens and texts, constrained and not;
* ``llm_canonicalizer(arch="mamba2-780m", reduced=True)`` serves an NL
  batch through the cache service.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import reduced as jreduced
from repro.serving import engine as jengine
from repro.training.tokenizer import build_tokenizer as jbuild_tokenizer
from repro_torch.configs.registry import reduced
from repro_torch.kernels.binding import launch_counts, reset_launch_counts
from repro_torch.launch import serve
from repro_torch.models import mamba2
from repro_torch.models.convert import params_from_jax
from repro_torch.serving import engine
from repro_torch.service import CacheService, QueryRequest
from repro_torch.training.tokenizer import build_tokenizer
from repro_torch.workloads import ssb

NAME = "mamba2-780m"
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
F32_LEAVES = ("dt_bias", "a_log", "d_skip")


def _jax_params(dtype=jnp.float32, key=0, **kw):
    cfg = dataclasses.replace(jreduced(NAME), dtype=dtype, **kw)
    return cfg, cfg.build().init_params(cfg, jax.random.PRNGKey(key))


def _port_cfg(dtype, **kw):
    return dataclasses.replace(reduced(NAME), dtype=dtype, **kw)


def _tree(p):
    return jax.tree.map(np.asarray, p)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_params_from_jax_keeps_float32_leaves(dtype):
    jd, td = DTYPES[dtype]
    jcfg, jp = _jax_params(jd)
    tcfg = _port_cfg(td)
    tp = params_from_jax(tcfg, _tree(jp), device="cpu")
    assert sorted(tp) == sorted(jp) and len(tp["layers"]) == jcfg.n_layers
    assert mamba2.param_shapes(tcfg) == {
        k: ([{n: tuple(t.shape) for n, t in lp.items()} for lp in v] if k == "layers"
            else tuple(v.shape)) for k, v in tp.items()}
    for n, stacked in jp["layers"].items():
        got = torch.stack([lp[n] for lp in tp["layers"]])
        assert got.dtype == (torch.float32 if n in F32_LEAVES else td), n
        assert np.asarray(stacked).dtype == (np.float32 if n in F32_LEAVES
                                             else np.dtype(jd)), n
        np.testing.assert_array_equal(got.float().numpy(), np.asarray(stacked, np.float32))
    for k in ("embed", "final_norm", "lm_head"):
        assert tp[k].dtype == td
        np.testing.assert_array_equal(tp[k].float().numpy(), np.asarray(jp[k], np.float32))


def test_init_params_applies_the_ssd_overrides():
    cfg = _port_cfg(torch.bfloat16)
    p = mamba2.init_params(cfg, 3, device="cpu")
    _, jp = _jax_params(jnp.bfloat16)
    for n in F32_LEAVES:
        for lp in p["layers"]:
            assert lp[n].dtype == torch.float32
            np.testing.assert_allclose(lp[n].numpy(), np.asarray(jp["layers"][n][0]),
                                       rtol=1e-6)
    lp = p["layers"][1]
    assert lp["wx"].dtype == torch.bfloat16 and not lp["ln1"].any()
    std = float(lp["wz"].float().std())
    assert abs(std * cfg.d_model ** 0.5 - 1.0) < 0.1  # std = fan_in ** -0.5
    again = mamba2.init_params(cfg, torch.Generator().manual_seed(3), device="cpu")
    assert torch.equal(again["layers"][0]["conv"], p["layers"][0]["conv"])


def _tokens(vocab, b, s, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, size=(b, s)).astype(np.int32)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_logits_and_caches_match_jax(dtype):
    jd, td = DTYPES[dtype]
    b, s, tol = (2, 32, 1e-4) if dtype == "float32" else (2, 8, 5e-2)
    jcfg, jp = _jax_params(jd)  # JAX's own init: f32 leaves stay f32
    mod = jcfg.build()
    tcfg = _port_cfg(td)
    tp = params_from_jax(tcfg, _tree(jp), device="cpu")
    tokens = _tokens(jcfg.vocab, b, s)
    nxt = tokens[:, -1]

    @jax.jit
    def run(p, tokens):
        full = mod.forward(jcfg, p, tokens=tokens)
        logits, caches, pos = mod.prefill(jcfg, p, tokens=tokens, cache_len=s + 8)
        step, caches2, pos2 = mod.decode_step(jcfg, p, nxt, caches, pos)
        return full, logits, step, pos2, caches, caches2

    jfull, jlogits, jstep, jpos2, jc, jc2 = run(jp, jnp.asarray(tokens))
    with torch.inference_mode():
        full = mamba2.forward(tcfg, tp, tokens=torch.from_numpy(tokens))
        logits, caches, pos = mamba2.prefill(tcfg, tp, tokens=torch.from_numpy(tokens),
                                             cache_len=s + 8)
        assert caches["state"].shape == (tcfg.n_layers, b, tcfg.ssm_heads,
                                         tcfg.ssm_head_dim, tcfg.ssm_state)
        assert caches["state"].dtype == torch.float32 and caches["conv"].dtype == td
        for key in ("state", "conv"):
            np.testing.assert_allclose(caches[key].float().numpy(),
                                       np.asarray(jc[key]).astype(np.float32),
                                       rtol=tol, atol=tol, err_msg=f"prefill {key}")
        state, conv = caches["state"], caches["conv"]
        step, caches2, pos2 = mamba2.decode_step(tcfg, tp, torch.from_numpy(nxt), caches, pos)
    assert caches2 is caches and caches2["state"] is state and caches2["conv"] is conv
    for key in ("state", "conv"):
        np.testing.assert_allclose(caches2[key].float().numpy(),
                                   np.asarray(jc2[key]).astype(np.float32),
                                   rtol=tol, atol=tol, err_msg=f"decode {key}")
    for what, got, want in (("forward", full, jfull), ("prefill", logits, jlogits),
                            ("decode_step", step, jstep)):
        assert got.dtype == torch.float32, what
        np.testing.assert_allclose(got.numpy(), np.asarray(want, np.float32),
                                   rtol=tol, atol=tol, err_msg=what)
    np.testing.assert_array_equal(pos2.numpy(), np.asarray(jpos2))


def test_prefill_decode_teacher_forcing():
    """Decode-step logits equal a full forward over S+1 tokens, also for a
    prompt shorter than the conv's K-1 (its buffer's leading slots stay
    zero, the causal conv's own padding)."""
    cfg = _port_cfg(torch.float32)
    params = mamba2.init_params(cfg, 1, device="cpu")
    for s in (2, 12):
        tokens = torch.from_numpy(_tokens(cfg.vocab, 2, s + 2, seed=s))
        with torch.inference_mode():
            logits, caches, pos = mamba2.prefill(cfg, params, tokens=tokens[:, :s])
            for i in range(2):
                want = mamba2.forward(cfg, params, tokens=tokens[:, :s + i])[:, -1]
                torch.testing.assert_close(logits, want, rtol=1e-4, atol=1e-4)
                logits, caches, pos = mamba2.decode_step(cfg, params, tokens[:, s + i],
                                                         caches, pos)
        assert pos.tolist() == [s + 2, s + 2]


@pytest.fixture(scope="module")
def engines(ssb_small):
    port_wl = ssb.build(n_fact=4000, seed=0)
    jcfg, jparams = _jax_params(vocab=4096)
    jtok, tok = jbuild_tokenizer([ssb_small]), build_tokenizer([port_wl])
    cfg = _port_cfg(torch.float32, vocab=4096)
    params = params_from_jax(cfg, _tree(jparams), device="cpu")
    return (jengine.ServingEngine(jcfg, jparams, jtok, max_len=128),
            engine.ServingEngine(cfg, params, tok, max_len=128, device="cpu"), port_wl)


@pytest.mark.parametrize("constrained,max_new", [(False, 16), (True, 24)])
def test_generate_matches_jax(engines, constrained, max_new):
    jeng, eng, wl = engines
    texts = list(dict.fromkeys(q.text for q in wl.queries() if q.kind == "nl"))[:3]
    prompts = [f"question: {t}\nsignature: " for t in texts]
    want = jeng.generate(prompts, max_new_tokens=max_new, constrained=constrained)
    got = eng.generate(prompts, max_new_tokens=max_new, constrained=constrained)
    for g, w in zip(got, want):
        assert g["tokens"] == [int(t) for t in w["tokens"]]
        assert g["text"] == w["text"]
        assert g["logprob"] == pytest.approx(w["logprob"], abs=1e-4)
    assert eng.steps > 0


def test_llm_canonicalizer_serves_nl_through_the_pipeline():
    wl = ssb.build(n_fact=2000, seed=0)
    nl = serve.llm_canonicalizer(wl, arch=NAME, reduced=True, device="cpu")
    eng = nl.inner.engine
    assert eng.cfg.kind == "ssm" and eng.mod is mamba2
    assert eng.cfg.vocab == build_tokenizer([wl]).vocab_size  # widened head
    svc = CacheService()
    tenant = serve.build_tenant(svc, wl, device="cpu", nl=nl)
    texts = list(dict.fromkeys(q.text for q in wl.queries() if q.kind == "nl"))[:4]
    reset_launch_counts()
    results = svc.submit_batch([QueryRequest(nl=t, tenant=serve.TENANT) for t in texts])
    assert launch_counts()["ssd_scan"] == 0  # the CPU path
    # the service turns an engine exception into a result: none may be one
    assert tenant.stats.failures == tenant.stats.degraded == 0
    assert all(r.error is None for r in results)
    assert len(results) == 4 and all(r.origin == "nl" for r in results)
    assert nl.calls == 4 and eng.steps > 0
    assert {t for t, _ in nl._memo} == set(texts)
    for r in nl._memo.values():
        assert (r.signature is None) == (r.error is not None)  # the protocol


def test_serve_main_with_mamba2_on_cpu(capsys):
    """``--arch mamba2-780m`` runs through the launcher (the reduced config,
    plain path)."""
    serve.main(["--n-fact", "2000", "--queries", "25", "--device", "cpu",
                "--arch", NAME, "--reduced"])
    out = capsys.readouterr().out
    assert '"requests": 225' in out and '"nl_requests": 4' in out
