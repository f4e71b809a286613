"""The port's Zamba2 hybrid against the JAX package's, on the CPU (the SSD
scan and attention take their plain versions there).

* ``reduced("zamba2-7b")``: 5 Mamba2 layers, the shared attention + geglu
  MLP block after layers 2 and 4 (segments 2 + attn, 2 + attn, 1);
* ``params_from_jax``: the ``mamba`` stack one dict per layer with its
  float32 leaves, ``shared_attn`` one dict with no layer axis, exact;
* ``forward``, ``loss_fn``, ``prefill`` and ``decode_step`` logits and every
  cache from the same converted weights and tokens: float32 rtol = atol =
  1e-4 at S = 32; bfloat16 5e-2 at S = 8 (the frameworks round bfloat16 at
  different places, ``tests/test_torch_mamba2.py``) at one Mamba layer
  and the shared block after it (``BF16_CUT``): through the 5 layers and 2
  applications the random-init model amplifies bfloat16 rounding past
  5e-2 in both frameworks (each one's bf16 logits lie 0.09-0.34 from its
  own float32 logits of the same weights, seeds 0-3), and one layer with
  the block keeps both within 0.04-0.08;
* teacher forcing, ``make_cache`` against JAX's, the full-depth segment
  layout (81 layers: 13 applications, 3 trailing layers);
* the serving engine's greedy tokens at float32 equal the JAX engine's,
  ``launch.serve --reduced --arch zamba2-7b`` serves on the CPU, and the
  launcher restores a JAX checkpoint of zamba2 (and of kimi-k2's two
  stacks).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get as jget
from repro.configs.registry import reduced as jreduced
from repro.models import zamba2 as jzamba2
from repro.serving import engine as jengine
from repro.training.tokenizer import build_tokenizer as jbuild_tokenizer
from repro_torch.configs.registry import get, reduced
from repro_torch.kernels.binding import launch_counts, reset_launch_counts
from repro_torch.launch import serve
from repro_torch.models import mamba2, zamba2
from repro_torch.models.convert import params_from_jax, params_to_jax
from repro_torch.serving import engine
from repro_torch.training.tokenizer import build_tokenizer
from repro_torch.workloads import ssb

NAME = "zamba2-7b"
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
F32_LEAVES = ("dt_bias", "a_log", "d_skip")
# the bfloat16 parity's depth: one Mamba layer, then the shared block
BF16_CUT = {"n_layers": 1, "attn_every": 1}


def _jax_params(dtype=jnp.float32, key=0, **kw):
    cfg = dataclasses.replace(jreduced(NAME), dtype=dtype, **kw)
    return cfg, cfg.build().init_params(cfg, jax.random.PRNGKey(key))


def _port_cfg(dtype, **kw):
    return dataclasses.replace(reduced(NAME), dtype=dtype, **kw)


def _tree(p):
    return jax.tree.map(np.asarray, p)


def _tokens(vocab, b, s, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, size=(b, s)).astype(np.int32)


def test_segments_match_jax_at_reduced_and_full_depth():
    small, full = reduced(NAME), get(NAME)
    assert zamba2._segments(small) == [(0, 2, True), (2, 2, True), (4, 1, False)]
    segs = zamba2._segments(full)
    assert segs == jzamba2._segments(jget(NAME))
    assert sum(ln for _, ln, _ in segs) == 81 and sum(a for _, _, a in segs) == 13
    assert segs[-1] == (78, 3, False) and zamba2.attn_apps(full) == 13
    assert (full.hd, full.n_heads, full.kv_heads, full.ssm_heads, full.ssm_head_dim,
            full.ssm_state) == (112, 32, 32, 112, 64, 64)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_params_from_jax_keeps_the_layout(dtype):
    jd, td = DTYPES[dtype]
    jcfg, jp = _jax_params(jd)
    tcfg = _port_cfg(td)
    tp = params_from_jax(tcfg, _tree(jp), device="cpu")
    assert sorted(tp) == sorted(jp) == ["embed", "final_norm", "lm_head", "mamba",
                                         "shared_attn"]
    assert len(tp["mamba"]) == jcfg.n_layers
    assert zamba2.param_shapes(tcfg) == {
        k: ([{n: tuple(t.shape) for n, t in lp.items()} for lp in v] if isinstance(v, list)
            else {n: tuple(t.shape) for n, t in v.items()} if isinstance(v, dict)
            else tuple(v.shape)) for k, v in tp.items()}
    for n, stacked in jp["mamba"].items():
        got = torch.stack([lp[n] for lp in tp["mamba"]])
        assert got.dtype == (torch.float32 if n in F32_LEAVES else td), n
        np.testing.assert_array_equal(got.float().numpy(), np.asarray(stacked, np.float32))
    for n, a in jp["shared_attn"].items():
        assert tp["shared_attn"][n].dtype == td and tp["shared_attn"][n].shape == a.shape
        np.testing.assert_array_equal(tp["shared_attn"][n].float().numpy(),
                                      np.asarray(a, np.float32))


def test_init_params_applies_the_ssd_overrides():
    cfg = _port_cfg(torch.bfloat16)
    p = zamba2.init_params(cfg, 3, device="cpu")
    _, jp = _jax_params(jnp.bfloat16)
    for n in F32_LEAVES:
        for lp in p["mamba"]:
            assert lp[n].dtype == torch.float32
            np.testing.assert_allclose(lp[n].numpy(), np.asarray(jp["mamba"][n][0]), rtol=1e-6)
    assert p["shared_attn"]["wq"].dtype == torch.bfloat16
    assert not p["shared_attn"]["ln1"].any() and not p["mamba"][2]["ln1"].any()
    again = zamba2.init_params(cfg, torch.Generator().manual_seed(3), device="cpu")
    assert torch.equal(again["shared_attn"]["mlp_w1"], p["shared_attn"]["mlp_w1"])


def test_make_cache_matches_jax():
    jcfg = jreduced(NAME)
    want = jzamba2.make_cache(jcfg, 3, 24)
    got = zamba2.make_cache(_port_cfg(torch.bfloat16), 3, 24, "cpu")
    assert sorted(got) == sorted(want)
    for k in want:
        assert tuple(got[k].shape) == want[k].shape, k
        assert str(got[k].dtype).removeprefix("torch.") == jnp.dtype(want[k].dtype).name, k
        assert not got[k].any()


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_logits_and_caches_match_jax(dtype):
    jd, td = DTYPES[dtype]
    b, s, tol, cut = (2, 32, 1e-4, {}) if dtype == "float32" else (2, 8, 5e-2, BF16_CUT)
    jcfg, jp = _jax_params(jd, **cut)
    mod = jcfg.build()
    tcfg = _port_cfg(td, **cut)
    assert sum(a for _, _, a in zamba2._segments(tcfg)) >= 1
    tp = params_from_jax(tcfg, _tree(jp), device="cpu")
    tokens = _tokens(jcfg.vocab, b, s)
    labels = _tokens(jcfg.vocab, b, s, seed=1)
    labels[1, -4:] = -1
    nxt = tokens[:, -1]

    @jax.jit
    def run(p, tokens, labels):
        full = mod.forward(jcfg, p, tokens=tokens)
        loss = mod.loss_fn(jcfg, p, {"tokens": tokens, "labels": labels})
        logits, caches, pos = mod.prefill(jcfg, p, tokens=tokens, cache_len=s + 8)
        step, caches2, pos2 = mod.decode_step(jcfg, p, nxt, caches, pos)
        return full, loss, logits, step, pos2, caches, caches2

    jfull, jloss, jlogits, jstep, jpos2, jc, jc2 = run(jp, jnp.asarray(tokens),
                                                       jnp.asarray(labels))
    with torch.inference_mode():
        full = zamba2.forward(tcfg, tp, tokens=torch.from_numpy(tokens))
        loss = zamba2.loss_fn(tcfg, tp, {"tokens": tokens, "labels": labels})
        logits, caches, pos = zamba2.prefill(tcfg, tp, tokens=torch.from_numpy(tokens),
                                             cache_len=s + 8)
        assert sorted(caches) == sorted(jc)
        for key in jc:
            assert tuple(caches[key].shape) == jc[key].shape, key
            np.testing.assert_allclose(caches[key].float().numpy(),
                                       np.asarray(jc[key]).astype(np.float32),
                                       rtol=tol, atol=tol, err_msg=f"prefill {key}")
        held = {k: v for k, v in caches.items()}
        step, caches2, pos2 = zamba2.decode_step(tcfg, tp, torch.from_numpy(nxt), caches, pos)
    assert caches2 is caches and all(caches2[k] is v for k, v in held.items())
    for key in jc2:
        np.testing.assert_allclose(caches2[key].float().numpy(),
                                   np.asarray(jc2[key]).astype(np.float32),
                                   rtol=tol, atol=tol, err_msg=f"decode {key}")
    for what, got, want in (("forward", full, jfull), ("loss", loss, jloss),
                            ("prefill", logits, jlogits), ("decode_step", step, jstep)):
        assert got.dtype == torch.float32, what
        np.testing.assert_allclose(got.numpy(), np.asarray(want, np.float32),
                                   rtol=tol, atol=tol, err_msg=what)
    np.testing.assert_array_equal(pos2.numpy(), np.asarray(jpos2))


def test_prefill_decode_teacher_forcing():
    """Decode-step logits equal a full forward over S+1 tokens, also for a
    prompt shorter than the conv's K-1 (its buffer's leading slots stay
    zero, as in Mamba2)."""
    cfg = _port_cfg(torch.float32)
    params = zamba2.init_params(cfg, 1, device="cpu")
    for s in (2, 12):
        tokens = torch.from_numpy(_tokens(cfg.vocab, 2, s + 2, seed=s))
        with torch.inference_mode():
            logits, caches, pos = zamba2.prefill(cfg, params, tokens=tokens[:, :s],
                                                 cache_len=s + 4)
            for i in range(2):
                want = zamba2.forward(cfg, params, tokens=tokens[:, :s + i])[:, -1]
                torch.testing.assert_close(logits, want, rtol=1e-4, atol=1e-4)
                logits, caches, pos = zamba2.decode_step(cfg, params, tokens[:, s + i],
                                                         caches, pos)
        assert pos.tolist() == [s + 2, s + 2]


def test_prefill_runs_each_layer_once_and_the_shared_block_per_application(monkeypatch):
    """One SSD scan per Mamba layer (its final state from the same call)
    and one attention per application of the shared block."""
    cfg = _port_cfg(torch.float32)
    params = zamba2.init_params(cfg, 0, device="cpu")
    calls = {"ssd": 0, "attn": 0}
    ssd, attn = mamba2.ssd_scan, zamba2.attention

    def count(key, fn):
        def wrapped(*a, **kw):
            calls[key] += 1
            return fn(*a, **kw)
        return wrapped

    monkeypatch.setattr(mamba2, "ssd_scan", count("ssd", ssd))
    monkeypatch.setattr(zamba2, "attention", count("attn", attn))
    reset_launch_counts()
    with torch.inference_mode():
        _, caches, pos = zamba2.prefill(cfg, params, tokens=torch.zeros((2, 6), dtype=torch.long))
        assert calls == {"ssd": 5, "attn": 2}
        zamba2.decode_step(cfg, params, torch.zeros(2, dtype=torch.long), caches, pos)
    assert calls == {"ssd": 5, "attn": 4}
    assert sum(launch_counts().values()) == 0  # the CPU path


@pytest.mark.parametrize("name", [NAME, "kimi-k2-1t-a32b"])
def test_serve_restores_a_jax_checkpoint_of_the_new_families(name, tmp_path):
    """The serve launcher's restore (``restore_latest(..., subtree="p")``)
    names Zamba2's ``mamba`` stack and unstacked ``shared_attn``, and an
    MoE's ``dense_layers`` beside ``layers``: a ``{"p": params}``
    checkpoint written by the JAX package restores bit for bit."""
    from repro.training import checkpoint as jckpt

    jcfg = dataclasses.replace(jreduced(name), dtype=jnp.bfloat16)
    jp = jcfg.build().init_params(jcfg, jax.random.PRNGKey(4))
    jckpt.save_checkpoint(str(tmp_path), 3, {"p": jp})
    jckpt.wait_pending()
    params, step, _ = serve.restore_params(reduced(name), str(tmp_path), device="cpu")
    assert step == 3
    for (path, want), got in zip(jax.tree_util.tree_leaves_with_path(jp),
                                 jax.tree.leaves(params_to_jax(reduced(name), params))):
        np.testing.assert_array_equal(got.float().numpy(), np.asarray(want, np.float32),
                                      err_msg=str(path))


@pytest.fixture(scope="module")
def engines(ssb_small):
    port_wl = ssb.build(n_fact=4000, seed=0)
    jcfg, jparams = _jax_params(vocab=4096)
    cfg = _port_cfg(torch.float32, vocab=4096)
    return (jengine.ServingEngine(jcfg, jparams, jbuild_tokenizer([ssb_small]), max_len=128),
            engine.ServingEngine(cfg, params_from_jax(cfg, _tree(jparams), device="cpu"),
                                 build_tokenizer([port_wl]), max_len=128, device="cpu"),
            port_wl)


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
    assert eng.steps > 0 and eng.mod is zamba2


def test_serve_main_with_zamba2_on_cpu(capsys):
    """``--arch zamba2-7b --reduced`` runs through the launcher on the CPU."""
    serve.main(["--n-fact", "2000", "--queries", "25", "--device", "cpu",
                "--arch", NAME, "--reduced"])
    out = capsys.readouterr().out
    assert '"requests": 225' in out and '"nl_requests": 4' in out
    assert '"failures": 0' in out and '"degraded": 0' in out
