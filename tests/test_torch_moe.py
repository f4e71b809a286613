"""The port's MoE family against the JAX package's, on the CPU.

* ``moe_ffn`` alone against ``repro.models.moe.moe_ffn`` in float32 at
  rtol = atol = 1e-5, on the MoE layer of reduced kimi-k2 (one shared
  expert), of reduced qwen3-moe, of qwen3-moe widened to 32 experts and
  top-4 (16 expert shards, as at full size), with a capacity factor of
  0.25 that drops routes (the dropped (expert, token) set is non-empty
  and JAX's), and with all-zero rows, whose router logits all tie (they
  route to experts 0..k-1, ``jax.lax.top_k``'s order);
* the whole model (``forward``, ``loss_fn``, ``prefill`` and two
  ``decode_step`` s) of both reduced MoE configs from converted weights:
  float32 1e-4 at S = 32, bfloat16 5e-2 at S = 8 (the frameworks round
  bfloat16 at different places, ``tests/test_torch_model.py``);
* the serving engine's greedy tokens at float32 equal the JAX engine's,
  and ``launch.serve --reduced --arch kimi-k2-1t-a32b`` serves on the CPU.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import reduced as jreduced
from repro.models import moe as jmoe
from repro.serving import engine as jengine
from repro.training.tokenizer import build_tokenizer as jbuild_tokenizer
from repro_torch.configs.registry import get, reduced
from repro_torch.launch import serve
from repro_torch.models import moe, transformer
from repro_torch.models.convert import params_from_jax
from repro_torch.models.model import cut_depth
from repro_torch.serving import engine
from repro_torch.training.tokenizer import build_tokenizer
from repro_torch.workloads import ssb

MOE = ["kimi-k2-1t-a32b", "qwen3-moe-235b-a22b"]
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
# moe_ffn cases: (config, overrides of both packages' reduced config)
FFN_CASES = {
    "kimi": ("kimi-k2-1t-a32b", {}),
    "qwen3": ("qwen3-moe-235b-a22b", {}),
    "wide": ("qwen3-moe-235b-a22b", {"n_experts": 32, "top_k": 4}),
    "drop": ("qwen3-moe-235b-a22b", {"capacity_factor": 0.25}),
    "ties": ("kimi-k2-1t-a32b", {}),
}


def _configs(name, jd=jnp.float32, td=torch.float32, **kw):
    return (dataclasses.replace(jreduced(name), dtype=jd, **kw),
            dataclasses.replace(reduced(name), dtype=td, **kw))


def _jax_params(jcfg, key=0):
    return jcfg.build().init_params(jcfg, jax.random.PRNGKey(key))


def _tree(p):
    return jax.tree.map(np.asarray, p)


def _x(cfg, b, s, seed, zero_rows=()):
    x = np.random.default_rng(seed).normal(size=(b, s, cfg.d_model)).astype(np.float32)
    for r in zero_rows:
        x[r // s, r % s] = 0.0
    return x


def _jax_kept(jcfg, jp, x):
    """JAX's routing, step by step as ``repro/models/moe.py`` writes it:
    the top-k ids and the set of (expert, token) routes kept."""
    xt = jnp.asarray(x).reshape(-1, jcfg.d_model)
    t = xt.shape[0]
    e_shards, e_local = jp["moe_w1"].shape[:2]
    cap = min(t, max(8, int(t * jcfg.top_k / jcfg.n_experts * jcfg.capacity_factor)))
    logits = xt.astype(jnp.float32) @ jp["router"].astype(jnp.float32)
    _, ids = jax.lax.top_k(logits, jcfg.top_k)
    kept = set()
    for j in range(e_local):
        expert_ids = jnp.arange(e_shards) * e_local + j
        hit = (ids[None, :, :] == expert_ids[:, None, None]).any(axis=-1)
        prio = jnp.where(hit, jnp.arange(t)[None, :], t)
        sel = jnp.take_along_axis(prio, jax.lax.top_k(-prio, cap)[1], axis=1)
        kept |= {(sh * e_local + j, int(tok)) for sh in range(e_shards)
                 for tok in np.asarray(sel[sh]) if tok < t}
    return np.asarray(ids), kept


@pytest.mark.parametrize("case", list(FFN_CASES))
def test_moe_ffn_matches_jax(case):
    name, kw = FFN_CASES[case]
    jcfg, tcfg = _configs(name, **kw)
    jlp = {k: v[0] for k, v in _jax_params(jcfg)["layers"].items()}
    tlp = params_from_jax(tcfg, {"layers": _tree({k: v[None] for k, v in jlp.items()})},
                          device="cpu")["layers"][0]
    assert tlp["router"].dtype == torch.float32
    assert tlp["moe_w1"].shape == (moe.expert_shards(tcfg),
                                   tcfg.n_experts // moe.expert_shards(tcfg),
                                   tcfg.d_model, tcfg.d_ff)
    b, s = 2, 16
    zero_rows = (0, 5, 6, 17, 31) if case == "ties" else ()
    x = _x(tcfg, b, s, seed=len(case), zero_rows=zero_rows)
    want = np.asarray(jmoe.moe_ffn(jlp, jnp.asarray(x), jcfg))
    with moe.count_dropped() as dropped:
        got = moe.moe_ffn(tlp, torch.from_numpy(x), tcfg)
    assert got.dtype == torch.float32 and got.shape == x.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)

    jids, jkept = _jax_kept(jcfg, jlp, x)
    _, ids, slots, _ = moe.route(tlp, torch.from_numpy(x).reshape(b * s, -1), tcfg)
    np.testing.assert_array_equal(ids.numpy(), jids)
    e_local = slots.shape[1]
    kept = {(sh * e_local + j, int(tok)) for sh in range(slots.shape[0])
            for j in range(e_local) for tok in slots[sh, j].tolist() if tok < b * s}
    assert kept == jkept
    routes = {(int(e), tok) for tok in range(b * s) for e in jids[tok]}
    assert len(routes) == b * s * tcfg.top_k
    assert int(sum(dropped)) == len(routes - kept)
    if case == "drop":
        assert routes - kept  # capacity 0.25 drops routes
    if case == "ties":
        for r in zero_rows:  # every logit 0: experts 0..k-1, lower index first
            assert ids[r].tolist() == list(range(tcfg.top_k))
            assert not got.reshape(b * s, -1)[r].any()


def test_capacity_is_jax_s():
    cfg = get("qwen3-moe-235b-a22b")
    for t in (1, 8, 64, 616, 4096):
        assert moe.capacity(cfg, t) == min(t, max(8, int(t * 8 / 128 * 1.25)))
    assert moe.capacity(cfg, 616) == 48 and moe.expert_shards(cfg) == 16
    assert moe.expert_shards(reduced("qwen3-moe-235b-a22b")) == 1


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("name", MOE)
def test_moe_model_matches_jax(name, dtype):
    jd, td = DTYPES[dtype]
    b, s, tol = (2, 32, 1e-4) if dtype == "float32" else (2, 8, 5e-2)
    jcfg, tcfg = _configs(name, jd, td)
    jp = _jax_params(jcfg)  # JAX's own init: the router stays float32
    assert jp["layers"]["router"].dtype == jnp.float32
    mod = jcfg.build()
    tp = params_from_jax(tcfg, _tree(jp), device="cpu")
    assert sorted(tp) == sorted(jp)
    assert transformer.param_shapes(tcfg) == {
        k: ([{n: tuple(t.shape) for n, t in lp.items()} for lp in v] if isinstance(v, list)
            else tuple(v.shape)) for k, v in tp.items()}
    rng = np.random.default_rng(3)
    tokens = rng.integers(0, jcfg.vocab, size=(b, s)).astype(np.int32)
    labels = rng.integers(0, jcfg.vocab, size=(b, s)).astype(np.int32)
    labels[0, :3] = -1
    nxt = [tokens[:, -1], tokens[:, 0]]

    @jax.jit
    def run(p, tokens, labels):
        full = mod.forward(jcfg, p, tokens=tokens)
        loss = mod.loss_fn(jcfg, p, {"tokens": tokens, "labels": labels})
        logits, caches, pos = mod.prefill(jcfg, p, tokens=tokens, cache_len=s + 8)
        step1, caches, pos = mod.decode_step(jcfg, p, nxt[0], caches, pos)
        step2, caches, pos = mod.decode_step(jcfg, p, nxt[1], caches, pos)
        return full, loss, logits, step1, step2, pos, caches

    j = run(jp, jnp.asarray(tokens), jnp.asarray(labels))
    with torch.inference_mode():
        full = transformer.forward(tcfg, tp, tokens=torch.from_numpy(tokens))
        loss = transformer.loss_fn(tcfg, tp, {"tokens": tokens, "labels": labels})
        logits, caches, pos = transformer.prefill(tcfg, tp, tokens=torch.from_numpy(tokens),
                                                  cache_len=s + 8)
        assert sorted(caches) == sorted(j[6])
        step1, caches, pos = transformer.decode_step(tcfg, tp, torch.from_numpy(nxt[0]),
                                                     caches, pos)
        step2, caches2, pos = transformer.decode_step(tcfg, tp, torch.from_numpy(nxt[1]),
                                                      caches, pos)
    assert caches2 is caches
    for what, got, want in (("forward", full, j[0]), ("loss", loss, j[1]),
                            ("prefill", logits, j[2]), ("decode 1", step1, j[3]),
                            ("decode 2", step2, j[4])):
        assert got.dtype == torch.float32, what
        np.testing.assert_allclose(got.numpy(), np.asarray(want, np.float32),
                                   rtol=tol, atol=tol, err_msg=what)
    for stack, (k, v) in caches.items():
        for got, want in ((k, j[6][stack][0]), (v, j[6][stack][1])):
            assert got.dtype == td
            np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                                       rtol=tol, atol=tol, err_msg=stack)
    np.testing.assert_array_equal(pos.numpy(), np.asarray(j[5]))


@pytest.mark.parametrize("name", MOE)
def test_moe_teacher_forcing(name):
    """With drop-free routing (capacity truncation differs between a
    one-token decode and a full forward, as in JAX), each decode step's
    logits equal a forward over the tokens so far."""
    cfg = dataclasses.replace(reduced(name), dtype=torch.float32, capacity_factor=64.0)
    params = transformer.init_params(cfg, 1, device="cpu")
    assert params["layers"][0]["router"].dtype == torch.float32
    tokens = torch.randint(0, cfg.vocab, (2, 14), generator=torch.Generator().manual_seed(1))
    with torch.inference_mode():
        logits, caches, pos = transformer.prefill(cfg, params, tokens=tokens[:, :12],
                                                  cache_len=16)
        for i in range(2):
            want = transformer.forward(cfg, params, tokens=tokens[:, :12 + i])[:, -1]
            torch.testing.assert_close(logits, want, rtol=1e-4, atol=1e-4)
            logits, caches, pos = transformer.decode_step(cfg, params, tokens[:, 12 + i],
                                                          caches, pos)


@pytest.mark.parametrize("depth", [1, 2])
def test_cut_depth_runs_the_leading_dense_layers_first(depth):
    """kimi-k2's first layers cut from a 3-layer model (1 dense, 2 MoE):
    the cut runs as a model built at that depth with the same weights."""
    cfg = dataclasses.replace(reduced("kimi-k2-1t-a32b"), dtype=torch.float32, n_layers=3)
    params = transformer.init_params(cfg, 0, device="cpu")
    c, p = cut_depth(cfg, params, depth)
    assert (c.n_layers, c.dense_layers, len(p["dense_layers"]), len(p["layers"])) == \
        (depth, 1, 1, depth - 1)
    assert transformer.param_shapes(c) == {
        k: ([{n: tuple(t.shape) for n, t in lp.items()} for lp in v] if isinstance(v, list)
            else tuple(v.shape)) for k, v in p.items()}
    tokens = torch.randint(0, cfg.vocab, (2, 9), generator=torch.Generator().manual_seed(2))
    c = dataclasses.replace(c, capacity_factor=64.0)
    with torch.inference_mode():
        want = transformer.forward(c, p, tokens=tokens)
        logits, caches, pos = transformer.prefill(c, p, tokens=tokens[:, :8], cache_len=9)
        assert sorted(caches) == (["dense_layers", "layers"] if depth > 1 else ["dense_layers"])
        step = transformer.decode_step(c, p, tokens[:, 8], caches, pos)[0]
    torch.testing.assert_close(logits, want[:, 7], rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(step, want[:, 8], rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def engines(ssb_small):
    name = "kimi-k2-1t-a32b"
    jcfg, tcfg = _configs(name, vocab=4096)
    jparams = _jax_params(jcfg)
    port_wl = ssb.build(n_fact=4000, seed=0)
    return (jengine.ServingEngine(jcfg, jparams, jbuild_tokenizer([ssb_small]), max_len=128),
            engine.ServingEngine(tcfg, params_from_jax(tcfg, _tree(jparams), device="cpu"),
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
    assert eng.steps > 0 and eng.mod is transformer


def test_serve_main_with_kimi_k2_on_cpu(capsys):
    """``--arch kimi-k2-1t-a32b --reduced`` runs through the launcher on the
    CPU: its NL requests go through the MoE engine."""
    serve.main(["--n-fact", "2000", "--queries", "25", "--device", "cpu",
                "--arch", "kimi-k2-1t-a32b", "--reduced"])
    out = capsys.readouterr().out
    assert '"requests": 225' in out and '"nl_requests": 4' in out
    assert '"failures": 0' in out and '"degraded": 0' in out
