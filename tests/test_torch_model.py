"""The port's model configs and dense transformer against the JAX package's.

* the registry: every config, reduced config and list field by field
  (``dtype`` mapped from jnp to torch);
* ``params_from_jax``: the JAX init converted leaf by leaf, exactly;
* ``forward`` / ``prefill`` / ``decode_step`` logits of every dense config
  at its ``reduced()`` size (embeddings in place of tokens where the config
  says so), from the same converted weights and inputs, both on the CPU
  (the plain attention path).  float32: rtol = atol = 1e-4.  bfloat16:
  5e-2, at S = 8: the two frameworks round bfloat16 at different places
  (XLA keeps float32 inside fused elementwise chains, PyTorch rounds after
  each op), and at S = 32 that rounding alone moves either side's logits
  as far as 5e-2 from the float32 result;
* the MoE and hybrid families are not ported and say so (the SSM family
  is held to JAX in ``tests/test_torch_mamba2.py``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro_torch.configs import registry as treg
from repro_torch.models import transformer as tt
from repro_torch.models.convert import params_from_jax

DENSE = [n for n, c in jreg.CONFIGS.items() if c.kind == "dense"]
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _fields(cfg):
    d = dataclasses.asdict(cfg)
    dt = d.pop("dtype")
    d["dtype"] = (str(dt).removeprefix("torch.") if isinstance(dt, torch.dtype)
                  else jnp.dtype(dt).name)
    return d


def test_registry_matches_jax():
    assert list(treg.CONFIGS) == list(jreg.CONFIGS)
    assert treg.ASSIGNED == jreg.ASSIGNED and treg.SUBQUADRATIC == jreg.SUBQUADRATIC
    for name in jreg.CONFIGS:
        for get in ("get", "reduced"):
            j, t = getattr(jreg, get)(name), getattr(treg, get)(name)
            assert _fields(t) == _fields(j), (get, name)
            assert t.hd == j.hd
    assert treg.get("canonicalizer-100m").dtype is torch.bfloat16


def _jax_params(name, dtype=jnp.float32, key=0, **overrides):
    cfg = dataclasses.replace(jreg.reduced(name), dtype=dtype, **overrides)
    return cfg, cfg.build().init_params(cfg, jax.random.PRNGKey(key))


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_params_from_jax_round_trip(dtype):
    jd, td = DTYPES[dtype]
    jcfg, jp = _jax_params("qwen3-32b", jd)
    tcfg = dataclasses.replace(treg.reduced("qwen3-32b"), dtype=td)
    tp = params_from_jax(tcfg, jax.tree.map(np.asarray, jp), device="cpu")
    assert sorted(tp) == sorted(jp) and len(tp["layers"]) == jcfg.n_layers
    assert jax.tree.map(lambda a: a.shape, jp) == {
        k: ({n: (len(v),) + tuple(v[0][n].shape) for n in v[0]} if k == "layers"
            else tuple(v.shape)) for k, v in tp.items()}
    for k, v in jp.items():
        if k == "layers":
            for n, stacked in v.items():
                got = torch.stack([lp[n] for lp in tp["layers"]])
                assert got.dtype == td
                np.testing.assert_array_equal(got.float().numpy(),
                                              np.asarray(stacked, np.float32))
        else:
            assert tp[k].dtype == td
            np.testing.assert_array_equal(tp[k].float().numpy(), np.asarray(v, np.float32))
    assert tt.param_shapes(tcfg) == {
        k: ([{n: tuple(t.shape) for n, t in lp.items()} for lp in v] if k == "layers"
            else tuple(v.shape)) for k, v in tp.items()}


def test_init_params_follows_the_jax_rule(monkeypatch):
    cfg = dataclasses.replace(treg.reduced("canonicalizer-100m"), d_model=256, d_ff=512)
    p = tt.init_params(cfg, 3, device="cpu")
    assert all(t.dtype == torch.bfloat16 for t in (p["embed"], p["layers"][0]["wq"]))
    for name in ("ln1", "ln2", "q_norm", "k_norm"):
        assert not p["layers"][1][name].any()  # vectors start at 0: scale by 1
    assert not p["final_norm"].any()
    for w in (p["layers"][0]["mlp_w2"], p["lm_head"], p["embed"]):
        std = float(w.float().std())
        assert abs(std * w.shape[0] ** 0.5 - 1.0) < 0.05  # std = fan_in ** -0.5
    again = tt.init_params(cfg, torch.Generator().manual_seed(3), device="cpu")
    assert torch.equal(again["layers"][1]["wk"], p["layers"][1]["wk"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tt.init_params(cfg, 0)


def _inputs(cfg, b, s, seed=0):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab, size=(b, s)).astype(np.int32)
    emb = rng.normal(size=(b, s, cfg.d_model)).astype(np.float32) if cfg.embed_inputs else None
    return tokens, emb


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("name", DENSE)
def test_dense_logits_match_jax(name, dtype):
    _logits_match_jax(name, dtype)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_gemma_shape_at_head_dim_256_matches_jax(dtype):
    """``reduced("gemma-2b")`` (4 query heads over 1 KV head, geglu, tied
    embeddings, the gemma embedding scale) widened to gemma-2b's head dim
    of 256, which the attention kernels are now built for."""
    _logits_match_jax("gemma-2b", dtype, head_dim=256)


def _logits_match_jax(name, dtype, **overrides):
    """Converted weights: ``forward``, ``prefill`` and one ``decode_step``
    of ``reduced(name)`` (with ``overrides``) against the JAX model's."""
    jd, td = DTYPES[dtype]
    b, s, tol = (2, 32, 1e-4) if dtype == "float32" else (2, 8, 5e-2)
    jcfg0, jp32 = _jax_params(name, **overrides)
    jcfg = dataclasses.replace(jcfg0, dtype=jd)
    mod = jcfg.build()
    jp = jax.tree.map(lambda a: a.astype(jd), jp32)
    tcfg = dataclasses.replace(treg.reduced(name), dtype=td, **overrides)
    tp = params_from_jax(tcfg, jax.tree.map(np.asarray, jp32), device="cpu")
    tokens, emb = _inputs(jcfg, b, s)
    nxt = tokens[:, -1]

    @jax.jit
    def run(p, tokens, emb):
        kw = {"embeddings": emb.astype(jd)} if emb is not None else {"tokens": tokens}
        full = mod.forward(jcfg, p, **kw)
        logits, caches, pos = mod.prefill(jcfg, p, cache_len=s + 8, **kw)
        step, _, pos2 = mod.decode_step(jcfg, p, nxt, caches, pos)
        return full, logits, step, pos2

    j = [np.asarray(x, np.float32) for x in run(jp, jnp.asarray(tokens),
                                                 None if emb is None else jnp.asarray(emb))]
    kw = ({"embeddings": torch.from_numpy(emb).to(td)} if emb is not None
          else {"tokens": torch.from_numpy(tokens)})
    with torch.inference_mode():
        full = tt.forward(tcfg, tp, **kw)
        logits, caches, pos = tt.prefill(tcfg, tp, cache_len=s + 8, **kw)
        assert caches["layers"][0].shape == (tcfg.n_layers, b, tcfg.kv_heads, s + 8, tcfg.hd)
        step, caches2, pos2 = tt.decode_step(tcfg, tp, torch.from_numpy(nxt), caches, pos)
    assert caches2 is caches  # written in place
    for what, got, want in (("forward", full, j[0]), ("prefill", logits, j[1]),
                            ("decode_step", step, j[2])):
        assert got.dtype == torch.float32, what
        np.testing.assert_allclose(got.numpy(), want, rtol=tol, atol=tol, err_msg=what)
    np.testing.assert_array_equal(pos2.numpy(), j[3])


def test_decode_past_the_cache_drops_the_write_as_jax_does():
    """A decode position at or past the cache length is not written (JAX's
    scatter drops it) and attention then covers the whole cache."""
    name = "canonicalizer-100m"
    jcfg, jp = _jax_params(name)
    mod = jcfg.build()
    tcfg = dataclasses.replace(treg.reduced(name), dtype=torch.float32)
    tp = params_from_jax(tcfg, jax.tree.map(np.asarray, jp), device="cpu")
    tokens, _ = _inputs(jcfg, 2, 8)
    jl, jc, jpos = mod.prefill(jcfg, jp, tokens=jnp.asarray(tokens), cache_len=8)
    with torch.inference_mode():
        tl, tc, tpos = tt.prefill(tcfg, tp, tokens=torch.from_numpy(tokens), cache_len=8)
        before = tc["layers"][0].clone()
        for step in range(2):  # positions 8 and 9 of an 8-slot cache
            nxt = tokens[:, step]
            jl, jc, jpos = mod.decode_step(jcfg, jp, jnp.asarray(nxt), jc, jpos)
            tl, tc, tpos = tt.decode_step(tcfg, tp, torch.from_numpy(nxt), tc, tpos)
            np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4, atol=1e-4)
    assert torch.equal(tc["layers"][0], before)


@pytest.mark.parametrize("name", [n for n, c in jreg.CONFIGS.items()
                                  if c.kind in ("moe", "hybrid")])
def test_other_families_are_not_ported_yet(name):
    cfg = treg.reduced(name)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        cfg.build()
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        cfg.param_shapes()
