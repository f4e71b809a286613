"""Training of every family's tree on the CPU against the JAX package's:
reduced kimi-k2-1t-a32b (``dense_layers`` and ``layers``), qwen3-moe-235b-a22b
and zamba2-7b (a ``mamba`` stack and the unstacked ``shared_attn``).

* ``init_opt_state`` of every family, ``stacked_leaves`` in JAX's leaf
  order;
* the loss and gradients of each at step 0 (the port on its chunked scan,
  JAX on the sequential ``ssd_ref``: the gradient of its chunked scan is
  NaN);
* ``train`` against JAX's ``train`` at microbatches 1 and 2 and with int8
  compression, as ``test_torch_training.py::test_train_matches_jax`` holds
  the dense config: losses rtol 1e-5, parameters 1e-3, with compression
  all within 1e-2 and 99.9% within 1e-4;
* AdamW and compression by stacked leaf over every kind of subtree;
* a checkpoint of each family written by one package resumes the other;
* ``launch.train --arch <family> --reduced --device cpu``.

The loops run at lr 1e-3 for 3 steps, zamba2 on both packages'
sequential scans (``_sequential_scans``).  Step-0 losses and gradients
agree to 2e-5 relative, but random-init MoE and hybrid trajectories
separate through last-bit differences faster than the dense one: at lr
1e-2 a qwen3-moe expert weight whose step-0 gradient is ~1e-9, of
opposite signs in the two packages, moves 1.4e-3 apart, and zamba2's
losses lie 2e-5 apart by step 4 even with both packages on the sequential
scan; with compression at lr 1e-3 a flipped int8 rounding reaches the
router, and by step 5 qwen3-moe's loss lies 5.9e-4 apart.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import reduced as jreduced
from repro.training import checkpoint as jckpt
from repro.training.optimizer import AdamWConfig as JAdamWConfig
from repro.training.optimizer import adamw_update as jadamw_update
from repro.training.optimizer import compress_grads as jcompress_grads
from repro.training.optimizer import init_opt_state as jinit_opt_state
from repro.training.train_lib import TrainConfig as JTrainConfig
from repro.training.train_lib import train as jtrain
from repro_torch.configs.registry import reduced
from repro_torch.launch import train as train_launcher
from repro_torch.models import mamba2
from repro_torch.models.convert import (params_from_jax, params_to_jax, stack_layers,
                                        unstack_layers)
from repro_torch.models.model import STACKS
from repro_torch.training import checkpoint as ckpt
from repro_torch.training.data import BatchIterator, build_pairs
from repro_torch.training.optimizer import (AdamWConfig, adamw_update, compress_grads,
                                            decompress_grads, init_opt_state,
                                            stacked_leaves)
from repro_torch.training.tokenizer import build_tokenizer
from repro_torch.training.train_lib import (TrainConfig, loss_and_grads,
                                            restore_train_state, train)
from repro_torch.workloads import ssb

F32 = torch.float32


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _jax_named(tree) -> dict:
    return {"/".join(str(p.key) for p in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _port_named(tree) -> dict:
    return {name: t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()
            for name, t in ckpt.flatten_with_paths(tree)}


@pytest.fixture(scope="module")
def setup():
    """The port's SSB pairs and tokenizer (the batches both loops take)."""
    wl = ssb.build(n_fact=4000, seed=0)
    return {"tok": build_tokenizer([wl]), "pairs": build_pairs([wl], paraphrases_per_intent=6)}


FAMILIES = ("kimi-k2-1t-a32b", "qwen3-moe-235b-a22b", "zamba2-7b")
FAMILY_LR, FAMILY_STEPS = 1e-3, 3


def _family(name):
    """JAX's and the port's reduced ``name`` at vocab 4096 in f32, and
    JAX's init (seed 0)."""
    jcfg = dataclasses.replace(jreduced(name), vocab=4096, dtype=jnp.float32)
    cfg = dataclasses.replace(reduced(name), vocab=4096, dtype=F32)
    return jcfg, cfg, jcfg.build().init_params(jcfg, jax.random.PRNGKey(0))


def _jax_sequential_scan(monkeypatch):
    """JAX's Mamba2 blocks scan with the sequential ``ssd_ref``: the
    gradient of its chunked ``ssd_chunked_xla`` is NaN
    (``test_mamba2_loss_and_grads_match_jax``)."""
    import repro.models.mamba2 as jmamba2
    from repro.kernels.ssd_scan.ref import ssd_ref as jssd_ref

    monkeypatch.setattr(jmamba2, "ssd_scan",
                        lambda x, dt, A, Bm, Cm, chunk=128: jssd_ref(x, dt, A, Bm, Cm)[0])


def _sequential_scans(monkeypatch):
    """Both packages' Mamba2 blocks scan with their sequential ``ssd_ref``,
    so that two loops compare the same f32 arithmetic."""
    from repro_torch.kernels.ssd_scan.ref import ssd_ref

    def scan(x, dt, A, Bm, Cm, chunk=128, return_state=False):
        y, state = ssd_ref(x, dt, A, Bm, Cm)
        return (y, state) if return_state else y

    _jax_sequential_scan(monkeypatch)
    monkeypatch.setattr(mamba2, "ssd_scan", scan)


@pytest.mark.parametrize("name", ("canonicalizer-100m", "mamba2-780m") + FAMILIES)
def test_init_opt_state_takes_every_family(name):
    """Zero f32 moments shaped as every leaf of every family's tree, and
    ``stacked_leaves`` in JAX's leaf order (sorted keys, then names)."""
    cfg = dataclasses.replace(reduced(name), dtype=F32)
    params = cfg.build().init_params(cfg, 0, device="cpu")
    state = init_opt_state(params)
    assert state["step"] == 0
    for key in ("m", "v"):
        got = ckpt.flatten_with_paths(stack_layers(state[key]))
        want = ckpt.flatten_with_paths(stack_layers(params))
        assert [n for n, _ in got] == [n for n, _ in want]
        for (_, m), (_, p) in zip(got, want):
            assert m.shape == p.shape and m.dtype == F32 and not m.any()
    jcfg = dataclasses.replace(jreduced(name), dtype=jnp.float32)
    jnames = list(_jax_named(jax.eval_shape(lambda: jcfg.build().init_params(
        jcfg, jax.random.PRNGKey(0)))))
    assert [n for n, _ in stacked_leaves(params)] == jnames


@pytest.mark.parametrize("name", FAMILIES)
def test_loss_and_grads_match_jax_for_every_family(setup, monkeypatch, name):
    """``loss_and_grads`` of the reduced MoE and Zamba2 configs in f32 (the
    port on its chunked scan) against ``jax.value_and_grad`` of the JAX
    loss (JAX on ``ssd_ref``): loss rtol 1e-5, every leaf's gradient rtol
    1e-3, atol 5e-5 (as Mamba2's), finite."""
    _jax_sequential_scan(monkeypatch)
    jcfg, cfg, init = _family(name)
    batch = BatchIterator(setup["pairs"], setup["tok"], batch=4, seq_len=64).batch_at(0)
    jloss, jg = jax.jit(jax.value_and_grad(
        lambda p: jcfg.build().loss_fn(jcfg, p, jax.tree.map(jnp.asarray, batch))))(init)
    loss, grads = loss_and_grads(cfg, params_from_jax(cfg, _np(init), device="cpu"), batch)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    got = _port_named(stack_layers(grads))
    want = _jax_named(jg)
    assert set(got) == set(want)
    for leaf, w in want.items():
        assert np.isfinite(got[leaf]).all(), leaf
        np.testing.assert_allclose(got[leaf], w, rtol=1e-3, atol=5e-5, err_msg=leaf)


@pytest.mark.parametrize("name", FAMILIES)
@pytest.mark.parametrize("microbatches,compression", [(1, False), (2, False), (1, True)])
def test_train_matches_jax_for_every_family(setup, monkeypatch, name, microbatches,
                                            compression):
    """The loop over every leaf of kimi-k2's, qwen3-moe's and zamba2's trees
    (their stacks and ``shared_attn``), as ``test_train_matches_jax`` holds
    the dense one, at ``FAMILY_LR`` for ``FAMILY_STEPS`` steps (the module
    docstring says why)."""
    _sequential_scans(monkeypatch)
    jcfg, cfg, init = _family(name)
    batches = BatchIterator(setup["pairs"], setup["tok"], batch=4, seq_len=64)
    kw = dict(steps=FAMILY_STEPS, log_every=1, microbatches=microbatches,
              grad_compression=compression)
    jout = jtrain(jcfg, JTrainConfig(**kw, opt=JAdamWConfig(lr=FAMILY_LR, warmup_steps=2)),
                  batches, params=init, log=lambda s: None)
    out = train(cfg, TrainConfig(**kw, opt=AdamWConfig(lr=FAMILY_LR, warmup_steps=2)),
                batches, params=params_from_jax(cfg, _np(init), device="cpu"),
                log=lambda s: None)
    np.testing.assert_allclose([h["loss"] for h in out["history"]],
                               [h["loss"] for h in jout["history"]], rtol=1e-5)
    assert out["opt_state"]["step"] == int(jout["opt_state"]["step"]) == FAMILY_STEPS
    want = _jax_named(jout["params"])
    got = _port_named(params_to_jax(cfg, out["params"]))
    assert set(got) == set(want)
    for leaf, w in want.items():
        diff = np.abs(got[leaf] - w)
        if compression:
            assert diff.max() <= 1e-2 and np.mean(diff <= 1e-4) >= 0.999, leaf
        else:
            assert diff.max() <= 1e-3, leaf


def _stacks_tree(rng):
    """A tree in the JAX layout with every kind of subtree: an MoE's
    ``dense_layers`` (1 layer) and ``layers`` (2), a ``mamba`` stack (3),
    Zamba2's unstacked ``shared_attn`` and top-level leaves; each stack's
    last layer's gradients ten times its first's."""
    p = {"embed": rng.normal(size=(16, 8)), "final_norm": rng.normal(size=(8,)),
         "dense_layers": {"ln1": rng.normal(size=(1, 8)), "wq": rng.normal(size=(1, 8, 8))},
         "layers": {"ln1": rng.normal(size=(2, 8)), "moe_w1": rng.normal(size=(2, 1, 2, 8, 4))},
         "mamba": {"dt_bias": rng.normal(size=(3, 4)), "wx": rng.normal(size=(3, 8, 8))},
         "shared_attn": {"ln1": rng.normal(size=(8,)), "wq": rng.normal(size=(8, 8))}}
    g = jax.tree.map(lambda a: rng.normal(size=a.shape), p)
    for k in STACKS:
        n = len(next(iter(g[k].values())))
        ramp = np.linspace(1.0, 10.0, n) if n > 1 else np.ones(1)
        g[k] = {name: v * ramp.reshape((n,) + (1,) * (v.ndim - 1)) for name, v in g[k].items()}
    f32 = lambda t: jax.tree.map(lambda a: np.asarray(a, np.float32), t)  # noqa: E731
    return f32(p), f32(g)


def test_adamw_decays_and_compresses_by_stacked_leaf_over_every_stack():
    """AdamW and int8 compression over a tree with ``dense_layers``,
    ``layers``, ``mamba`` and ``shared_attn``: the JAX package's results
    on the stacked tree.  Decay on every per-layer vector of any stack
    (``dense_layers/ln1``, ``layers/ln1``, ``mamba/dt_bias``: 2-D stacked)
    and every matrix, not on ``final_norm`` nor ``shared_attn/ln1``; one
    int8 scale per stacked leaf, the max over its layers."""
    p, g = _stacks_tree(np.random.default_rng(1))
    cfg = AdamWConfig(lr=0.1, warmup_steps=1, weight_decay=0.5, clip_norm=1e9)
    jcfg = JAdamWConfig(lr=0.1, warmup_steps=1, weight_decay=0.5, clip_norm=1e9)
    jp, jo, jn = jadamw_update(jcfg, p, g, jinit_opt_state(p))
    tp, to, tn = adamw_update(cfg, unstack_layers(p, "cpu"), unstack_layers(g, "cpu"),
                              init_opt_state(unstack_layers(p, "cpu")))
    np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
    got, want = _port_named(stack_layers(tp)), _jax_named(jp)
    assert got.keys() == want.keys()
    for name in want:
        np.testing.assert_allclose(got[name], want[name], rtol=1e-6, atol=1e-7, err_msg=name)
    for name, m in _port_named(stack_layers(to["m"])).items():
        np.testing.assert_allclose(m, _jax_named(jo["m"])[name], rtol=1e-6, err_msg=name)
    # without decay the step is lr * sign(g) at step 1; with it, lr (sign(g) + 0.5 p)
    for name in ("final_norm", "shared_attn/ln1"):
        np.testing.assert_allclose(got[name], _jax_named(p)[name]
                                   - 0.1 * np.sign(_jax_named(g)[name]), rtol=1e-6)
    for name in ("dense_layers/ln1", "layers/ln1", "mamba/dt_bias", "shared_attn/wq"):
        pv, gv = _jax_named(p)[name], _jax_named(g)[name]
        np.testing.assert_allclose(got[name], pv - 0.1 * (np.sign(gv) + 0.5 * pv),
                                   rtol=1e-5, atol=1e-6, err_msg=name)

    jq, jscales, jres = jcompress_grads(g)
    q, scales, res = compress_grads(unstack_layers(g, "cpu"))
    assert scales.keys() == _jax_named(jscales).keys()
    for name, want_scale in _jax_named(jscales).items():
        assert float(scales[name]) == pytest.approx(float(want_scale), rel=1e-7), name
        assert float(want_scale) == pytest.approx(
            float(np.abs(_jax_named(g)[name]).max()) / 127.0, rel=1e-7), name
    for name, want_q in _jax_named(jq).items():
        np.testing.assert_array_equal(_port_named(stack_layers(q))[name], want_q)
    # a stack's first layer shares its last layer's scale: a tenth of the grid
    assert int(q["mamba"][2]["wx"].abs().max()) == 127
    assert int(q["mamba"][0]["wx"].abs().max()) < 127 // 2
    deq = _port_named(stack_layers(decompress_grads(q, scales)))
    for name, r in _port_named(stack_layers(res)).items():
        np.testing.assert_allclose(r, _jax_named(jres)[name], rtol=1e-5, atol=1e-7)
        np.testing.assert_allclose(deq[name] + r, _jax_named(g)[name], rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("name", FAMILIES)
def test_checkpoint_of_every_family_crosses_the_packages(setup, monkeypatch, tmp_path, name):
    """For kimi-k2, qwen3-moe and zamba2: a port checkpoint ({"p", "o"} in
    the JAX layout, every stack stacked) restores in JAX bit for bit and
    resumes ``repro``'s ``train``; the checkpoint JAX then writes restores
    in the port bit for bit and resumes the port's ``train``."""
    _jax_sequential_scan(monkeypatch)
    jcfg, cfg, init = _family(name)
    batches = BatchIterator(setup["pairs"], setup["tok"], batch=2, seq_len=32)
    ck = str(tmp_path / "ck")
    port = train(cfg, TrainConfig(steps=2, ckpt_dir=ck, ckpt_every=2), batches,
                 params=params_from_jax(cfg, _np(init), device="cpu"), log=lambda s: None)
    jstate = {"p": init, "o": jinit_opt_state(init)}
    restored, step, _ = jckpt.restore_latest(ck, jstate)
    assert step == 1 and int(restored["o"]["step"]) == 2
    for part, tree in (("p", params_to_jax(cfg, port["params"])),
                       ("o", stack_layers(port["opt_state"]["m"]))):
        want = _port_named(tree)
        got = _jax_named(restored[part] if part == "p" else restored["o"]["m"])
        assert got.keys() == want.keys()
        for leaf, w in want.items():
            assert np.array_equal(got[leaf], w), (part, leaf)
    msgs = []
    jout = jtrain(jcfg, JTrainConfig(steps=4, ckpt_dir=ck, ckpt_every=4), batches,
                  params=init, log=msgs.append)
    assert any("resumed from step 1" in m for m in msgs)
    params, opt, step, _ = restore_train_state(cfg, ck, port["params"], port["opt_state"])
    assert step == 3 and opt["step"] == 4
    for got, want in ((params_to_jax(cfg, params), jout["params"]),
                      (stack_layers(opt["v"]), jout["opt_state"]["v"])):
        got, want = _port_named(got), _jax_named(want)
        assert got.keys() == want.keys()
        for leaf, w in want.items():
            assert np.array_equal(got[leaf], w), leaf
    msgs = []
    train(cfg, TrainConfig(steps=5, ckpt_dir=ck, ckpt_every=5), batches,
          params=params_from_jax(cfg, _np(init), device="cpu"), log=msgs.append)
    assert any("resumed from step 3" in m for m in msgs)


@pytest.mark.parametrize("name", FAMILIES)
def test_train_launcher_trains_every_family_on_the_cpu(name, capsys):
    """``launch.train --arch <family> --reduced --steps 2 --device cpu``."""
    out = train_launcher.main(["--arch", name, "--reduced", "--steps", "2", "--device", "cpu"])
    losses = [h["loss"] for h in out["history"]]
    assert len(losses) == 2 and np.isfinite(losses).all()
    assert out["opt_state"]["step"] == 2
    assert "[train] done; final loss" in capsys.readouterr().out
