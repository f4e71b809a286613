"""The port's training on the CPU against the JAX package's: the loop
(loss per step and final parameters from the same converted init on the
same ``BatchIterator`` batches, at microbatches 1 and 2 and with int8
gradient compression), AdamW and compression on stacked leaves, Mamba2's
loss and gradients, checkpoints in both directions, resume after a
restart, and the train and serve launchers.  The MoE and Zamba2 trees:
``tests/test_torch_training_families.py``.

The JAX side runs on the ``xla`` kernel impl (the CPU default): ``jax.grad``
cannot pass the Pallas flash kernel, so the JAX package trains by
differentiating ``mha_ref``, whose gradient the port's CPU path computes
too.  The port's init differs from JAX's (per-layer vectors start at zero),
so both start from ``params_from_jax`` of JAX's init.

Tolerances: losses rtol 1e-5 (float32; sums taken in another order);
parameters after 5 steps at lr 1e-2 atol 1e-3 (an element whose gradient
is near AdamW's eps moves by up to lr either way on a last-bit difference;
the largest seen is 1.8e-4); with compression, an element whose scaled
gradient sits on a rounding boundary of the int8 grid can take the other
step, so all elements within 1e-2 (lr) and 99.9% within 1e-4.

"""
import dataclasses
import hashlib
import json
import os

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs.registry import reduced as jreduced
from repro.training import checkpoint as jckpt
from repro.training.data import BatchIterator as JBatchIterator
from repro.training.data import build_pairs as jbuild_pairs
from repro.training.optimizer import AdamWConfig as JAdamWConfig
from repro.training.optimizer import adamw_update as jadamw_update
from repro.training.optimizer import compress_grads as jcompress_grads
from repro.training.optimizer import init_opt_state as jinit_opt_state
from repro.training.tokenizer import build_tokenizer as jbuild_tokenizer
from repro.training.train_lib import TrainConfig as JTrainConfig
from repro.training.train_lib import train as jtrain
from repro_torch.configs.registry import reduced
from repro_torch.launch import serve
from repro_torch.launch import train as train_launcher
from repro_torch.models import mamba2, transformer
from repro_torch.models.convert import params_from_jax, params_to_jax, stack_layers
from repro_torch.training import checkpoint as ckpt
from repro_torch.training.data import BatchIterator, build_pairs
from repro_torch.training.optimizer import (AdamWConfig, adamw_update, compress_grads,
                                            decompress_grads, init_opt_state)
from repro_torch.training.tokenizer import build_tokenizer
from repro_torch.training.train_lib import TrainConfig, restore_train_state, train
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
def setup(ssb_small):
    """The reduced dense config at vocab 4096 in f32 (as
    tests/test_training_distributed.py), the port's and JAX's pairs and
    tokenizer over the same SSB build, and JAX's init."""
    jcfg = dataclasses.replace(jreduced("canonicalizer-100m"), vocab=4096, dtype=jnp.float32)
    cfg = dataclasses.replace(reduced("canonicalizer-100m"), vocab=4096, dtype=F32)
    wl = ssb.build(n_fact=4000, seed=0)
    tok, pairs = build_tokenizer([wl]), build_pairs([wl], paraphrases_per_intent=6)
    jtok, jpairs = jbuild_tokenizer([ssb_small]), jbuild_pairs([ssb_small],
                                                               paraphrases_per_intent=6)
    init = jcfg.build().init_params(jcfg, jax.random.PRNGKey(0))
    return {"jcfg": jcfg, "cfg": cfg, "tok": tok, "pairs": pairs, "jtok": jtok,
            "jpairs": jpairs, "init": init}


def test_batches_match_the_reference(setup):
    ours = BatchIterator(setup["pairs"], setup["tok"], batch=4, seq_len=64)
    ref = JBatchIterator(setup["jpairs"], setup["jtok"], batch=4, seq_len=64)
    assert setup["tok"].vocab == setup["jtok"].vocab
    for step in (0, 1, 17):
        a, b = ours.batch_at(step), ref.batch_at(step)
        assert all(np.array_equal(a[k], b[k]) for k in ("tokens", "labels"))


@pytest.mark.parametrize("microbatches,compression", [(1, False), (2, False), (1, True)])
def test_train_matches_jax(setup, microbatches, compression):
    jcfg, cfg = setup["jcfg"], setup["cfg"]
    batches = BatchIterator(setup["pairs"], setup["tok"], batch=4, seq_len=64)
    kw = dict(steps=5, log_every=1, microbatches=microbatches, grad_compression=compression)
    jout = jtrain(jcfg, JTrainConfig(**kw, opt=JAdamWConfig(lr=1e-2, warmup_steps=2)),
                  batches, params=setup["init"], log=lambda s: None)
    out = train(cfg, TrainConfig(**kw, opt=AdamWConfig(lr=1e-2, warmup_steps=2)), batches,
                params=params_from_jax(cfg, _np(setup["init"]), device="cpu"),
                log=lambda s: None)
    np.testing.assert_allclose([h["loss"] for h in out["history"]],
                               [h["loss"] for h in jout["history"]], rtol=1e-5)
    assert out["opt_state"]["step"] == int(jout["opt_state"]["step"]) == 5
    want = _jax_named(jout["params"])
    got = _port_named(params_to_jax(cfg, out["params"]))
    assert set(got) == set(want)
    for name, w in want.items():
        diff = np.abs(got[name] - w)
        if compression:
            assert diff.max() <= 1e-2 and np.mean(diff <= 1e-4) >= 0.999, name
        else:
            assert diff.max() <= 1e-3, name


def _two_layer_tree(rng):
    """A 2-layer tree in the JAX layout whose layers' gradients differ in
    magnitude (layer 1's ten times layer 0's)."""
    p = {"embed": rng.normal(size=(16, 8)), "final_norm": rng.normal(size=(8,)),
         "layers": {"ln1": rng.normal(size=(2, 8)), "wq": rng.normal(size=(2, 8, 8))}}
    g = jax.tree.map(lambda a: rng.normal(size=a.shape), p)
    g["layers"] = {k: v * np.array([1.0, 10.0]).reshape((2,) + (1,) * (v.ndim - 1))
                   for k, v in g["layers"].items()}
    f32 = lambda t: jax.tree.map(lambda a: np.asarray(a, np.float32), t)  # noqa: E731
    return f32(p), f32(g)


def _port_tree(tree):
    """JAX layout -> the port's: one dict per layer."""
    out = {k: torch.from_numpy(np.array(v)) for k, v in tree.items() if k != "layers"}
    n = len(next(iter(tree["layers"].values())))
    out["layers"] = [{k: torch.from_numpy(np.array(v[i])) for k, v in tree["layers"].items()}
                     for i in range(n)]
    return out


def test_adamw_decays_and_compression_scales_by_stacked_leaf():
    """The reference's stacked rules, per layer tensor in the port: weight
    decay on ``ln1`` ((L, D) stacked) and every matrix, not on
    ``final_norm``; one int8 scale per stacked leaf, the max over layers."""
    p, g = _two_layer_tree(np.random.default_rng(0))
    cfg = AdamWConfig(lr=0.1, warmup_steps=1, weight_decay=0.5, clip_norm=1e9)
    jcfg = JAdamWConfig(lr=0.1, warmup_steps=1, weight_decay=0.5, clip_norm=1e9)
    jp, jo, jn = jadamw_update(jcfg, p, g, jinit_opt_state(p))
    tp, to, tn = adamw_update(cfg, _port_tree(p), _port_tree(g), init_opt_state(_port_tree(p)))
    np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
    got, want = _port_named(stack_layers(tp)), _jax_named(jp)
    for name in want:
        np.testing.assert_allclose(got[name], want[name], rtol=1e-6, atol=1e-7, err_msg=name)
    # without decay the step is lr * sign(g) at step 1 (|m hat| = sqrt(v hat))
    no_decay = p["final_norm"] - 0.1 * np.sign(g["final_norm"])
    np.testing.assert_allclose(got["final_norm"], no_decay, rtol=1e-6)
    decayed = p["layers"]["ln1"] - 0.1 * (np.sign(g["layers"]["ln1"]) + 0.5 * p["layers"]["ln1"])
    np.testing.assert_allclose(got["layers/ln1"], decayed, rtol=1e-5, atol=1e-6)

    jq, jscales, jres = jcompress_grads(g)
    q, scales, res = compress_grads(_port_tree(g))
    for name, want_scale in _jax_named(jscales).items():
        assert float(scales[name]) == pytest.approx(float(want_scale), rel=1e-7), name
    assert float(scales["layers/wq"]) == pytest.approx(
        float(np.abs(g["layers"]["wq"]).max()) / 127.0, rel=1e-7)
    # layer 0 shares layer 1's scale: its grid is a tenth used
    assert int(q["layers"][1]["wq"].abs().max()) == 127
    assert int(q["layers"][0]["wq"].abs().max()) < 127 // 2
    assert _port_named(stack_layers(q)).keys() == _jax_named(jq).keys()
    for name, want_q in _jax_named(jq).items():
        np.testing.assert_array_equal(_port_named(stack_layers(q))[name], want_q)
    deq = _port_named(stack_layers(decompress_grads(q, scales)))
    for name, r in _port_named(stack_layers(res)).items():
        np.testing.assert_allclose(r, _jax_named(jres)[name], rtol=1e-5, atol=1e-7)
        np.testing.assert_allclose(deq[name] + r, _jax_named(g)[name], rtol=1e-6, atol=1e-6)


def test_mamba2_loss_and_grads_match_jax(setup, monkeypatch):
    """Mamba2's masked cross-entropy and its gradients at reduced
    mamba2-780m in f32, the port on the CPU (plain SSD scan) against
    ``jax.value_and_grad`` of the JAX loss: loss rtol 1e-5, gradients rtol
    1e-3, atol 5e-5 (the port scans in chunks, JAX step by step: the f32
    sums differ in order; 5 of the embedding's 262,144 entries lie past
    rtol 1e-4, by at most 2.3e-5).  The JAX side scans with the sequential ``ssd_ref``:
    the gradient of its chunked scan (``ssd_chunked_xla``, the ``xla``
    impl) is NaN, since exp of the unmasked upper triangle overflows
    before ``where`` masks it, and 0 * inf reaches the backward."""
    import repro.models.mamba2 as jmamba2
    from repro.kernels.ssd_scan.ref import ssd_ref

    jcfg = dataclasses.replace(jreduced("mamba2-780m"), vocab=4096, dtype=jnp.float32)
    cfg = dataclasses.replace(reduced("mamba2-780m"), vocab=4096, dtype=F32)
    init = jcfg.build().init_params(jcfg, jax.random.PRNGKey(1))
    batch = BatchIterator(setup["pairs"], setup["tok"], batch=3, seq_len=96).batch_at(0)
    assert (batch["labels"] >= 0).sum() > 20

    def jgrads():
        return jax.value_and_grad(
            lambda p: jcfg.build().loss_fn(jcfg, p, jax.tree.map(jnp.asarray, batch)))(init)

    assert np.isnan(np.asarray(jgrads()[1]["embed"])).any()  # the chunked scan's NaN
    monkeypatch.setattr(jmamba2, "ssd_scan",
                        lambda x, dt, A, Bm, Cm, chunk=128: ssd_ref(x, dt, A, Bm, Cm)[0])
    jloss, jg = jgrads()
    params = params_from_jax(cfg, _np(init), device="cpu")
    leaves = {k: ([{n: t.requires_grad_() for n, t in lp.items()} for lp in v]
                  if k == "layers" else v.requires_grad_()) for k, v in params.items()}
    loss = mamba2.loss_fn(cfg, leaves, batch)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    grads = _port_named(stack_layers({k: ([{n: t.grad for n, t in lp.items()} for lp in v]
                                          if k == "layers" else v.grad)
                                      for k, v in leaves.items()}))
    for name, w in _jax_named(jg).items():
        assert np.isfinite(w).all(), name
        np.testing.assert_allclose(grads[name], w, rtol=1e-3, atol=5e-5, err_msg=name)


def test_transformer_loss_matches_jax_and_ignores_unlabelled_positions(setup):
    jcfg, cfg = setup["jcfg"], setup["cfg"]
    batch = BatchIterator(setup["pairs"], setup["tok"], batch=2, seq_len=64).batch_at(3)
    want = float(jcfg.build().loss_fn(jcfg, setup["init"], jax.tree.map(jnp.asarray, batch)))
    params = params_from_jax(cfg, _np(setup["init"]), device="cpu")
    assert float(transformer.loss_fn(cfg, params, batch)) == pytest.approx(want, rel=1e-5)
    changed = {**batch, "tokens": batch["tokens"].copy()}
    last = (batch["labels"][0] >= 0).nonzero()[0].max() + 1
    changed["tokens"][0, last + 1:] = 7  # past the last labelled position
    assert float(transformer.loss_fn(cfg, params, changed)) == pytest.approx(want, rel=1e-6)


# ------------------------------------------------------------- checkpoints


def _mixed_tree(rng):
    """numpy leaves of f32, int32 and bf16 (as ml_dtypes, the JAX package's)."""
    return {"a": rng.normal(size=(3, 4)).astype(np.float32),
            "b": {"c": rng.normal(size=(2, 5)).astype(ml_dtypes.bfloat16),
                  "step": np.asarray(7, np.int32)}}


def _files(path) -> dict:
    return {f: hashlib.md5(open(os.path.join(path, f), "rb").read()).hexdigest()
            for f in os.listdir(path)}


def test_checkpoint_written_by_jax_restores_in_the_port_bit_for_bit(tmp_path):
    tree = _mixed_tree(np.random.default_rng(0))
    jckpt.save_checkpoint(str(tmp_path), 3, tree, extra={"note": "x"})
    got, step, extra = ckpt.restore_latest(str(tmp_path), tree)
    assert step == 3 and extra == {"note": "x"}
    assert got["b"]["c"].dtype == torch.bfloat16 and got["b"]["c"].shape == (2, 5)
    assert np.array_equal(got["b"]["c"].view(torch.int16).numpy(),
                          tree["b"]["c"].view(np.int16))
    assert np.array_equal(got["a"].numpy(), tree["a"])
    assert got["b"]["step"].dtype == torch.int32 and int(got["b"]["step"]) == 7


def test_checkpoint_written_by_the_port_restores_in_jax_bit_for_bit(tmp_path):
    tree = _mixed_tree(np.random.default_rng(1))
    port_tree = {"a": torch.from_numpy(tree["a"]),
                 "b": {"c": torch.from_numpy(tree["b"]["c"].view(np.int16)).view(torch.bfloat16),
                       "step": tree["b"]["step"]}}
    ckpt.save_checkpoint(str(tmp_path / "port"), 3, port_tree, extra={"note": "y"})
    jckpt.save_checkpoint(str(tmp_path / "jax"), 3, tree, extra={"note": "y"})
    # the same files, byte for byte, and the same manifest
    assert _files(tmp_path / "port" / "step_00000003") == _files(tmp_path / "jax" / "step_00000003")
    got, step, extra = jckpt.restore_latest(str(tmp_path / "port"), tree)
    assert step == 3 and extra == {"note": "y"}
    assert got["b"]["c"].dtype == ml_dtypes.bfloat16
    assert np.array_equal(got["b"]["c"].view(np.int16), tree["b"]["c"].view(np.int16))
    assert np.array_equal(got["a"], tree["a"])


def _tree():
    return {"a": torch.arange(12.0).reshape(3, 4), "b": {"c": torch.ones(5)}}


def test_checkpoint_roundtrip(tmp_path):
    tree = _tree()
    ckpt.save_checkpoint(str(tmp_path), 7, tree, extra={"note": "x"})
    restored, step, extra = ckpt.restore_latest(str(tmp_path), tree)
    assert step == 7 and extra == {"note": "x"}
    assert torch.equal(restored["a"], tree["a"]) and torch.equal(restored["b"]["c"], tree["b"]["c"])


def test_checkpoint_corrupt_latest_falls_back(tmp_path):
    tree = _tree()
    ckpt.save_checkpoint(str(tmp_path), 1, tree)
    ckpt.save_checkpoint(str(tmp_path), 2, tree)
    newest = os.path.join(str(tmp_path), "step_00000002")
    victim = next(f for f in os.listdir(newest) if f.endswith(".npy"))
    with open(os.path.join(newest, victim), "wb") as f:
        f.write(b"garbage")
    _, step, _ = ckpt.restore_latest(str(tmp_path), tree)
    assert step == 1


def test_checkpoint_tmp_dir_never_restored(tmp_path):
    tree = _tree()
    ckpt.save_checkpoint(str(tmp_path), 3, tree)
    os.makedirs(os.path.join(str(tmp_path), "step_00000009.tmp"))
    _, step, _ = ckpt.restore_latest(str(tmp_path), tree)
    assert step == 3


def test_checkpoint_prune(tmp_path):
    tree = _tree()
    for s in range(5):
        ckpt.save_checkpoint(str(tmp_path), s, tree)
    ckpt.prune_old(str(tmp_path), keep=2)
    assert sorted(os.listdir(str(tmp_path))) == ["step_00000003", "step_00000004"]


def test_checkpoint_async_save_snapshots_and_subtree_restore(tmp_path):
    """An async save writes the values at the call (a later in-place change
    does not reach the file); ``subtree`` restores the ``p`` leaves of a
    {"p", "o"} checkpoint, and a shape that differs is passed over."""
    tree = {"p": _tree(), "o": {"step": np.asarray(1, np.int32)}}
    ckpt.save_checkpoint(str(tmp_path), 0, tree, async_save=True)
    tree["p"]["a"].add_(100.0)
    ckpt.wait_pending()
    got, step, _ = ckpt.restore_latest(str(tmp_path), _tree(), subtree="p")
    assert step == 0 and torch.equal(got["a"], _tree()["a"])
    assert ckpt.restore_latest(str(tmp_path), _tree())[1] == -1  # names differ
    wide = {"a": torch.zeros(3, 5), "b": {"c": torch.ones(5)}}
    assert ckpt.restore_latest(str(tmp_path), wide, subtree="p")[1] == -1


def test_resume_after_restart_restores_the_saved_state(setup, tmp_path):
    cfg = dataclasses.replace(setup["cfg"], dtype=torch.bfloat16)
    batches = BatchIterator(setup["pairs"], setup["tok"], batch=2, seq_len=64)
    ck = str(tmp_path / "ck")
    first = train(cfg, TrainConfig(steps=10, ckpt_dir=ck, ckpt_every=5, log_every=100),
                  batches, device="cpu", log=lambda s: None)
    params, opt, step, _ = restore_train_state(
        cfg, ck, first["params"], init_opt_state(first["params"]))
    assert step == 9 and opt["step"] == 10
    for a, b in zip(ckpt.flatten_with_paths(params_to_jax(cfg, params)),
                    ckpt.flatten_with_paths(params_to_jax(cfg, first["params"]))):
        assert a[0] == b[0] and a[1].dtype == torch.bfloat16 and torch.equal(a[1], b[1])
    for a, b in zip(ckpt.flatten_with_paths(stack_layers(opt["v"])),
                    ckpt.flatten_with_paths(stack_layers(first["opt_state"]["v"]))):
        assert torch.equal(a[1], b[1])
    msgs, seen = [], []

    class Recording(BatchIterator):
        def batch_at(self, s):
            seen.append(s)
            return super().batch_at(s)

    again = train(cfg, TrainConfig(steps=12, ckpt_dir=ck, ckpt_every=5, log_every=100),
                  Recording(setup["pairs"], setup["tok"], batch=2, seq_len=64),
                  device="cpu", log=msgs.append)
    assert any("resumed from step 9" in m for m in msgs)
    assert seen == [10, 11] and again["start_step"] == 10
    assert sorted(os.listdir(ck))[-1] == "step_00000011"


def test_checkpoint_of_the_port_resumes_the_jax_loop_and_back(setup, tmp_path):
    """A port training checkpoint ({"p", "o"} in the JAX layout) resumes
    ``repro``'s ``train``, and a JAX one resumes the port's."""
    jcfg, cfg = setup["jcfg"], setup["cfg"]
    batches = BatchIterator(setup["pairs"], setup["tok"], batch=2, seq_len=64)
    ck = str(tmp_path / "ck")
    train(cfg, TrainConfig(steps=3, ckpt_dir=ck, ckpt_every=3), batches,
          params=params_from_jax(cfg, _np(setup["init"]), device="cpu"), log=lambda s: None)
    msgs = []
    jtrain(jcfg, JTrainConfig(steps=5, ckpt_dir=ck, ckpt_every=5), batches,
           params=setup["init"], log=msgs.append)
    assert any("resumed from step 2" in m for m in msgs)
    msgs = []
    train(cfg, TrainConfig(steps=6, ckpt_dir=ck, ckpt_every=5), batches,
          params=params_from_jax(cfg, _np(setup["init"]), device="cpu"), log=msgs.append)
    assert any("resumed from step 4" in m for m in msgs)


# --------------------------------------------------------------- launchers


def test_train_launcher_then_serve_launcher_restores_the_checkpoint(tmp_path, capsys):
    ck = str(tmp_path / "ck")
    out = train_launcher.main(["--reduced", "--steps", "2", "--device", "cpu",
                               "--batch", "2", "--seq-len", "64", "--ckpt-dir", ck])
    assert len(out["history"]) == 2
    manifest = json.load(open(os.path.join(ck, "step_00000001", "manifest.json")))
    assert manifest["extra"] == {"arch": "canonicalizer-100m", "reduced": True,
                                 "tokenizer_workloads": ["ssb", "nyc_tlc", "tpcds"]}
    capsys.readouterr()
    serve.main(["--reduced", "--device", "cpu", "--ckpt-dir", ck, "--n-fact", "3000",
                "--queries", "4"])
    text = capsys.readouterr().out
    assert "[serve] restored canonicalizer from step 1" in text
    summary = json.loads(text.strip().splitlines()[-1])
    assert summary["failures"] == summary["degraded"] == 0
    capsys.readouterr()
    res = train_launcher.main(["--dryrun-mesh", "single"])
    assert res["status"] == "ok" and res["shape"] == "train_4k"
    assert res["mesh_shape"] == {"data": 16, "model": 16}
    assert "'status': 'ok'" in capsys.readouterr().out


def test_serve_restores_the_reference_training_checkpoint(ssb_small, tmp_path, capsys):
    """A checkpoint that ``repro``'s ``train`` writes ({"p", "o"} leaves)
    restores in the port's serve launcher; ``repro``'s own launcher asks
    for {"p"} alone and gets step -1 (ROADMAP.md Queue 3)."""
    tok = jbuild_tokenizer([ssb_small])
    jcfg = dataclasses.replace(jreduced("canonicalizer-100m"), vocab=tok.vocab_size)
    batches = JBatchIterator(jbuild_pairs([ssb_small], paraphrases_per_intent=2), tok,
                             batch=2, seq_len=48)
    ck = str(tmp_path / "ck")
    out = jtrain(jcfg, JTrainConfig(steps=2, ckpt_dir=ck, ckpt_every=2), batches,
                 key=jax.random.PRNGKey(0), log=lambda s: None)
    assert jckpt.restore_latest(ck, {"p": out["params"]})[1] == -1
    assert jckpt.restore_latest(ck, {"p": out["params"], "o": out["opt_state"]})[1] == 1
    capsys.readouterr()
    serve.main(["--reduced", "--device", "cpu", "--ckpt-dir", ck, "--n-fact", "3000",
                "--queries", "4"])
    assert "[serve] restored canonicalizer from step 1" in capsys.readouterr().out
    cfg = dataclasses.replace(reduced("canonicalizer-100m"), vocab=tok.vocab_size)
    params, step, _ = serve.restore_params(cfg, ck, device="cpu")
    assert step == 1
    for name, w in _jax_named(out["params"]).items():
        got = _port_named(params_to_jax(cfg, params))[name]
        assert np.array_equal(got, np.asarray(w, np.float32)), name


def test_served_model_builds_the_tokenizer_the_checkpoint_names(ssb_small, tmp_path):
    """``serve.served_model`` (the serve launcher's restore path) builds the
    tokenizer over the workloads a checkpoint's ``extra`` names, widens the
    head to it and restores the checkpoint's parameters; without a
    checkpoint, over the served workload alone."""
    names = ["ssb", "nyc_tlc", "tpcds"]
    tok = build_tokenizer([ssb_small] + [serve.WORKLOADS[n].build(n_fact=1000)
                                         for n in names[1:]])
    base = reduced("canonicalizer-100m")
    cfg = dataclasses.replace(base, vocab=tok.vocab_size)
    batches = BatchIterator(build_pairs([ssb_small], paraphrases_per_intent=2), tok,
                            batch=2, seq_len=48)
    ck = str(tmp_path / "ck")
    out = train(cfg, TrainConfig(steps=1, ckpt_dir=ck, ckpt_every=1), batches,
                device="cpu", log=lambda s: None, extra={"tokenizer_workloads": names})
    got_cfg, params, got_tok, step = serve.served_model(base, ssb_small, ck, device="cpu")
    assert step == 0 and got_cfg == cfg and got_tok.vocab == tok.vocab
    assert torch.equal(params["embed"], out["params"]["embed"])
    own = build_tokenizer([ssb_small])
    got_cfg, params, got_tok, step = serve.served_model(base, ssb_small, device="cpu")
    assert (params, step) == (None, -1) and got_tok.vocab == own.vocab
    assert got_cfg.vocab == max(base.vocab, own.vocab_size)

