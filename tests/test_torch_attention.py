"""The port's attention on the CPU against the JAX package's: the plain
versions (``ops`` takes them for CPU tensors) against the jnp oracles
(``mha_ref``, ``decode_attention_ref``) and the Pallas kernels in interpret
mode, over the shape sweeps of ``tests/test_kernels.py``.

Tolerances are those of ``tests/test_kernels.py``: float32 2e-3 (blockwise
online softmax against one softmax), bfloat16 5e-2.  Against the jnp
oracle, whose arithmetic the port repeats, float32 agrees to 1e-5.  The
sweeps cover every head dim the CUDA kernels are built for (16, 32, 64,
112, 128, 192 and 256).

The CUDA kernels' own arithmetic, rehearsed in plain PyTorch
(``flash_tiled_ref``: 64-key tiles, bf16 products in f32, the scale after
the product, p split into bf16 hi + lo; ``decode_tiled_ref``: the same
tile steps for the newest token's row, the bf16 decode instance;
``decode_chunked_ref``: partials per chunk of cache slots and their
combine, the f32 decode instance), is held to the plain versions
and to the Pallas kernels run on the inputs' exact float32 values, at the
tolerances the kernels meet on the card (``ATTN_TOL``, as in
``tests/test_torch_cuda.py``): float32 2e-3; bfloat16 rtol 4e-3 (one
output rounding, at most 2**-9 relative), atol 5e-4.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_attn.kernel import decode_attention_pallas
from repro.kernels.decode_attn.ref import decode_attention_ref as jdecode_ref
from repro.kernels.flash_attn.kernel import flash_attention_pallas
from repro.kernels.flash_attn.ref import mha_ref as jmha_ref
from repro_torch.kernels.binding import launch_counts, reset_launch_counts
from repro_torch.kernels import build
from repro_torch.kernels.decode_attn import kernel as dkernel
from repro_torch.kernels.decode_attn import ref as dref
from repro_torch.kernels.decode_attn.ops import decode_attention
from repro_torch.kernels.flash_attn import kernel as fkernel
from repro_torch.kernels.flash_attn import ref as fref
from repro_torch.kernels.flash_attn.ops import flash_attention

T = torch.from_numpy
ATTN_TOL = {torch.float32: (2e-3, 2e-3), torch.bfloat16: (4e-3, 5e-4)}  # (rtol, atol)


# the head dims the registry uses past 32, 64 and 128 (ATTN_HEAD_DIMS): every
# reduced config's 16, kimi-k2's and zamba2's 112, nemotron-4-340b's 192 and
# gemma-2b's 256, at the Pallas kernels' tile edges
@pytest.mark.parametrize("b,h,hkv,s,dh", [
    (2, 4, 2, 256, 64), (1, 8, 1, 128, 32), (1, 4, 4, 100, 64), (2, 2, 2, 64, 128),
    (2, 4, 2, 65, 16), (1, 8, 2, 100, 112), (1, 6, 2, 64, 192), (1, 8, 1, 70, 256),
])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_matches_jax(b, h, hkv, s, dh, causal):
    rng = np.random.default_rng(b * 1000 + s + dh)
    q = rng.normal(size=(b, h, s, dh)).astype(np.float32)
    k = rng.normal(size=(b, hkv, s, dh)).astype(np.float32)
    v = rng.normal(size=(b, hkv, s, dh)).astype(np.float32)
    reset_launch_counts()
    got = flash_attention(T(q), T(k), T(v), causal=causal).numpy()
    assert launch_counts()["flash_attn"] == 0  # CPU tensors take the plain version
    want = np.asarray(jmha_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    pallas = np.asarray(flash_attention_pallas(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        tq=64, tk=64, interpret=True))
    np.testing.assert_allclose(got, pallas, rtol=2e-3, atol=2e-3)


def test_flash_attention_bf16_matches_jax():
    rng = np.random.default_rng(7)
    q, k, v = (rng.normal(size=shape).astype(np.float32)
               for shape in ((1, 4, 128, 64), (1, 2, 128, 64), (1, 2, 128, 64)))
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    tq, tk, tv = (T(a).to(torch.bfloat16) for a in (q, k, v))
    got = flash_attention(tq, tk, tv)
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    want = np.asarray(jmha_ref(jq, jk, jv)).astype(np.float32)
    pallas = np.asarray(flash_attention_pallas(jq, jk, jv, tq=64, tk=64,
                                               interpret=True)).astype(np.float32)
    np.testing.assert_allclose(got, want, rtol=5e-2, atol=5e-2)
    np.testing.assert_allclose(got, pallas, rtol=5e-2, atol=5e-2)


@pytest.mark.parametrize("b,h,hkv,s,dh,tk", [
    (2, 8, 2, 512, 64, 128), (1, 4, 1, 300, 128, 128), (3, 4, 4, 128, 32, 64),
    (2, 4, 2, 128, 16, 64), (1, 8, 1, 200, 112, 128), (2, 6, 2, 128, 192, 64),
    (1, 8, 1, 300, 256, 128),
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_attention_matches_jax(b, h, hkv, s, dh, tk, dtype):
    rng = np.random.default_rng(b * 1000 + s)
    q = rng.normal(size=(b, h, dh)).astype(np.float32)
    k = rng.normal(size=(b, hkv, s, dh)).astype(np.float32)
    v = rng.normal(size=(b, hkv, s, dh)).astype(np.float32)
    pos = rng.integers(1, s + 1, size=b).astype(np.int32)
    jd, td, tol = ((jnp.float32, torch.float32, 2e-3) if dtype == "float32"
                   else (jnp.bfloat16, torch.bfloat16, 5e-2))
    jin = [jnp.asarray(a, jd) for a in (q, k, v)] + [jnp.asarray(pos)]
    reset_launch_counts()
    got = decode_attention(*(T(a).to(td) for a in (q, k, v)), T(pos))
    assert launch_counts()["decode_attn"] == 0
    assert got.dtype == td
    got = got.float().numpy()
    # the plain version repeats the oracle's arithmetic, casts included
    np.testing.assert_allclose(got, np.asarray(jdecode_ref(*jin)).astype(np.float32),
                               rtol=1e-5 if dtype == "float32" else tol,
                               atol=1e-5 if dtype == "float32" else tol)
    pallas = np.asarray(decode_attention_pallas(*jin, tk=tk, interpret=True))
    np.testing.assert_allclose(got, pallas.astype(np.float32), rtol=tol, atol=tol)


def test_decode_attention_pos_mask_exact():
    """Cache slots at or past pos do not contribute at all."""
    rng = np.random.default_rng(3)
    b, h, s, dh = 1, 2, 64, 32
    q = T(rng.normal(size=(b, h, dh)).astype(np.float32))
    k = T(rng.normal(size=(b, h, s, dh)).astype(np.float32))
    v = T(rng.normal(size=(b, h, s, dh)).astype(np.float32))
    pos = torch.tensor([10], dtype=torch.int32)
    out1 = decode_attention(q, k, v, pos)
    k2, v2 = k.clone(), v.clone()
    k2[:, :, 10:] = 999.0
    v2[:, :, 10:] = -999.0
    torch.testing.assert_close(decode_attention(q, k2, v2, pos), out1,
                               rtol=1e-6, atol=1e-6)


def test_launch_registry_counts_snapshots_and_resets():
    """The one registry every kernel wrapper counts its launches in."""
    from repro_torch.kernels.binding import count_launch

    reset_launch_counts()
    count_launch("flash_attn")
    count_launch("flash_attn")
    snap = launch_counts()
    count_launch("decode_attn")
    assert snap["flash_attn"] == 2 and snap["decode_attn"] == 0  # a copy
    assert launch_counts()["decode_attn"] == 1 and launch_counts()["seg_agg"] == 0
    reset_launch_counts()
    assert not any(launch_counts().values())


def test_kernel_wrappers_refuse_cpu_tensors():
    """The CUDA wrappers launch or raise: a CPU tensor is refused, never
    computed by a fallback."""
    q = torch.zeros((1, 2, 8, 64))
    with pytest.raises(ValueError, match="CUDA tensors"):
        fkernel.flash_attention_cuda(q, q, q)
    with pytest.raises(ValueError, match="CUDA tensors"):
        dkernel.decode_attention_cuda(q[:, :, 0], q, q, torch.ones(1, dtype=torch.int32))
    with pytest.raises(ValueError, match="CUDA tensors"):
        fkernel.flash_attention_bwd_cuda(q, q, q, q, q)
    with pytest.raises(ValueError, match="tensors on"):
        flash_attention(q, q.to("meta"), q)


# ------------------------------------------- the kernels' arithmetic on the CPU


def _attn_close(got, want, dtype):
    rtol, atol = ATTN_TOL[dtype]
    np.testing.assert_allclose(np.asarray(got, dtype=np.float32),
                               np.asarray(want, dtype=np.float32), rtol=rtol, atol=atol)


def _inputs(seed, dtype, *shapes):
    """Standard-normal tensors of ``dtype`` made with numpy from ``seed``."""
    rng = np.random.default_rng(seed)
    return [T(rng.normal(size=shape).astype(np.float32)).to(dtype) for shape in shapes]


@pytest.mark.parametrize("s", [1, 63, 64, 65, 77])
@pytest.mark.parametrize("g", [1, 3, 4])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_tiled_ref_matches_plain_and_pallas(s, g, dtype):
    b, hkv, dh = 2, 2, 64
    q, k, v = _inputs(10 * s + g, dtype, (b, hkv * g, s, dh), (b, hkv, s, dh),
                      (b, hkv, s, dh))
    exact = [t.float() for t in (q, k, v)]
    got = fref.flash_tiled_ref(q, k, v)
    assert got.dtype == dtype and got.shape == q.shape
    _attn_close(got.float(), fref.mha_ref(*exact), dtype)
    pallas = flash_attention_pallas(*(jnp.asarray(t.numpy()) for t in exact),
                                    tq=64, tk=64, interpret=True)
    _attn_close(got.float(), pallas, dtype)


@pytest.mark.parametrize("s", [1, 65, 129])
@pytest.mark.parametrize("dh", [16, 32, 112, 192, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_tiled_ref_at_every_head_dim(s, dh, dtype):
    """The kernel's arithmetic at each head dim it is built for besides 64
    and 128 (the bf16 kernel's column groups at 192 and 256 change which
    warp computes a column, not its arithmetic), against the plain version
    and the Pallas kernel, causal and not, GQA group 3."""
    b, hkv, g = 1, 2, 3
    q, k, v = _inputs(s + dh, dtype, (b, hkv * g, s, dh), (b, hkv, s, dh), (b, hkv, s, dh))
    exact = [t.float() for t in (q, k, v)]
    for causal in (True, False):
        got = fref.flash_tiled_ref(q, k, v, causal=causal)
        assert got.dtype == dtype and got.shape == q.shape
        _attn_close(got.float(), fref.mha_ref(*exact, causal=causal), dtype)
        pallas = flash_attention_pallas(*(jnp.asarray(t.numpy()) for t in exact),
                                        causal=causal, tq=64, tk=64, interpret=True)
        _attn_close(got.float(), pallas, dtype)


@pytest.mark.parametrize("s", [1, 63, 64, 65, 77, 512])
@pytest.mark.parametrize("g", [1, 3, 4])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_tiled_ref_matches_plain(s, g, causal):
    """Both instances' arithmetic at head dim 128 (where scaling the logits
    after the product differs from scaling q by one f32 rounding)."""
    b, hkv, dh = 1, 2, 128
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v = _inputs(s + g, dtype, (b, hkv * g, s, dh), (b, hkv, s, dh),
                          (b, hkv, s, dh))
        got = fref.flash_tiled_ref(q, k, v, causal=causal)
        _attn_close(got.float(), fref.mha_ref(q.float(), k.float(), v.float(),
                                              causal=causal), dtype)


def test_flash_bf16_keeps_p_at_f32_precision():
    """Why the kernel splits p into bf16 hi + lo: at the serving engine's
    prefill shape, rounding p once to bf16 before P V breaks the bf16
    tolerance, the split holds it."""
    b, h, hkv, s, dh = 8, 12, 4, 77, 64
    q, k, v = _inputs(5, torch.bfloat16, (b, h, s, dh), (b, hkv, s, dh), (b, hkv, s, dh))
    want = fref.mha_ref(q.float(), k.float(), v.float())
    _attn_close(fref.flash_tiled_ref(q, k, v).float(), want, torch.bfloat16)
    qf, kf, vf = q.float(), k.float().repeat_interleave(3, 1), v.float().repeat_interleave(3, 1)
    logits = (qf @ kf.transpose(-1, -2) * dh ** -0.5).masked_fill(
        ~torch.ones(s, s, dtype=torch.bool).tril(), -1e30)
    p = torch.exp(logits - logits.amax(-1, keepdim=True))
    once = (p.to(torch.bfloat16).float() @ vf / p.sum(-1, keepdim=True)).to(torch.bfloat16)
    with pytest.raises(AssertionError):
        _attn_close(once.float(), want, torch.bfloat16)


def _edge_pos(s, chunk, b):
    """Valid lengths at the chunk edges 1, C-1, C, C+1 and S, cut to [1, S],
    in one batch (so whole chunks are empty for one row and live for
    another), cycled to ``b`` rows."""
    edges = [min(max(p, 1), s) for p in (1, chunk - 1, chunk, chunk + 1, s)]
    return torch.tensor([edges[i % len(edges)] for i in range(b)], dtype=torch.int32)


DECODE_REFS = {"chunked": lambda q, k, v, pos, chunk: dref.decode_chunked_ref(
                   q, k, v, pos, chunk=chunk),
               "tiled": lambda q, k, v, pos, chunk: dref.decode_tiled_ref(q, k, v, pos)}
# each instance's arithmetic in its dtype, the chunked one in both
DECODE_CASES = [("chunked", torch.float32), ("chunked", torch.bfloat16),
                ("tiled", torch.bfloat16)]


@pytest.mark.parametrize("s", [1, 63, 64, 65, 77])
@pytest.mark.parametrize("g", [1, 3, 4])
@pytest.mark.parametrize("ref,dtype", DECODE_CASES)
def test_decode_refs_match_plain_and_pallas(s, g, ref, dtype):
    b, hkv, dh, chunk = 5, 2, 64, dkernel.CHUNK
    q, k, v = _inputs(10 * s + g, dtype, (b, hkv * g, dh), (b, hkv, s, dh), (b, hkv, s, dh))
    pos = _edge_pos(s, chunk, b)
    exact = [t.float() for t in (q, k, v)]
    got = DECODE_REFS[ref](q, k, v, pos, chunk)
    assert got.dtype == dtype and got.shape == q.shape
    _attn_close(got.float(), dref.decode_attention_ref(*exact, pos), dtype)
    pallas = decode_attention_pallas(*(jnp.asarray(t.numpy()) for t in exact),
                                     jnp.asarray(pos.numpy()), tk=chunk, interpret=True)
    _attn_close(got.float(), pallas, dtype)


@pytest.mark.parametrize("dh", [16, 32, 112, 192, 256])
@pytest.mark.parametrize("ref,dtype", DECODE_CASES)
def test_decode_refs_at_every_head_dim(dh, ref, dtype):
    """Each decode instance's arithmetic at each head dim it is built for
    besides 64 and 128 (the f32 partials hold Dh + 2 floats per row),
    pos at the chunk edges, against the plain version and the Pallas
    kernel."""
    b, hkv, g, s, chunk = 5, 2, 3, 100, dkernel.CHUNK
    q, k, v = _inputs(dh, dtype, (b, hkv * g, dh), (b, hkv, s, dh), (b, hkv, s, dh))
    pos = _edge_pos(s, chunk, b)
    exact = [t.float() for t in (q, k, v)]
    got = DECODE_REFS[ref](q, k, v, pos, chunk)
    assert got.dtype == dtype and got.shape == q.shape
    _attn_close(got.float(), dref.decode_attention_ref(*exact, pos), dtype)
    pallas = decode_attention_pallas(*(jnp.asarray(t.numpy()) for t in exact),
                                     jnp.asarray(pos.numpy()), tk=chunk, interpret=True)
    _attn_close(got.float(), pallas, dtype)


@pytest.mark.parametrize("chunk", [16, 32, 64])
@pytest.mark.parametrize("g", [1, 3, 4])
@pytest.mark.parametrize("ref,dtype", DECODE_CASES)
def test_decode_refs_match_plain_at_512(chunk, g, ref, dtype):
    b, hkv, s, dh = 7, 2, 512, 128
    q, k, v = _inputs(chunk + g, dtype, (b, hkv * g, dh), (b, hkv, s, dh), (b, hkv, s, dh))
    pos = _edge_pos(s, chunk, b)
    pos[5:] = torch.tensor([77, 511], dtype=torch.int32)
    got = DECODE_REFS[ref](q, k, v, pos, chunk)
    _attn_close(got.float(), dref.decode_attention_ref(q.float(), k.float(), v.float(), pos),
                dtype)


@pytest.mark.parametrize("s", [1, 64, 65, 129])
def test_decode_tiled_ref_is_the_prefill_row(s):
    """The bf16 decode instance runs the prefill kernel's tile steps on the
    newest token's row: the same arithmetic as ``flash_tiled_ref``'s last
    row (on the card the two kernels agree bit for bit; on the CPU torch's
    products round by shape, so this holds them to a few f32 ulps before
    the bf16 output rounding)."""
    b, hkv, g, dh = 2, 2, 3, 64
    q, k, v = _inputs(s, torch.bfloat16, (b, hkv * g, s, dh), (b, hkv, s, dh),
                      (b, hkv, s, dh))
    last = fref.flash_tiled_ref(q, k, v)[:, :, -1]
    pad = torch.full((b, hkv, 7, dh), float("nan"), dtype=torch.bfloat16)
    got = dref.decode_tiled_ref(q[:, :, -1], torch.cat([k, pad], 2), torch.cat([v, pad], 2),
                                torch.full((b,), s, dtype=torch.int32))
    np.testing.assert_allclose(got.float().numpy(), last.float().numpy(), rtol=2 ** -7,
                               atol=1e-6)


@pytest.mark.parametrize("ref,dtype", DECODE_CASES)
def test_decode_refs_ignore_slots_past_pos(ref, dtype):
    """Slots at or past pos, empty chunks and a row with pos 0 contribute
    nothing: the output is bit-identical with 999 keys and NaN values there,
    and the pos-0 row is zeros."""
    b, hkv, g, s, dh = 4, 2, 3, 100, 64
    q, k, v = _inputs(9, dtype, (b, hkv * g, dh), (b, hkv, s, dh), (b, hkv, s, dh))
    pos = torch.tensor([0, 1, 33, 100], dtype=torch.int32)
    got = DECODE_REFS[ref](q, k, v, pos, 32)
    k2, v2 = k.clone(), v.clone()
    for i, p in enumerate(pos.tolist()):
        k2[i, :, p:], v2[i, :, p:] = 999.0, float("nan")
    assert torch.equal(DECODE_REFS[ref](q, k2, v2, pos, 32), got)
    assert not got[0].any() and torch.isfinite(got).all()


def test_head_dims_agree_with_the_sources():
    """The wrappers' head dims, the build's units and the HEAD_DIMS lists of
    the three CUDA sources (forward, backward, decode) are one set; any other dim is refused before a launch
    (on a CPU tensor the device check speaks first, so a CUDA-looking
    refusal is checked through the list)."""
    import re

    assert fkernel.HEAD_DIMS == dkernel.HEAD_DIMS == build.ATTN_HEAD_DIMS \
        == (16, 32, 64, 112, 128, 192, 256)
    for name in ("flash_attn", "flash_attn_bwd", "decode_attn"):
        text = build.SOURCES[name][0].read_text()
        listed = re.search(r"#define HEAD_DIMS\(X\) (.*)", text).group(1)
        assert tuple(int(d) for d in re.findall(r"X\((\d+)\)", listed)) == build.ATTN_HEAD_DIMS
        assert [f for _, f in build.units(name)] == [()] + [
            (f"-DHEAD_DIM={dh}",) for dh in build.ATTN_HEAD_DIMS]
    assert 96 not in fkernel.HEAD_DIMS and 320 not in dkernel.HEAD_DIMS


def test_library_name_follows_the_shared_headers(monkeypatch, tmp_path):
    """An edited header the kernels include gives every library a new name,
    so it is rebuilt."""
    assert [p.name for p in build.HEADERS] == ["attn_tile.cuh", "hopper_ptx.cuh"]
    header = tmp_path / "shared.cuh"
    header.write_text("// one\n")
    monkeypatch.setattr(build, "HEADERS", (header,))
    before = {name: build.library_path(name) for name in build.SOURCES}
    header.write_text("// two\n")
    after = {name: build.library_path(name) for name in build.SOURCES}
    assert all(before[n] != after[n] for n in build.SOURCES)


# the backward: every head dim the kernels are built for, GQA, odd S
BWD_SHAPES = [(2, 4, 2, 77, 64), (1, 8, 1, 33, 32), (1, 4, 2, 65, 16), (1, 8, 2, 41, 112),
              (1, 4, 4, 63, 128), (1, 6, 2, 35, 192), (1, 4, 1, 29, 256)]


def _jax_grads(q, k, v, do, causal, dtype):
    import jax

    jdt = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}[dtype]
    args = [jnp.asarray(a, jdt) for a in (q, k, v)]
    _, vjp = jax.vjp(lambda a, b, c: jmha_ref(a, b, c, causal=causal), *args)
    return [np.asarray(g, np.float32) for g in vjp(jnp.asarray(do, jdt))]


@pytest.mark.parametrize("b,h,hkv,s,dh", BWD_SHAPES)
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mha_bwd_ref_matches_jax_grad(b, h, hkv, s, dh, causal, dtype):
    """``mha_bwd_ref`` against ``jax.vjp`` of the JAX ``mha_ref`` (what the
    JAX package's training differentiates): float32 1e-5; bfloat16 5e-2
    (the frameworks round bf16 at other places), dtypes kept."""
    rng = np.random.default_rng(b * 100 + s + dh)
    q, do = (rng.normal(size=(b, h, s, dh)).astype(np.float32) for _ in range(2))
    k, v = (rng.normal(size=(b, hkv, s, dh)).astype(np.float32) for _ in range(2))
    got = fref.mha_bwd_ref(*(T(a).to(dtype) for a in (q, k, v, do)), causal=causal)
    want = _jax_grads(q, k, v, do, causal, dtype)
    tol = 1e-5 if dtype == torch.float32 else 5e-2
    for name, g, w, x in zip(("dq", "dk", "dv"), got, want, (q, k, v)):
        assert g.dtype == dtype and g.shape == x.shape, name
        np.testing.assert_allclose(g.float().numpy(), w, rtol=tol, atol=tol, err_msg=name)


@pytest.mark.parametrize("b,h,hkv,s,dh", BWD_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_bwd_tiled_ref_matches_plain(b, h, hkv, s, dh, dtype):
    """The backward kernel's arithmetic (``flash_bwd_tiled_ref``: tiled
    logsumexp, D from the forward's rounded output) against
    ``mha_bwd_ref`` on the inputs' exact float32 values, at the card's
    tolerance (``BWD_TOL`` of tests/test_torch_cuda.py): float32 1e-3;
    bfloat16 rtol 1e-2, atol 2e-2."""
    rng = np.random.default_rng(b * 10 + s + dh)
    q, do = (T(rng.normal(size=(b, h, s, dh)).astype(np.float32)).to(dtype) for _ in range(2))
    k, v = (T(rng.normal(size=(b, hkv, s, dh)).astype(np.float32)).to(dtype) for _ in range(2))
    o = fref.mha_ref(q, k, v)
    got = fref.flash_bwd_tiled_ref(q, k, v, o, do)
    want = fref.mha_bwd_ref(q.float(), k.float(), v.float(), do.float())
    rtol, atol = (1e-3, 1e-3) if dtype == torch.float32 else (1e-2, 2e-2)
    for g, w in zip(got, want):
        assert g.dtype == dtype
        np.testing.assert_allclose(g.float().numpy(), w.numpy(), rtol=rtol, atol=atol)


def test_flash_attention_autograd_on_cpu_is_the_plain_backward():
    """CPU tensors differentiate ``mha_ref`` under autograd: their gradient
    is ``mha_bwd_ref``'s, and no kernel is counted."""
    rng = np.random.default_rng(3)
    q, do = (T(rng.normal(size=(2, 6, 37, 32)).astype(np.float32)) for _ in range(2))
    k, v = (T(rng.normal(size=(2, 2, 37, 32)).astype(np.float32)) for _ in range(2))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    reset_launch_counts()
    flash_attention(*leaves).backward(do)
    assert launch_counts()["flash_attn"] == launch_counts()["flash_attn_bwd"] == 0
    for leaf, want in zip(leaves, fref.mha_bwd_ref(q, k, v, do)):
        np.testing.assert_allclose(leaf.grad.numpy(), want.numpy(), rtol=1e-5, atol=1e-5)
