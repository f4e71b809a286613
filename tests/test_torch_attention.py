"""The port's attention on the CPU against the JAX package's: the plain
versions (``ops`` takes them for CPU tensors) against the jnp oracles
(``mha_ref``, ``decode_attention_ref``) and the Pallas kernels in interpret
mode, over the shape sweeps of ``tests/test_kernels.py``.

Tolerances are those of ``tests/test_kernels.py``: float32 2e-3 (blockwise
online softmax against one softmax), bfloat16 5e-2.  Against the jnp
oracle, whose arithmetic the port repeats, float32 agrees to 1e-5.
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
from repro_torch.kernels.decode_attn import kernel as dkernel
from repro_torch.kernels.decode_attn.ops import decode_attention
from repro_torch.kernels.flash_attn import kernel as fkernel
from repro_torch.kernels.flash_attn.ops import flash_attention

T = torch.from_numpy


@pytest.mark.parametrize("b,h,hkv,s,dh", [
    (2, 4, 2, 256, 64), (1, 8, 1, 128, 32), (1, 4, 4, 100, 64), (2, 2, 2, 64, 128),
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
    with pytest.raises(ValueError, match="tensors on"):
        flash_attention(q, q.to("meta"), q)
