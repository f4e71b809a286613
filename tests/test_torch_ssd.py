"""The port's SSD scan on the CPU against the JAX package's: the plain
versions (``ssd_ref``, ``ssd_chunked``, ``ssd_final_state``,
``ssd_decode_step``) against the jnp ones, and ``ops.ssd_scan`` (which takes
the plain versions for CPU tensors) against the Pallas kernel in interpret
mode, at ``tests/test_kernels.py::test_ssd_scan``'s three shapes and at a
ragged S.

Tolerances: the same arithmetic in float32 agrees to 1e-5 (the sequential
scan at S = 300 to 1e-4, its rounding compounding step by step); chunked
against sequential, and anything against the Pallas kernel, 5e-3, the
tolerance of ``tests/test_kernels.py``.  bfloat16 x: the port and JAX both
compute in float32 and round y once, so they agree to one bfloat16
rounding (2**-8 relative).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssd_scan.kernel import ssd_scan_pallas
from repro.kernels.ssd_scan.ref import (ssd_chunked_xla, ssd_decode_step as jdecode,
                                        ssd_final_state as jfinal, ssd_ref as jssd_ref)
from repro_torch.kernels.binding import launch_counts, reset_launch_counts
from repro_torch.kernels.ssd_scan import kernel as skernel
from repro_torch.kernels.ssd_scan import ref
from repro_torch.kernels.ssd_scan.ops import ssd_scan

T = torch.from_numpy
SHAPES = [(2, 256, 4, 64, 32, 64), (1, 100, 2, 32, 16, 32), (1, 512, 3, 16, 64, 128),
          (2, 77, 3, 16, 16, 128)]  # the last: S ragged, a single chunk of 77


def _inputs(b, s, h, p, n, seed, dt_hi=0.1):
    """test_kernels.py's distributions; ``dt_hi`` 2.0 gives dt as large as
    mamba2's init gives (softplus of the projection around -2)."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, s, h, p)).astype(np.float32)
    dt = (0.001 + rng.random((b, s, h)) * dt_hi).astype(np.float32)
    A = (-rng.random(h) * 2 - 0.1).astype(np.float32)
    Bm = rng.normal(size=(b, s, n)).astype(np.float32)
    Cm = rng.normal(size=(b, s, n)).astype(np.float32)
    return x, dt, A, Bm, Cm


@pytest.mark.parametrize("b,s,h,p,n,chunk", SHAPES)
def test_plain_versions_match_jax(b, s, h, p, n, chunk):
    arrs = _inputs(b, s, h, p, n, seed=s + n)
    j = [jnp.asarray(a) for a in arrs]
    t = [T(a) for a in arrs]
    jy, jstate = jssd_ref(*j)
    y, state = ref.ssd_ref(*t)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(state.numpy(), np.asarray(jstate), rtol=1e-4, atol=1e-4)
    chunked = ref.ssd_chunked(*t, chunk=chunk).numpy()
    np.testing.assert_allclose(chunked, np.asarray(ssd_chunked_xla(*j, chunk=chunk)),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(chunked, y.numpy(), rtol=5e-3, atol=5e-3)
    final = ref.ssd_final_state(*t).numpy()
    np.testing.assert_allclose(final, np.asarray(jfinal(*j[:4])), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(final, state.numpy(), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("b,s,h,p,n,chunk", SHAPES)
def test_ssd_scan_matches_pallas_interpret(b, s, h, p, n, chunk):
    arrs = _inputs(b, s, h, p, n, seed=7 * s + h)
    j = [jnp.asarray(a) for a in arrs]
    reset_launch_counts()
    y, state = ssd_scan(*(T(a) for a in arrs), chunk=chunk, return_state=True)
    assert launch_counts()["ssd_scan"] == 0  # CPU tensors take the plain version
    pallas = np.asarray(ssd_scan_pallas(*j, chunk=chunk, interpret=True))
    np.testing.assert_allclose(y.numpy(), pallas, rtol=5e-3, atol=5e-3)
    _, jstate = jssd_ref(*j)
    np.testing.assert_allclose(state.numpy(), np.asarray(jstate), rtol=1e-4, atol=1e-4)
    assert state.dtype == torch.float32 and state.shape == (b, h, p, n)


def test_large_dt_stays_finite_and_matches_jax():
    """dt up to 2 with A down to -2.1: the cumsum of A dt falls to about -300
    inside a 128-step chunk, where exp(cum_t) * exp(-cum_s) would overflow.
    Both frameworks exponentiate differences only."""
    arrs = _inputs(1, 300, 2, 16, 16, seed=3, dt_hi=2.0)
    j = [jnp.asarray(a) for a in arrs]
    y, state = ssd_scan(*(T(a) for a in arrs), return_state=True)
    assert torch.isfinite(y).all() and torch.isfinite(state).all()
    jy, jstate = jssd_ref(*j)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=5e-3, atol=5e-3)
    np.testing.assert_allclose(state.numpy(), np.asarray(jstate), rtol=1e-4, atol=1e-4)


def test_bf16_x_keeps_jax_casts():
    x, dt, A, Bm, Cm = _inputs(1, 100, 2, 32, 16, seed=11)
    jx = jnp.asarray(x, jnp.bfloat16)
    tx = T(x).to(torch.bfloat16)
    rest_j = [jnp.asarray(a) for a in (dt, A, Bm, Cm)]
    rest_t = [T(a) for a in (dt, A, Bm, Cm)]
    got = ssd_scan(tx, *rest_t)
    assert got.dtype == torch.bfloat16
    want = np.asarray(ssd_chunked_xla(jx, *rest_j)).astype(np.float32)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=2 ** -8, atol=1e-5)
    y, _ = ref.ssd_ref(tx, *rest_t)
    jy, _ = jssd_ref(jx, *rest_j)
    assert y.dtype == torch.bfloat16
    np.testing.assert_allclose(y.float().numpy(), np.asarray(jy).astype(np.float32),
                               rtol=2 ** -8, atol=1e-4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_step_matches_jax(dtype):
    rng = np.random.default_rng(5)
    b, h, p, n = 3, 4, 16, 32
    state = rng.normal(size=(b, h, p, n)).astype(np.float32)
    xt = rng.normal(size=(b, h, p)).astype(np.float32)
    dtt = (0.01 + rng.random((b, h))).astype(np.float32)
    A = (-rng.random(h) * 8).astype(np.float32)
    bt, ct = (rng.normal(size=(b, n)).astype(np.float32) for _ in range(2))
    jd, td = (jnp.bfloat16, torch.bfloat16) if dtype == "bfloat16" else (jnp.float32,
                                                                      torch.float32)
    jy, jst = jdecode(jnp.asarray(state), jnp.asarray(xt, jd),
                      *(jnp.asarray(a) for a in (dtt, A, bt, ct)))
    y, st = ref.ssd_decode_step(T(state), T(xt).to(td), *(T(a) for a in (dtt, A, bt, ct)))
    assert y.dtype == td and st.dtype == torch.float32
    tol = 1e-5 if dtype == "float32" else 2 ** -8
    np.testing.assert_allclose(y.float().numpy(), np.asarray(jy).astype(np.float32),
                               rtol=tol, atol=1e-5)
    np.testing.assert_allclose(st.numpy(), np.asarray(jst), rtol=1e-5, atol=1e-5)


def test_chunk_padding_leaves_the_state_alone():
    """A ragged S is padded with dt = 0, which leaves the state unchanged:
    every chunk length gives the same y and final state."""
    arrs = [T(a) for a in _inputs(2, 70, 3, 16, 16, seed=2)]
    want, state = ref.ssd_ref(*arrs)
    for chunk in (1, 16, 32, 64, 128):
        np.testing.assert_allclose(ref.ssd_chunked(*arrs, chunk=chunk).numpy(),
                                   want.numpy(), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(ref.ssd_final_state(*arrs).numpy(), state.numpy(),
                               rtol=1e-4, atol=1e-4)


def test_kernel_wrapper_refuses_cpu_tensors():
    """The CUDA wrapper launches or raises: a CPU tensor is refused, never
    computed by a fallback."""
    x, dt, A, Bm, Cm = (T(a) for a in _inputs(1, 8, 2, 16, 16, seed=0))
    with pytest.raises(ValueError, match="CUDA tensors"):
        skernel.ssd_scan_cuda(x, dt, A, Bm, Cm)
    with pytest.raises(ValueError, match="tensors on"):
        ssd_scan(x, dt.to("meta"), A, Bm, Cm)
