"""Parity of the port's seg_agg ops (plain PyTorch path, CPU tensors) with
the JAX package's jnp oracle and, at N <= 2048, its Pallas kernels in
interpret mode.  The CUDA kernels are held against these plain versions on
the card by ``test_torch_cuda.py``.

Tolerances are those of ``tests/test_kernels.py``: 1e-5 for single-block
reduces, 1e-4 for batched sums.  The port's plain ``seg_agg`` is compared
with ``seg_agg_ref`` only when rows carry NaN: the Pallas kernel's one-hot
matmul spreads a NaN over its whole group tile, the port keeps it in its
own group, as the oracle does.
"""
import numpy as np
import pytest
import torch

from repro.kernels.seg_agg import ops as jops
from repro.kernels.seg_agg.kernel import seg_agg_fused_pallas, seg_agg_pallas
from repro.kernels.seg_agg.ref import (bounds_mask_ref, seg_agg_fused_ref,
                                       seg_agg_ref)
from repro_torch.kernels.seg_agg import kernel as tkernel
from repro_torch.kernels.seg_agg import ops as tops
from repro_torch.kernels.seg_agg import ref as tref

T = torch.from_numpy


def _rand_bounds(rng, p, k, lo=0, hi=10):
    """Random (P, K, 2) inclusive range bounds with some never-match pads."""
    b = np.empty((p, k, 2), np.float32)
    b[..., 0], b[..., 1] = np.inf, -np.inf
    for i in range(p):
        for j in range(rng.integers(1, k + 1)):
            a = rng.integers(lo, hi, size=2)
            b[i, j] = (min(a), max(a))
    return b


def _close(out, ref, tol=1e-5):
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref), rtol=tol, atol=tol)


@pytest.mark.parametrize("n,m,g", [(512, 1, 16), (1000, 3, 17), (4096, 2, 512),
                                   (777, 4, 1000), (64, 1, 5)])
@pytest.mark.parametrize("op", ["sum", "min", "max"])
def test_seg_agg(n, m, g, op):
    rng = np.random.default_rng(n * 7 + g)
    vals = rng.normal(size=(n, m)).astype(np.float32)
    ids = rng.integers(0, g, size=n).astype(np.int32)
    mask = (rng.random(n) > 0.3).astype(np.float32)
    out = tops.seg_agg(T(vals), T(ids), T(mask), g, op)
    assert out.shape == (g, m) and out.dtype == torch.float32
    _close(out, seg_agg_ref(vals, ids, mask, g, op))
    if n <= 2048:
        _close(out, seg_agg_pallas(vals, ids, mask, g, op, interpret=True))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
def test_seg_agg_dtypes(dtype):
    """Narrow value dtypes are reduced in float32, as the JAX kernel does."""
    rng = np.random.default_rng(4)
    vals = rng.normal(size=(256, 2)).astype(np.float16).astype(np.float32)
    ids = rng.integers(0, 31, size=256).astype(np.int32)
    mask = np.ones(256, np.float32)
    narrow = T(vals).to(dtype)
    out = tops.seg_agg(narrow, T(ids), T(mask), 31, "sum")
    assert out.dtype == torch.float32
    same = narrow.to(torch.float32).numpy()  # the values the kernel saw
    _close(out, seg_agg_ref(same, ids, mask, 31, "sum"), 1e-2)


@pytest.mark.parametrize("op", ["sum", "min", "max"])
def test_seg_agg_nan_rows_match_oracle(op):
    """Multiply contract: a NaN in a masked-out row still poisons its group
    under SUM (0 * NaN), and stays inside that one group."""
    rng = np.random.default_rng(3)
    n, m, g = 600, 2, 9
    vals = rng.normal(size=(n, m)).astype(np.float32)
    vals[rng.random((n, m)) < 0.02] = np.nan
    ids = rng.integers(0, g, size=n).astype(np.int32)
    mask = (rng.random(n) > 0.5).astype(np.float32)
    out = tops.seg_agg(T(vals), T(ids), T(mask), g, op)
    _close(out, seg_agg_ref(vals, ids, mask, g, op))


@pytest.mark.parametrize("op", ["sum", "min", "max"])
def test_seg_agg_masked(op):
    """Select contract with NaN rows, against the JAX dispatcher on both its
    jnp and its Pallas (interpret) paths."""
    rng = np.random.default_rng(5)
    n, m, g = 1000, 3, 13
    vals = rng.normal(size=(n, m)).astype(np.float32)
    vals[rng.random((n, m)) < 0.02] = np.nan
    ids = rng.integers(0, g, size=n).astype(np.int32)
    mask = rng.random(n) > 0.4
    out = tops.seg_agg_masked(T(vals), T(ids), T(mask.astype(np.float32)), g, op)
    for impl in ("xla", "interpret"):
        _close(out, jops.seg_agg_masked(vals, ids, mask, g, op, impl=impl))


@pytest.mark.parametrize("n,m,g,p,k", [(512, 1, 16, 1, 1), (1000, 3, 17, 2, 2),
                                       (777, 2, 100, 3, 2), (64, 4, 5, 1, 4)])
@pytest.mark.parametrize("op", ["sum", "min", "max"])
def test_seg_agg_fused(n, m, g, p, k, op):
    """Filter-fused entry (mask from bounds) vs the fused oracle and the
    Pallas fused kernel, including NaN-bearing values."""
    rng = np.random.default_rng(n + 13 * p + k)
    vals = rng.normal(size=(n, m)).astype(np.float32)
    vals[rng.random((n, m)) < 0.02] = np.nan
    ids = rng.integers(0, g, size=n).astype(np.int32)
    pred = rng.integers(0, 10, size=(n, p)).astype(np.float32)
    bounds = _rand_bounds(rng, p, k)
    out = tops.seg_agg_fused(T(vals), T(ids), T(pred), T(bounds), g, op)
    assert out.shape == (g, m)
    _close(out, seg_agg_fused_ref(vals, ids, pred, bounds, g, op))
    flat = np.concatenate([bounds[:, :, 0], bounds[:, :, 1]], axis=1)
    _close(out, seg_agg_fused_pallas(vals, ids, pred, flat, g, op, interpret=True))


@pytest.mark.parametrize("op", ["sum", "min"])
def test_seg_agg_fused_no_predicates(op):
    """P == 0: every row qualifies."""
    rng = np.random.default_rng(8)
    vals = rng.normal(size=(300, 2)).astype(np.float32)
    ids = rng.integers(0, 6, size=300).astype(np.int32)
    pred = np.zeros((300, 0), np.float32)
    bounds = np.zeros((0, 1, 2), np.float32)
    out = tops.seg_agg_fused(T(vals), T(ids), T(pred), T(bounds), 6, op)
    _close(out, jops.seg_agg_fused(vals, ids, pred, bounds, 6, op, impl="xla"))


def test_bounds_mask_sentinel_and_pad():
    """NaN sentinel matches exactly the NaN values, the pad range matches
    nothing, ordinary ranges reject NaN — same mask as the JAX oracle."""
    rng = np.random.default_rng(11)
    n, p = 2000, 3
    pred = rng.integers(-5, 15, size=(n, p)).astype(np.float32)
    pred[rng.random((n, p)) < 0.05] = np.nan
    bounds = _rand_bounds(rng, p, 4, lo=-5, hi=15)
    bounds[1, 3] = (np.nan, np.nan)
    got = tref.bounds_mask_ref(T(pred), T(bounds)).numpy()
    np.testing.assert_array_equal(got, np.asarray(bounds_mask_ref(pred, bounds)))
    assert got.any() and not got.all()


def test_seg_agg_fused_empty_mask():
    """All-never bounds: sums are zero, mins stay at the identity."""
    rng = np.random.default_rng(12)
    vals = T(rng.normal(size=(128, 2)).astype(np.float32))
    ids = T(rng.integers(0, 7, size=128).astype(np.int32))
    pred = torch.zeros((128, 1))
    bounds = torch.tensor([[[np.inf, -np.inf]]], dtype=torch.float32)
    np.testing.assert_array_equal(
        tops.seg_agg_fused(vals, ids, pred, bounds, 7, "sum").numpy(),
        np.zeros((7, 2), np.float32))
    np.testing.assert_array_equal(
        tops.seg_agg_fused(vals, ids, pred, bounds, 7, "min").numpy(),
        np.full((7, 2), np.inf, np.float32))


@pytest.mark.parametrize("impl", ["xla", "interpret"])
def test_seg_agg_batch_blocks(impl):
    """The shared-scan group entry against the JAX batch dispatcher; the
    MIN/MAX block carries NaNs (confinement contract)."""
    rng = np.random.default_rng(21)
    n, g, s = 1000, 8, 5
    sum_vals = rng.normal(size=(n, 3)).astype(np.float32)
    mm_vals = rng.normal(size=(n, 2)).astype(np.float32)
    mm_vals[rng.integers(0, n, size=4), 0] = np.nan
    ids = rng.integers(0, g, size=n).astype(np.int32)
    pred = rng.integers(0, 10, size=(n, 2)).astype(np.float32)
    bounds = np.stack([_rand_bounds(rng, 2, 2) for _ in range(s)])
    sums, mm = tops.seg_agg_batch_blocks(T(sum_vals), T(mm_vals), T(ids),
                                         T(pred), T(bounds), g)
    assert sums.shape == (s, g, 3) and mm.shape == (s, g, 2)
    ref_sums, ref_mm = jops.seg_agg_batch_blocks(sum_vals, mm_vals, ids, pred,
                                                 bounds, g, impl=impl)
    _close(sums, ref_sums, 1e-4)
    _close(mm, ref_mm)
    sums_only, none_mm = tops.seg_agg_batch_blocks(T(sum_vals), None, T(ids),
                                                   T(pred), T(bounds), g)
    assert none_mm is None
    _close(sums_only, ref_sums, 1e-4)


@pytest.mark.parametrize("op", ["sum", "min", "max"])
def test_seg_agg_batch(op):
    rng = np.random.default_rng(31)
    n, m, g, s = 900, 2, 11, 6
    vals = rng.normal(size=(n, m)).astype(np.float32)
    ids = rng.integers(0, g, size=n).astype(np.int32)
    pred = rng.integers(0, 10, size=(n, 3)).astype(np.float32)
    bounds = np.stack([_rand_bounds(rng, 3, 2) for _ in range(s)])
    out = tops.seg_agg_batch(T(vals), T(ids), T(pred), T(bounds), g, op)
    _close(out, jops.seg_agg_batch(vals, ids, pred, bounds, g, op, impl="xla"),
           1e-4)


def test_launch_probe_counts_dispatches():
    rng = np.random.default_rng(1)
    vals = T(rng.normal(size=(50, 2)).astype(np.float32))
    ids = T(rng.integers(0, 4, size=50).astype(np.int32))
    pred = T(rng.integers(0, 10, size=(50, 1)).astype(np.float32))
    bounds = T(np.stack([_rand_bounds(rng, 1, 1) for _ in range(3)]))
    tops.reset_launch_count()
    tops.seg_agg_batch_blocks(vals, None, ids, pred, bounds, 4)
    assert tops.launch_count() == 1
    tops.seg_agg_batch_blocks(vals, vals, ids, pred, bounds, 4)
    assert tops.launch_count() == 3


def test_mixed_devices_and_non_tensors_rejected():
    vals = torch.zeros((4, 1))
    with pytest.raises(ValueError):
        tops.seg_agg(vals, torch.zeros(4, dtype=torch.int32),
                     torch.ones(4, device="meta"), 2)
    with pytest.raises(ValueError):
        tkernel.seg_agg_cuda(vals, torch.zeros(4, dtype=torch.int32),
                             torch.ones(4), 2)


def test_dispatcher_hands_kernel_b_16_byte_aligned_columns():
    """Kernel B stages its row columns with 16-byte copies: the dispatcher
    copies a column block whose data starts inside a 16-byte word, and
    passes an aligned one as it is."""
    base = torch.zeros(9, 2)
    view = base[1:]  # starts 8 bytes in
    assert view.data_ptr() % 16 and view.is_contiguous()
    fixed = tops._aligned(view)
    assert fixed.data_ptr() % 16 == 0 and torch.equal(fixed, view)
    assert tops._aligned(base) is base
