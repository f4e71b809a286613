"""The port's CUDA kernels on the card, against their plain PyTorch versions
and the numpy oracle.  Every test here needs an NVIDIA GPU (marker
``cuda``) and skips without one; the file imports neither JAX nor the JAX
package, so it runs where only PyTorch is installed:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Sums use atomics, whose order changes from run to run: rtol 1e-4.
"""
import numpy as np
import pytest
import torch

from repro_torch.core.sql_canon import SQLCanonicalizer
from repro_torch.kernels.seg_agg import kernel as tkernel
from repro_torch.kernels.seg_agg import ref as tref
from repro_torch.olap.executor import OlapExecutor
from repro_torch.workloads import ssb

T = torch.from_numpy

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda", torch.cuda.current_device())


def _close(got, want, tol=1e-4):
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               rtol=tol, atol=tol)


def _rand_bounds(rng, p, k):
    """(P, K, 2) inclusive ranges over 0..9 with never-match pads."""
    b = np.empty((p, k, 2), np.float32)
    b[..., 0], b[..., 1] = np.inf, -np.inf
    for i in range(p):
        for j in range(rng.integers(1, k + 1)):
            a = rng.integers(0, 10, size=2)
            b[i, j] = (min(a), max(a))
    return b


@pytest.mark.parametrize("n,m,g,p,k,s", [
    (5000, 1, 1, 0, 1, 1), (20000, 3, 25, 2, 2, 6), (7777, 2, 2500, 3, 4, 6),
    (50000, 2, 200000, 1, 1, 2), (3000, 5, 250, 1, 2, 70)])
@pytest.mark.parametrize("op", ["sum", "min", "max"])
def test_kernels_match_plain(cuda_device, n, m, g, p, k, s, op):
    """Shared-memory tiles, grid.y tiles and the global-atomic path, NaN
    values and predicates, NaN-sentinel and pad ranges, an empty mask, and
    more signatures than one launch takes."""
    rng = np.random.default_rng(n + g)
    vals = rng.normal(size=(n, m)).astype(np.float32)
    vals[rng.random((n, m)) < 0.01] = np.nan
    ids = rng.integers(0, g, size=n).astype(np.int32)
    pred = rng.integers(0, 10, size=(n, p)).astype(np.float32)
    pred[rng.random((n, p)) < 0.01] = np.nan
    bounds = np.stack([_rand_bounds(rng, p, k) for _ in range(s)])
    if p:
        bounds[0, 0, -1] = (np.nan, np.nan)  # NaN sentinel
    mask = (rng.random(n) > 0.3).astype(np.float32)
    dev = cuda_device
    v, i, pr, b, mk = (T(a).to(dev) for a in (vals, ids, pred, bounds, mask))
    tkernel.reset_kernel_launches()
    _close(tkernel.seg_agg_fused_cuda(v, i, pr, b, g, op),
           tref.seg_agg_batch_ref(v, i, pr, b, g, op))
    assert tkernel.kernel_launches()["seg_agg_fused"] == -(-s // tkernel.MAX_SIGNATURES)
    for select, plain in ((True, tref.seg_agg_masked_ref), (False, tref.seg_agg_ref)):
        _close(tkernel.seg_agg_cuda(v, i, mk, g, op, select=select),
               plain(v, i, mk, g, op))
    empty = torch.zeros_like(mk)
    _close(tkernel.seg_agg_cuda(v, i, empty, g, op),
           tref.seg_agg_masked_ref(v, i, empty, g, op))
    torch.cuda.synchronize()


def test_wrappers_check_their_inputs(cuda_device):
    v = torch.zeros((8, 2), device=cuda_device)
    ids = torch.zeros(8, dtype=torch.int32, device=cuda_device)
    with pytest.raises(TypeError):
        tkernel.seg_agg_cuda(v, ids.long(), torch.ones(8, device=cuda_device), 2)
    with pytest.raises(ValueError):
        tkernel.seg_agg_cuda(v.t(), ids, torch.ones(2, device=cuda_device), 2)
    with pytest.raises(ValueError):
        tkernel.seg_agg_fused_cuda(v, ids, torch.zeros((8, 1), device=cuda_device),
                                   torch.zeros((1, 2, 1, 2), device=cuda_device), 2)


def test_executor_on_cuda_matches_oracle(cuda_device):
    """Every SSB intent, single and as one batch, on the card."""
    wl = ssb.build(n_fact=50_000, seed=3)
    canon = SQLCanonicalizer(wl.schema)
    ex = OlapExecutor(wl.dataset, device=cuda_device)
    oracle = OlapExecutor(wl.dataset, impl="numpy")
    sigs = [canon.canonicalize(i.sql) for i in wl.intents]
    tkernel.reset_kernel_launches()
    for sig, batched in zip(sigs, ex.execute_batch(sigs)):
        want = oracle.execute(sig)
        assert ex.execute(sig).equals(want, ordered=bool(sig.order_by))
        assert batched.equals(want, ordered=bool(sig.order_by))
    assert tkernel.kernel_launches()["seg_agg_fused"] > 0
