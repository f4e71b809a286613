"""Plain PyTorch versions of the Mamba2 SSD recurrence, with the arithmetic
of the JAX package's ``repro/kernels/ssd_scan/ref.py``.

State-space duality (arXiv:2405.21060): per head h with state (P, N),

    h_t = exp(A_h * dt_t) * h_{t-1} + dt_t * (x_t  outer  B_t)
    y_t = h_t @ C_t

x: (B, S, H, P); dt: (B, S, H) > 0; A: (H,) < 0; Bm, Cm: (B, S, N) (one
state group, as in Mamba2).  Everything is computed in float32 and y is
returned in x's dtype.  ``ops`` takes ``ssd_chunked`` (and
``ssd_final_state``) for tensors on the CPU; ``ssd_ref`` is the sequential
oracle the CUDA kernel is held to.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

f32 = torch.float32


def ssd_ref(x, dt, A, Bm, Cm, init_state=None):
    """The sequential scan.  Returns y (B, S, H, P) in x's dtype and the
    final state (B, H, P, N) in float32."""
    b, s, h, p = x.shape
    n = Bm.shape[-1]
    xf, dtf, Bf, Cf, Af = (t.to(f32) for t in (x, dt, Bm, Cm, A))
    state = (torch.zeros((b, h, p, n), dtype=f32, device=x.device)
             if init_state is None else init_state.to(f32))
    ys = []
    for t in range(s):
        decay = torch.exp(Af[None, :] * dtf[:, t])  # (B, H)
        upd = dtf[:, t, :, None, None] * xf[:, t, :, :, None] * Bf[:, t, None, None, :]
        state = state * decay[..., None, None] + upd  # (B, H, P, N)
        ys.append(torch.einsum("bhpn,bn->bhp", state, Cf[:, t]))
    y = torch.stack(ys, dim=1) if ys else xf.new_zeros((b, 0, h, p))
    return y.to(x.dtype), state


def ssd_chunked(x, dt, A, Bm, Cm, chunk: int = 128):
    """The chunked form of ``ssd_chunked_xla``: per chunk of L steps the
    (L, L) masked decay product ``((C Bᵀ) ∘ M) x``, the carried state's
    contribution, and an O(S / L) scan over chunk states.  S is padded to a
    multiple of ``min(chunk, S)`` with dt = 0, which leaves the state as it
    is.  Returns y (B, S, H, P) in x's dtype."""
    b, s, h, p = x.shape
    n = Bm.shape[-1]
    chunk = min(chunk, s)
    pad = (-s) % chunk
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        Bm = F.pad(Bm, (0, 0, 0, pad))
        Cm = F.pad(Cm, (0, 0, 0, pad))
    sp = x.shape[1]
    nc = sp // chunk
    xf = x.to(f32).reshape(b, nc, chunk, h, p)
    dtf = dt.to(f32).reshape(b, nc, chunk, h)
    Bf = Bm.to(f32).reshape(b, nc, chunk, n)
    Cf = Cm.to(f32).reshape(b, nc, chunk, n)
    Af = A.to(f32)

    cum = torch.cumsum(Af[None, None, None, :] * dtf, dim=2)  # (B, NC, L, H) inclusive
    total = cum[:, :, -1, :]  # (B, NC, H)

    # intra-chunk: exp(cum_t - cum_s) only where s <= t (the other half is 0)
    g = torch.einsum("bcln,bcsn->bcls", Cf, Bf)  # (B, NC, L, L)
    mask = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool, device=x.device))
    diff = cum[:, :, :, None, :] - cum[:, :, None, :, :]  # (B, NC, L, L, H)
    decay = torch.exp(diff.masked_fill(~mask[None, None, :, :, None], float("-inf")))
    m = decay * dtf[:, :, None, :, :] * g[..., None]  # (B, NC, L, L, H)
    y_intra = torch.einsum("bclsh,bcshp->bclhp", m, xf)

    # each chunk's own contribution to the state at its end
    w = Bf[:, :, :, None, :] * (dtf * torch.exp(total[:, :, None, :] - cum))[..., None]
    chunk_states = torch.einsum("bclhn,bclhp->bchpn", w, xf)  # (B, NC, H, P, N)

    # inter-chunk scan over NC: the state each chunk starts from
    state = torch.zeros((b, h, p, n), dtype=f32, device=x.device)
    prev = []
    for c in range(nc):
        prev.append(state)
        state = state * torch.exp(total[:, c])[..., None, None] + chunk_states[:, c]
    prev = torch.stack(prev, dim=1)  # (B, NC, H, P, N)

    y_inter = torch.einsum("bcln,bchpn->bclhp", Cf, prev) * torch.exp(cum)[..., None]
    y = (y_intra + y_inter).reshape(b, sp, h, p)[:, :s]
    return y.to(x.dtype)


def ssd_final_state(x, dt, A, Bm, Cm=None):
    """Final SSM state after the whole sequence (prefill seeds the decode
    cache with it): sum_t exp(cum_S - cum_t) * dt_t * (x_t outer B_t)."""
    xf, dtf = x.to(f32), dt.to(f32)
    cum = torch.cumsum(A.to(f32)[None, None, :] * dtf, dim=1)  # (B, S, H)
    w = dtf * torch.exp(cum[:, -1:, :] - cum)  # (B, S, H)
    return torch.einsum("bshp,bsn->bhpn", xf * w[..., None], Bm.to(f32))


def ssd_decode_step(state, xt, dtt, A, bt, ct):
    """One decode step: state (B, H, P, N) -> (y (B, H, P) in xt's dtype,
    the new state in float32)."""
    decay = torch.exp(A.to(f32)[None, :] * dtt.to(f32))
    upd = (dtt.to(f32)[..., None, None] * xt.to(f32)[..., None]
           * bt.to(f32)[:, None, None, :])
    state = state * decay[..., None, None] + upd
    y = torch.einsum("bhpn,bn->bhp", state, ct.to(f32))
    return y.to(xt.dtype), state
